"""Vehicle parameter pytrees and dynamics models."""

from lap_time_optimization.models.vehicle import (  # noqa: F401
    PointMassVehicle,
    PacejkaVehicle,
    load_vehicle,
)
