"""Vehicle models as parameter pytrees with jittable force laws.

Two families, capability-matched to the reference:

* `PointMassVehicle` — tbr18-style point mass with a piecewise-linear engine
  map and a friction-circle traction law (reference src/vehicle.py:10-35).
* `PacejkaVehicle` — MX5-style car with Pacejka-parameterized tires, drag
  terms, and an elliptical max-force traction approximation
  (reference src/vehicleMX5.py:11-79).

Unlike the reference (scalar `math.sqrt` + branches), the force laws here are
vectorized, NaN-safe under autodiff (double-where guards on the saturated
branch), and usable inside jit/vmap/grad — which is what lets the lap-time
objective be differentiated instead of finite-differenced.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from lap_time_optimization.utils import io

GRAV = 9.81  # m s^-2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointMassVehicle:
    """Point-mass vehicle: engine map interpolation + friction circle."""

    mass: jax.Array
    friction_coef: jax.Array
    engine_v: jax.Array  # (k,) engine map velocities
    engine_f: jax.Array  # (k,) engine map forces
    name: str = dataclasses.field(metadata=dict(static=True), default="")

    def engine_force(self, v: jax.Array) -> jax.Array:
        """Linear interpolation over the engine map (src/vehicle.py:25-27)."""
        return jnp.interp(v, self.engine_v, self.engine_f)

    def traction(self, v: jax.Array, k: jax.Array) -> jax.Array:
        """Remaining longitudinal force on the friction circle:
        sqrt((μ m g)² − (m v² κ)²), clamped to 0 when saturated
        (src/vehicle.py:29-35).  NaN-safe for autodiff."""
        f = self.friction_coef * self.mass * GRAV
        f_lat = self.mass * v * v * k
        slack = f * f - f_lat * f_lat
        safe = jnp.maximum(slack, 1e-12)
        return jnp.where(slack > 0.0, jnp.sqrt(safe), 0.0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PacejkaVehicle:
    """Pacejka-parameterized car (MX5).  Holds the full parameter set used by
    both the quasi-static racing-line solver and the NMPC bicycle model."""

    mass: jax.Array
    rotational_inertia: jax.Array
    length_f: jax.Array
    length_r: jax.Array
    width: jax.Array
    B_f: jax.Array
    C_f: jax.Array
    D_f: jax.Array
    B_r: jax.Array
    C_r: jax.Array
    D_r: jax.Array
    Cr_0: jax.Array
    Cr_2: jax.Array
    ptv: jax.Array
    C_m: jax.Array
    T: jax.Array
    friction_coef: jax.Array  # control.lambda
    ro_long: jax.Array
    name: str = dataclasses.field(metadata=dict(static=True), default="")

    def engine_force(self, v: jax.Array) -> jax.Array:
        """Max longitudinal force T·C_m − Cr0 − Cr2·v² (src/vehicleMX5.py:19-21)."""
        return self.T * self.C_m - self.Cr_0 - self.Cr_2 * v * v

    def traction(self, v: jax.Array, k: jax.Array, lam: float = 2.0) -> jax.Array:
        """Elliptical traction approximation with F_max = λ·D̄·m·g
        (src/vehicleMX5.py:23-37; D̄ averages front/rear peak factors)."""
        D = 0.5 * (self.D_f + self.D_r)
        f_max = lam * D * self.mass * GRAV
        f_lat = self.mass * v * v * k
        slack = f_max * f_max - f_lat * f_lat
        safe = jnp.maximum(slack, 1e-12)
        return jnp.where(slack > 0.0, jnp.sqrt(safe), 0.0)


def load_vehicle(name_or_path: str):
    """Load a vehicle JSON, dispatching on schema instead of the reference's
    literal path comparison (src/__main__.py:100-103): files with an
    "engineMap" are point-mass vehicles, files with tire tables are Pacejka.
    """
    path = io.resolve_vehicle(name_or_path)
    data = io.load_jsonc(path)
    if "engineMap" in data:
        return PointMassVehicle(
            mass=jnp.asarray(float(data["mass"])),
            friction_coef=jnp.asarray(float(data["frictionCoefficient"])),
            engine_v=jnp.asarray(data["engineMap"]["v"], dtype=jnp.result_type(float)),
            engine_f=jnp.asarray(data["engineMap"]["f"], dtype=jnp.result_type(float)),
            name=data["name"],
        )
    as_arr = lambda x: jnp.asarray(float(x))
    return PacejkaVehicle(
        mass=as_arr(data["mass"]),
        rotational_inertia=as_arr(data["rotational_inertia"]),
        length_f=as_arr(data["length_f"]),
        length_r=as_arr(data["length_r"]),
        width=as_arr(data.get("width", 2.0)),
        B_f=as_arr(data["frontTire"]["B_f"]),
        C_f=as_arr(data["frontTire"]["C_f"]),
        D_f=as_arr(data["frontTire"]["D_f"]),
        B_r=as_arr(data["rearTire"]["B_r"]),
        C_r=as_arr(data["rearTire"]["C_r"]),
        D_r=as_arr(data["rearTire"]["D_r"]),
        Cr_0=as_arr(data["Cr_0"]),
        Cr_2=as_arr(data["Cr_2"]),
        ptv=as_arr(data["ptv"]),
        C_m=as_arr(data["control"]["C_m"]),
        T=as_arr(data["control"]["T"]),
        friction_coef=as_arr(data["control"]["lambda"]),
        ro_long=as_arr(data["control"]["ro_long"]),
        name=data["name"],
    )
