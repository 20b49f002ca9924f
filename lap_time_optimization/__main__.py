"""`python -m lap_time_optimization <track> <vehicle> <width> --method`

Racing-line entry point, mirroring `python src/__main__.py` in the reference.
The NMPC closed loop lives at `python -m lap_time_optimization.cli.mpc`.
"""

from lap_time_optimization.cli.race import main

if __name__ == "__main__":
    main()
