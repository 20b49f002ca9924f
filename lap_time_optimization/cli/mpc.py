"""NMPC closed-loop CLI — surface parity with reference src/mpc.py.

Same method flags choosing which racing-line artifact set to track, same
`sim_results.json` output schema, same default 500 × 0.1 s simulation.

Deliberate fixes (SURVEY.md §7): `--laptime` loads real laptime artifacts
when they exist instead of silently mapping to "compromise"
(reference src/mpc.py:55-57 quirk — kept as fallback); the sample count
derives from the velocities artifact instead of the hardcoded 846
(src/mpc.py:88).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import NamedTuple

import numpy as np

from lap_time_optimization.models import load_vehicle
from lap_time_optimization.models.bicycle import BicycleModel
from lap_time_optimization.mpc import runner
from lap_time_optimization.mpc import track as mpc_track
from lap_time_optimization.mpc.solver import OCPParams, SolverConfig
from lap_time_optimization.utils import io


def build_parser():
    p = argparse.ArgumentParser(description="Closed-loop NMPC simulation (JAX, on a GPU or the CPU)")
    methods = p.add_argument_group("generation methods").add_mutually_exclusive_group(required=True)
    methods.add_argument("--curvature", action="store_const", dest="method", const="curvature")
    methods.add_argument("--compromise", action="store_const", dest="method", const="compromise")
    methods.add_argument("--laptime", action="store_const", dest="method", const="laptime")
    methods.add_argument("--bayes", action="store_const", dest="method", const="bayesian")
    p.add_argument("--vehicle", type=str, default="MX5", help="vehicle name/path (artifact dir uses its name)")
    p.add_argument("--track", type=str, default="buckmore")
    p.add_argument("--steps", type=int, default=None, help="simulation steps (reference src/mpc.py:125)")
    p.add_argument("--horizon", type=int, default=None, help="MPC horizon (reference src/mpc/controller.py:9)")
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--config", type=str, default=None,
                   help="JSON config overriding the reference-default MPC parameters "
                        "(horizon, dt, steps, weights, x0); explicit flags win over it")
    p.add_argument("--data-dir", type=str, default=None, help="artifact base dir (default: auto-discover)")
    p.add_argument("--output", type=str, default="sim_results.json")
    p.add_argument("--plot", action="store_true", help="write replay + internals plots")
    p.add_argument("--vref-scale", type=float, default=None,
                   help="fraction of the racing-line velocity profile to track "
                        "(the reference hardcodes 0.6, src/mpc/controller.py:53)")
    p.add_argument("--vref-preview", type=float, default=None, metavar="DECEL",
                   help="braking-curve preview budget [m/s^2] baked into the vref "
                        "table so short horizons see corner braking points early "
                        "(mpc/track.with_brake_preview); 0 = off")
    p.add_argument("--backend", type=str, default="auto", choices=["auto", "pallas", "xla"],
                   help="iLQR backend (mpc/solver.SolverConfig.backend): auto = the "
                        "fused kernel on a GPU, the XLA scans on the CPU")
    p.add_argument("--platform", type=str, default=None,
                   help="force a JAX platform (e.g. cpu, gpu); default: JAX's own choice")
    p.add_argument("--x64", action="store_true",
                   help="enable float64 (CPU oracle runs; GPU runs use f32)")
    return p


class MPCRun(NamedTuple):
    """What `main` ran: the closed loop and the stack it ran on."""

    result: runner.SimResult
    model: BicycleModel
    params: OCPParams
    wall_first: float  # seconds, compile included
    wall_steady: float  # seconds, the compiled program rerun


def effective_config(args):
    """Merge the MPC config layer: dataclass defaults < --config file < flags."""
    from lap_time_optimization.utils.config import Config

    cfg = Config.load(args.config) if getattr(args, "config", None) else Config()
    m = cfg.mpc
    if args.steps is not None:
        m = dataclasses.replace(m, steps=args.steps)
    if args.horizon is not None:
        m = dataclasses.replace(m, horizon=args.horizon)
    if args.dt is not None:
        m = dataclasses.replace(m, dt=args.dt)
    if args.vref_scale is not None:
        m = dataclasses.replace(m, vref_scale=args.vref_scale)
    if getattr(args, "vref_preview", None) is not None:
        m = dataclasses.replace(m, vref_preview_decel=args.vref_preview)
    return dataclasses.replace(cfg, mpc=m)


def load_stack(args):
    """Build (track tables, vehicle, model) from the artifact set."""
    from lap_time_optimization.models.vehicle import PacejkaVehicle

    vehicle = load_vehicle(args.vehicle)
    if not isinstance(vehicle, PacejkaVehicle):
        raise ValueError(
            f"NMPC requires a Pacejka-parameterized vehicle (MX5-style JSON); "
            f"'{vehicle.name}' is a point-mass vehicle. The racing-line stage "
            f"supports both families; the bicycle dynamics need tire data."
        )
    fallbacks = ("compromise",) if args.method == "laptime" else ()
    found, method = io.find_artifact_dir(
        vehicle.name, args.track, args.method, base=args.data_dir, method_fallbacks=fallbacks
    )
    track = mpc_track.load(vehicle.name, args.track, method, base_dir=found)
    model = BicycleModel(vehicle=vehicle, track=track)
    return track, vehicle, model


def main(argv=None):
    args = build_parser().parse_args(argv)
    from lap_time_optimization.cli.race import apply_backend_flags

    apply_backend_flags(args)
    print(f"[ Path method: {args.method} ]")
    track, vehicle, model = load_stack(args)
    print(f"[ Loaded artifacts: lap length {float(track.s_max):.1f} m, "
          f"{track.s_grid.shape[0]} table samples ]")

    import jax.numpy as jnp

    conf = effective_config(args)
    mc = conf.mpc
    if mc.vref_preview_decel > 0.0:
        track = mpc_track.with_brake_preview(
            track, mc.vref_preview_decel, vref_scale=mc.vref_scale
        )
        model = dataclasses.replace(model, track=track)
        print(f"[ vref brake preview: {mc.vref_preview_decel:.2f} m/s^2 budget ]")
    dtype = track.s_grid.dtype
    a = lambda v: jnp.asarray(v, dtype)
    p = dataclasses.replace(
        OCPParams.reference(dtype),
        q_n=a(mc.q_n), q_mu=a(mc.q_mu), q_B=a(mc.q_B),
        r_delta=a(mc.r_controls[0]), r_throttle=a(mc.r_controls[1]),
        vref_scale=a(mc.vref_scale), lateral_margin=a(mc.lateral_margin),
    )
    cfg = dataclasses.replace(SolverConfig.for_horizon(mc.horizon, dt=mc.dt), backend=args.backend)
    x0 = jnp.asarray(mc.x0, dtype)
    steps = mc.steps

    print(f"[ Running {steps} steps, horizon {cfg.horizon}, dt {cfg.dt}, backend {cfg.backend} ]")
    t0 = time.time()
    result = runner.closed_loop(model, p, cfg, x0, steps)
    result.xs.block_until_ready()
    wall = time.time() - t0
    # steady-state timing: rerun the compiled program
    t0 = time.time()
    result = runner.closed_loop(model, p, cfg, x0, steps)
    result.xs.block_until_ready()
    steady = time.time() - t0

    xs = np.asarray(result.xs)
    sdot = np.asarray(result.sdot)
    viol = np.asarray(result.violations)
    print()
    print("=== NMPC Results =====================================================")
    print(f"Simulated time     = {steps * mc.dt:.1f} s")
    print(f"Track progress     = {xs[-1, 0]:.1f} m of {float(track.s_max):.1f} m lap")
    print(f"Mean sdot          = {np.mean(sdot):.3f} m/s")
    print(f"Max |n| deviation  = {np.max(np.abs(xs[:, 1])):.3f} m")
    print(f"Max cons violation = {np.max(viol):.4f}")
    print(f"Wall (first, incl compile) = {wall:.2f} s")
    print(f"Wall (steady)      = {steady:.2f} s  → {steps / steady:.1f} solves/s")
    print("======================================================================")
    print()

    with open(args.output, "w") as f:
        json.dump(runner.to_sim_results(model, result), f)
    base, _ = os.path.splitext(args.output)
    with open(base + "_config.json", "w") as f:
        f.write(conf.to_json())
    print(f"[ Wrote {args.output} ]")

    if args.plot:
        from lap_time_optimization.viz import visualiser

        base, _ = os.path.splitext(args.output)
        visualiser.plot_replay(base + "_replay.png", track, args.output)
        visualiser.plot_internal(base + "_internals.png", track, args.output, dt=mc.dt)
        print(f"[ Wrote {base}_replay.png, {base}_internals.png ]")

    return MPCRun(result, model, p, wall, steady)


if __name__ == "__main__":
    main()
