"""Racing-line CLI — drop-in surface parity with reference src/__main__.py.

Same positionals (track JSON, vehicle JSON, usable track-width fraction), same
mutually-exclusive method flags, same plot flags, same artifact layout
(data/plots/<vehicle>/<track>/<method>/), same results block format — so runs
are directly diffable against the reference.

Extensions: --output-dir (the reference hardcodes a path relative to its own
source tree, src/__main__.py:179-181), --seed for the stochastic methods, and
a post-compile timing line (JAX separates compile from steady-state cost).
"""

from __future__ import annotations

import argparse
import os
import time

import jax.numpy as jnp
import numpy as np

from lap_time_optimization.models import load_vehicle
from lap_time_optimization.optim import global_search, racing_line
from lap_time_optimization.track import Track
from lap_time_optimization.utils import io

METHOD_DIRS = {
    "curvature": "curvature",
    "compromise": "compromise",
    "laptime": "laptime",
    "sectors": "sectors",
    "estimated": "estimated",
    "bayes": "bayesian",
    "nonlinear": "nonlinear",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Racing line optimisation (JAX, on a GPU or the CPU)")
    p.add_argument("track", type=str, help="path to JSON containing track data")
    p.add_argument("vehicle", type=str, help="path to JSON containing vehicle data")
    p.add_argument(
        "track_width",
        type=float,
        help="fraction (0.01..1.0) of the track width the car may use",
    )
    methods = p.add_argument_group("generation methods").add_mutually_exclusive_group(required=True)
    methods.add_argument("--curvature", action="store_const", dest="method", const="curvature",
                         help="minimise curvature")
    methods.add_argument("--compromise", action="store_const", dest="method", const="compromise",
                         help="minimise an optimal length-curvature compromise")
    methods.add_argument("--bayes", action="store_const", dest="method", const="bayes",
                         help="minimise time via bayesian optimisation")
    methods.add_argument("--nonlinear", action="store_const", dest="method", const="nonlinear",
                         help="minimise time via nonlinear optimisation")
    methods.add_argument("--laptime", action="store_const", dest="method", const="laptime",
                         help="directly minimise lap time")
    methods.add_argument("--sectors", action="store_const", dest="method", const="sectors",
                         help="optimise and merge sector paths")
    methods.add_argument("--estimated", action="store_const", dest="method", const="estimated",
                         help="minimise a pre-computed length-curvature compromise")
    p.add_argument("--plot-corners", action="store_true", dest="plot_corners")
    p.add_argument("--plot-path", action="store_true", dest="plot_path")
    p.add_argument("--plot-trajectory", action="store_true", dest="plot_trajectory")
    p.add_argument("--plot-all", action="store_true", dest="plot_all")
    p.add_argument("--plot-format", type=str, dest="ext", default="png")
    p.add_argument("--output-dir", type=str, default="./data",
                   help="base directory for plots + JSON artifacts")
    p.add_argument("--seed", type=int, default=0, help="PRNG seed for bayes/nonlinear")
    p.add_argument("--restarts", type=int, default=1,
                   help="bayes/nonlinear: run the whole search from this many "
                        "seeds (seed..seed+N-1) and keep the best line — the "
                        "restart protocol from benchmarks/run_parity_matrix; "
                        "single-run results vary ~0.3%% across processes, "
                        "so restarts trade wall time for quality")
    p.add_argument("--config", type=str, default=None,
                   help="JSON config overriding the reference-default hyperparameters "
                        "(corner detection, epsilon search, bayes/nonlinear budgets); "
                        "the effective config is dumped into the artifact dir")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans (the on-device sanitizer mode)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a jax.profiler trace (perfetto) to this directory")
    p.add_argument("--platform", type=str, default=None,
                   help="force a JAX platform (e.g. cpu, gpu); default: JAX's own choice")
    p.add_argument("--x64", action="store_true",
                   help="enable float64 (CPU oracle runs; GPU runs use f32)")
    return p


def apply_backend_flags(args):
    """Apply --platform/--x64 before any JAX computation runs (jax.config,
    not env vars: JAX may already be imported), then say which device the
    run is on."""
    import jax

    if getattr(args, "platform", None):
        jax.config.update("jax_platforms", args.platform)
    if getattr(args, "x64", False):
        jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    print(f"[ Device: {devs[0].platform} {devs[0].device_kind} x{len(devs)} ]")


def run(args) -> dict:
    import jax

    apply_backend_flags(args)
    if getattr(args, "debug_nans", False):
        jax.config.update("jax_debug_nans", True)
    from lap_time_optimization.utils import profiling

    prof = profiling.trace(getattr(args, "profile_dir", None))
    prof.__enter__()
    try:
        return _run_inner(args)
    finally:
        prof.__exit__(None, None, None)


def _run_inner(args) -> dict:
    from lap_time_optimization.utils.config import Config

    cfg = Config.load(args.config) if getattr(args, "config", None) else Config()
    track = Track.load(args.track, track_width=args.track_width)
    print(f"[ Imported {track.name} ]")
    vehicle = load_vehicle(args.vehicle)
    print(f"[ Imported {vehicle.name} ]")

    t0 = time.time()
    decongested = args.method in ("bayes", "nonlinear")

    if args.method == "curvature":
        print("[ Minimising curvature ]")
        alphas = racing_line.minimise_curvature(track).x
    elif args.method == "compromise":
        print("[ Minimising optimal compromise ]")
        alphas, epsilon, _ = racing_line.minimise_optimal_compromise(
            track, vehicle,
            eps_min=cfg.compromise.eps_min, eps_max=cfg.compromise.eps_max,
            n_grid=cfg.compromise.n_grid, n_refine=cfg.compromise.n_refine,
        )
        print(f"  epsilon = {epsilon:.4f}")
    elif args.method == "laptime":
        print("[ Minimising lap time ]")
        alphas = racing_line.minimise_lap_time(track, vehicle).x
    elif args.method == "sectors":
        print("[ Optimising sectors ]")
        alphas, eps_w, _ = racing_line.optimise_sectors(
            track, vehicle,
            k_min=cfg.corners.k_min, proximity=cfg.corners.proximity,
            length=cfg.corners.length,
        )
        for i, e in enumerate(np.asarray(eps_w)):
            print(f"  Sector {i:d}: eps={float(e):.4f}")
    elif args.method == "estimated":
        print("[ Minimising pre-computed compromise ]")
        alphas, epsilon = racing_line.minimise_estimated_compromise(track, vehicle)
        print(f"  epsilon = {epsilon:.4f}")
    elif args.method == "bayes":
        print("[ BAYES ]")
        b = cfg.bayes
        best = None
        for s_ in range(args.seed, args.seed + max(1, args.restarts)):
            a_, _, info = global_search.bayesian(
                track, vehicle, seed=s_,
                n_init=b.n_init, n_local=b.n_local, n_uniform=b.n_uniform,
                max_rounds=b.max_rounds, sigma_window=b.sigma_window,
                sigma_tol=b.sigma_tol, min_samples=b.min_samples,
                polish_every=b.polish_every, polish_iters=b.polish_iters,
            )
            t_, *_ = global_search.evaluate_decongested_jit(track, vehicle, a_)
            print(f"  seed {s_}: {float(t_):.3f} s "
                  f"({info['rounds']} rounds / {info['n_samples']} samples)")
            if best is None or float(t_) < best[0]:
                best = (float(t_), a_)
        alphas = best[1]
    elif args.method == "nonlinear":
        print("[ NONLINEAR ]")
        nl = cfg.nonlinear
        best = None
        for s_ in range(args.seed, args.seed + max(1, args.restarts)):
            a_, _ = global_search.nonlinear(
                track, vehicle, seed=s_,
                n_random=nl.n_random, n_refine=nl.n_refine, max_iter=nl.max_iter,
            )
            t_, *_ = global_search.evaluate_decongested_jit(track, vehicle, a_)
            if args.restarts > 1:
                print(f"  seed {s_}: {float(t_):.3f} s")
            if best is None or float(t_) < best[0]:
                best = (float(t_), a_)
        alphas = best[1]
    else:  # pragma: no cover
        raise ValueError(f"unknown method {args.method}")

    print("[ Computing lap time ]")
    from lap_time_optimization.ops import spline as spline_ops

    if decongested:
        lap_time, length, v, s = global_search.evaluate_decongested_jit(track, vehicle, alphas)
        controls = track.control_points_decongested(alphas)
    else:
        lap_time, length, v, s = racing_line.evaluate_jit(track, vehicle, alphas)
        controls = track.control_points(alphas)
    sp = spline_ops.fit(controls, track.closed)
    run_time = time.time() - t0

    lap_time = float(lap_time)
    length = float(length)
    v = np.asarray(v)
    print()
    print("=== Results ==========================================================")
    print("Lap time = {:.3f}".format(lap_time))
    print("Run time = {:.3f}".format(run_time))
    print("Path Length = {:.3f}".format(length))
    print("Max velocity = {:.3f}".format(float(np.max(v))))
    print("Mean velocity = {:.3f}".format(float(np.mean(v))))
    print("======================================================================")
    print()

    # ---------------------------------------------------------------- artifacts
    plot_dir = io.artifact_dir(args.output_dir, vehicle.name, track.name, METHOD_DIRS[args.method])
    os.makedirs(plot_dir, exist_ok=True)

    positions = np.asarray(spline_ops.evaluate(sp, s))

    if args.plot_corners or args.plot_all:
        from lap_time_optimization.viz import plot as viz

        _, mask = racing_line.detect_track_corners(
            track, cfg.corners.k_min, cfg.corners.proximity, cfg.corners.length)
        mid = track.mid_spline()
        mid_pos = np.asarray(spline_ops.evaluate(mid, jnp.linspace(0.0, mid.length, track.ns)))
        viz.plot_corners(os.path.join(plot_dir, f"corners.{args.ext}"),
                         track.old_left, track.old_right, mid_pos, mask)
    if args.plot_path or args.plot_all:
        from lap_time_optimization.viz import plot as viz

        viz.plot_path(os.path.join(plot_dir, f"path.{args.ext}"),
                      track.old_left, track.old_right, positions, np.asarray(sp.controls))
    if args.plot_trajectory or args.plot_all:
        from lap_time_optimization.viz import plot as viz

        viz.plot_trajectory(os.path.join(plot_dir, f"trajectory.{args.ext}"),
                            track.old_left, track.old_right, positions, v)

    # effective config: reproducibility record for this artifact set
    with open(os.path.join(plot_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    # always save the NMPC-stage inputs (reference src/__main__.py:199-213)
    io.save_path_json(plot_dir, positions[0], positions[1], "path")
    io.save_path_json(plot_dir, np.asarray(track.old_left)[0], np.asarray(track.old_left)[1], "left")
    io.save_path_json(plot_dir, np.asarray(track.old_right)[0], np.asarray(track.old_right)[1], "right")
    io.save_widths_json(plot_dir, np.asarray(track.widths), "widths")
    io.save_velocities_json(plot_dir, v, "velocities")

    from lap_time_optimization.utils import profiling

    profiling.log_metrics(
        method=args.method,
        track=track.name,
        vehicle=vehicle.name,
        lap_time_s=lap_time,
        run_time_s=round(run_time, 3),
        path_length_m=length,
    )
    return dict(
        lap_time=lap_time,
        run_time=run_time,
        length=length,
        max_velocity=float(np.max(v)),
        mean_velocity=float(np.mean(v)),
        alphas=np.asarray(alphas),
        artifact_dir=plot_dir,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
