"""Spline-basis comparison driver — the finished version of the reference's
`src/simplify.py` (its POLY/TRIG/HYP enum at src/simplify.py:12-16 is the spec;
everything below the argument parser is commented out there).

For the chosen basis (or all three with --all) this fits the track centerline
(alphas = 0.5, the reference Trajectory's initial state), samples it per
metre, and reports interpolation residual, curvature energy Γ², arc length,
the quasi-static lap time, and on-device evaluation throughput — i.e. the
comparison the reference intended to make, with the hyperbolic/trigonometric
bases actually implemented (`ops/spline_extra.py`).
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from lap_time_optimization.models import load_vehicle
from lap_time_optimization.ops import spline, spline_extra, velocity
from lap_time_optimization.track import Track
from lap_time_optimization.viz import plot as plot_mod

BASES = ("poly", "trig", "hyp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Track spline simplification method comparison")
    p.add_argument("track", type=str, help="path to JSON containing track data")
    p.add_argument("vehicle", type=str, help="path to JSON containing vehicle data")
    p.add_argument("track_width", nargs="?", type=float, default=1.0,
                   help="fraction of the track width to use (default 1.0)")
    basis = p.add_argument_group("spline").add_mutually_exclusive_group(required=True)
    basis.add_argument("--poly", action="store_const", dest="basis", const="poly",
                       help="polynomial (cubic) B-spline interpolation")
    basis.add_argument("--trig", action="store_const", dest="basis", const="trig",
                       help="trigonometric (Fourier) spline interpolation")
    basis.add_argument("--hyp", action="store_const", dest="basis", const="hyp",
                       help="hyperbolic (tension) spline interpolation")
    basis.add_argument("--all", action="store_const", dest="basis", const="all",
                       help="compare all three bases side by side")
    p.add_argument("--tension", type=float, default=0.5,
                   help="tension parameter tau for --hyp (per metre of chord)")
    p.add_argument("--plot-path", action="store_true", dest="plot_path",
                   help="plot the fitted centerline for each basis")
    p.add_argument("--plot-format", type=str, dest="ext", default="png")
    p.add_argument("--output-dir", type=str, default="./data",
                   help="root directory for plots")
    return p


def _fit(basis: str, controls, closed: bool, tension: float):
    if basis == "poly":
        return spline.fit(controls, closed)
    if basis == "trig":
        return spline_extra.trig_fit(controls, closed)
    if basis == "hyp":
        return spline_extra.tension_fit(controls, closed, tension=tension)
    raise ValueError(f"unknown basis {basis}")


def _eval_fns(basis: str):
    if basis == "poly":
        return spline.evaluate, lambda sp, u: spline.curvature(sp, u, signed=False)
    ev = spline_extra.trig_evaluate if basis == "trig" else spline_extra.tension_evaluate
    return ev, lambda sp, u: spline_extra.curvature(sp, u, signed=False)


def analyse_basis(basis: str, track: Track, vehicle, tension: float = 0.5) -> dict:
    """Fit the centerline with `basis` and compute the comparison metrics."""
    alphas = jnp.full((track.size,), 0.5, dtype=track.left.dtype)
    controls = track.control_points(alphas)
    sp = _fit(basis, controls, track.closed, tension)
    ev, curv = _eval_fns(basis)

    u = jnp.linspace(0.0, float(sp.length), track.ns)
    # interpolation residual at the control sites (should be ~roundoff);
    # the trig basis places its nodes uniformly in index, the piecewise
    # bases at the chord-length parameter values
    tk = sp.nodes if basis == "trig" else spline.chord_lengths(controls)
    fit_pts = ev(sp, tk, 0)
    resid = float(jnp.max(jnp.sqrt(jnp.sum((fit_pts - controls) ** 2, axis=0))))

    k = curv(sp, u[:-1])
    g2 = float(jnp.sum(k * k))
    d1 = ev(sp, u, 1)
    speed = jnp.sqrt(d1[0] ** 2 + d1[1] ** 2)
    length = float(jnp.sum(0.5 * (speed[1:] + speed[:-1]) * jnp.diff(u)))
    v = velocity.solve_profile(vehicle, u[:-1], k, sp.length, track.closed)
    lap = float(velocity.lap_time(u, v))

    # on-device evaluation throughput (position+derivatives at ns samples)
    bench = jax.jit(lambda s, uu: (ev(s, uu, 0), ev(s, uu, 1), ev(s, uu, 2)))
    out = bench(sp, u)
    jax.block_until_ready(out)
    t0 = time.time()
    reps = 50
    for _ in range(reps):
        out = bench(sp, u)
    jax.block_until_ready(out)
    evals_per_s = reps * track.ns / (time.time() - t0)

    return {
        "basis": basis,
        "spline": sp,
        "samples": np.asarray(ev(sp, u, 0)),
        "velocities": np.asarray(v),
        "fit_residual_m": resid,
        "gamma2": g2,
        "path_length_m": length,
        "lap_time_s": lap,
        "eval_throughput_per_s": evals_per_s,
    }


def run(args) -> list[dict]:
    track = Track.load(args.track, track_width=args.track_width)
    print(f"[ Imported {track.name} ]")
    vehicle = load_vehicle(args.vehicle)
    print(f"[ Imported {vehicle.name} ]")

    bases = BASES if args.basis == "all" else (args.basis,)
    results = []
    for basis in bases:
        print(f"[ Fitting {basis} spline ]")
        results.append(analyse_basis(basis, track, vehicle, tension=args.tension))

    print()
    print("=== Spline comparison ================================================")
    header = f"{'':>22s}" + "".join(f"{r['basis']:>14s}" for r in results)
    print(header)
    rows = [
        ("Fit residual (m)", "fit_residual_m", "{:14.2e}"),
        ("Gamma^2", "gamma2", "{:14.4f}"),
        ("Path length (m)", "path_length_m", "{:14.3f}"),
        ("Lap time (s)", "lap_time_s", "{:14.3f}"),
        ("Eval rate (pts/s)", "eval_throughput_per_s", "{:14.3e}"),
    ]
    for label, key, fmt in rows:
        print(f"{label:>22s}" + "".join(fmt.format(r[key]) for r in results))
    print("======================================================================")

    if args.plot_path:
        plot_dir = os.path.join(args.output_dir, "plots", vehicle.name, track.name, "simplify")
        os.makedirs(plot_dir, exist_ok=True)
        for r in results:
            dest = os.path.join(plot_dir, f"path_{r['basis']}.{args.ext}")
            plot_mod.plot_path(dest, np.asarray(track.left), np.asarray(track.right),
                               r["samples"])
            print(f"[ Wrote {dest} ]")
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
