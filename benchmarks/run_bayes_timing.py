"""Bayesian-search wall-time benchmark (VERDICT round-2 item 2).

Measures `global_search.bayesian` end-to-end on the production platform in
f32, cold (including jit compiles) and warm (steady state, compile-cached),
for both vehicles at seed 0 — the same configuration as the README parity
matrix columns (reference README.md:122 publishes 22.4 s for tbr18 bayes).

Writes benchmarks/bayes_timing.json.  Run on the GPU:

    python benchmarks/run_bayes_timing.py --solver assoc
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", type=str, default="assoc",
                    choices=["scan", "assoc"])
    ap.add_argument("--out", type=str,
                    default=os.path.join(os.path.dirname(__file__), "bayes_timing.json"))
    args = ap.parse_args()

    import jax

    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.optim import global_search
    from lap_time_optimization.track import Track

    platform = jax.devices()[0].platform
    results = {"meta": {"platform": platform, "solver": args.solver,
                        "x64": bool(jax.config.jax_enable_x64), "seed": 0}}

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    track = Track.load(os.path.join(repo, "data", "tracks", "buckmore.json"), track_width=0.99)
    for name in ("tbr18", "MX5"):
        vehicle = load_vehicle(os.path.join(repo, "data", "vehicles", f"{name}.json"))
        runs = {}
        for phase in ("cold", "warm"):
            t0 = time.perf_counter()
            alphas, lap, info = global_search.bayesian(
                track, vehicle, seed=0, solver=args.solver)
            jax.block_until_ready(lap)
            wall = time.perf_counter() - t0
            re_eval, *_ = global_search.evaluate_decongested_jit(track, vehicle, alphas)
            runs[phase] = {"wall_s": round(wall, 1),
                           "lap_s": round(float(re_eval), 3),
                           "rounds": int(info["rounds"]),
                           "timings": info.get("timings", {})}
            print(f"{name} {phase}: re-eval={float(re_eval):.3f} "
                  f"rounds={info['rounds']} wall={wall:.1f}s", flush=True)
        results[name] = runs

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
