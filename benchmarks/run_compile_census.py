"""Census of the distinct compiled programs in one COLD bayes run
(VERDICT r4 item 3: the cold path is dominated by compilation, one
program per distinct shape, so the shapes are counted).

Method: install a logging handler on the JAX compiler loggers with
`jax_log_compiles` enabled, run `global_search.bayesian` from a cold process
with the production configuration, and record every "Finished XLA
compilation of <name> in <t> sec" event plus the total wall split
(compile vs run).  Writes benchmarks/compile_census.json.

Usage: python benchmarks/run_compile_census.py [--budget small|full]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class CompileRecorder(logging.Handler):
    PAT = re.compile(r"Finished (?:XLA compilation|jaxpr to MLIR module conversion|tracing \+ transforming) of (.+?) (?:because of|in) ([0-9.e+-]+) sec")

    def __init__(self):
        super().__init__()
        self.events = []
        self.t0 = time.perf_counter()

    def emit(self, record):
        msg = record.getMessage()
        m = self.PAT.search(msg)
        if m and "XLA compilation" in msg:
            self.events.append({
                "name": m.group(1),
                "seconds": float(m.group(2)),
                "at_wall_s": round(time.perf_counter() - self.t0, 2),
            })


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", choices=("small", "full"), default="full")
    ap.add_argument("--vehicle", default="tbr18")
    ap.add_argument("--platform", default=None,
                    help="jax platform override (applied through jax.config)")
    ap.add_argument("--solver", default="scan", choices=["scan", "assoc"])
    ap.add_argument("--out", type=str, default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "compile_census.json"))
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_log_compiles", True)
    rec = CompileRecorder()
    # attach ONLY to the root "jax" logger: child loggers (e.g.
    # jax._src.compiler) propagate upward, and attaching to both would
    # double-count every event.  WARNING level, NOT DEBUG: with
    # jax_log_compiles the compile events log at WARNING, and enabling DEBUG
    # on the whole jax logger measurably inflates the run it is censusing
    # (the first full-budget census read 130 s for a polish phase that runs
    # in ~30 s un-instrumented)
    lg = logging.getLogger("jax")
    lg.addHandler(rec)
    lg.setLevel(logging.WARNING)

    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.optim import global_search
    from lap_time_optimization.track import Track

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    track = Track.load(os.path.join(repo, "data", "tracks", "buckmore.json"),
                       track_width=0.99)
    vehicle = load_vehicle(os.path.join(repo, "data", "vehicles",
                                        f"{args.vehicle}.json"))

    kw = dict(seed=0, solver=args.solver)
    if args.budget == "small":
        kw.update(n_init=32, n_local=16, n_uniform=16, max_rounds=3,
                  min_samples=2, polish_iters=30)

    t0 = time.perf_counter()
    _, best_f, info = global_search.bayesian(track, vehicle, **kw)
    wall = time.perf_counter() - t0

    compile_total = sum(e["seconds"] for e in rec.events)
    summary = {
        "meta": {
            "device": str(jax.devices()[0]),
            "budget": args.budget,
            "vehicle": args.vehicle,
            "best_lap_s": round(best_f, 3),
            "bo_timings": info["timings"],
        },
        "wall_s": round(wall, 1),
        "compile_s_total": round(compile_total, 1),
        "compile_pct_of_wall": round(100 * compile_total / wall, 1),
        "n_compiles": len(rec.events),
        "events": rec.events,
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"cold wall {wall:.1f}s, compile {compile_total:.1f}s "
          f"({100*compile_total/wall:.0f}%) across {len(rec.events)} programs")
    for e in rec.events:
        print(f"  {e['seconds']:7.1f}s  {e['name']}")
    print("wrote", args.out)


if __name__ == "__main__":
    main()
