"""Device-utilization evidence for the "fast" claims (VERDICT r3 item 3).

PERFORMANCE.md asserts the NMPC single stream is latency/serial-chain-bound
and that the batched paths are where utilization lives; this script turns
those prose claims into committed numbers for three workloads:

(a) one single-stream NMPC solve (h10, the default backend) — serial-chain
    device time vs dispatch floor;
(b) a B=1024 racing-line `search_step` (the dp-parallel search round);
(c) a B=128 batched NMPC step (`solve_batch`, the serving path).

Method — in-program slopes: each workload runs inside ONE device program as
a `lax.fori_loop` of n dependent reps, timed at two rep counts; the slope is
the steady per-rep device time with dispatch excluded, and the intercept is
the per-program dispatch/sync overhead.  The rep body is data-dependent on
the previous rep, so XLA cannot batch or elide iterations.

FLOP/byte counts come from XLA's own `compiled.cost_analysis()` on the
single-rep program; achieved FLOP/s and HBM GB/s are reported against the
published peaks of the device kind JAX reports (`PEAKS`; an unknown kind is
an error).  These workloads are latency-bound by construction (tiny serial chains /
wide elementwise sweeps, not large matmuls), so the interesting columns are
bytes/s for the batched paths and the dispatch-vs-device split for the
single stream; classic MFU is near zero by construction and reported as
such.

Writes benchmarks/utilization.json.  Optional: --trace DIR captures a
jax.profiler trace of one rep of each workload.

Usage: python benchmarks/run_utilization.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: published dense peaks by `device_kind` (NVIDIA H100 SXM data sheet, at
#: its 700 W limit; a card set lower cannot hold them): bf16 tensor-core
#: FLOP/s and HBM bytes/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; add them to PEAKS")
    return PEAKS[device_kind]


def slope_time(make_fn, reps=(3, 13), warmup=True):
    """Wall time of a jitted fori_loop program at two rep counts →
    (per-rep slope seconds, per-program intercept seconds)."""
    import jax
    import numpy as _np

    def _sync(out):
        # device→host readback of one leaf: the result is on the host, so
        # the device work behind it has finished
        _np.asarray(jax.tree_util.tree_leaves(out)[0])

    fns = {n: make_fn(n) for n in reps}
    ts = {}
    for n, fn in fns.items():
        _sync(fn())  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _sync(fn())
            best = min(best, time.perf_counter() - t0)
        ts[n] = best
    n0, n1 = reps
    slope = (ts[n1] - ts[n0]) / (n1 - n0)
    intercept = ts[n0] - slope * n0
    return slope, intercept


def cost_analysis(jitted, *args):
    """XLA's flops / bytes-accessed estimate for one call, or {}."""
    try:
        c = jitted.lower(*args).compile().cost_analysis()
        if isinstance(c, (list, tuple)):
            c = c[0]
        return {
            "flops": float(c.get("flops", float("nan"))),
            "bytes_accessed": float(c.get("bytes accessed", float("nan"))),
        }
    except Exception as e:  # cost analysis is best-effort on some backends
        return {"error": str(e)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", type=str, default=None,
                    help="directory for a jax.profiler trace of each workload")
    ap.add_argument("--out", type=str, default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "utilization.json"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.models.bicycle import BicycleModel
    from lap_time_optimization.mpc import runner, solver as S
    from lap_time_optimization.mpc import track as mpc_track
    from lap_time_optimization.mpc.solver import OCPParams, SolverConfig, n_con
    from lap_time_optimization.parallel import mesh as pmesh
    from lap_time_optimization.track import Track

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dev = jax.devices()[0]
    peaks = peaks_for(dev.device_kind)
    PEAK_BF16_FLOPS, PEAK_HBM_BPS = peaks["bf16_flops"], peaks["hbm_bytes_per_s"]
    results = {"meta": {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "method": "in-program fori_loop slopes (reps 3 vs 13, best of 3); "
                  "flops/bytes from XLA cost_analysis of one rep",
        "peaks": peaks,
    }}

    # ---------------------------------------------------------- (a) NMPC solve
    track = mpc_track.load("MX-5", "buckmore", "curvature",
                           base_dir=os.path.join(repo, "data"))
    model = BicycleModel(vehicle=load_vehicle("MX5"), track=track)
    dtype = jnp.float32
    p = OCPParams.reference(dtype, lateral_margin=0.05)
    cfg = SolverConfig(horizon=10)
    x0 = jnp.asarray(runner.X0_REFERENCE, dtype)
    z0 = jnp.concatenate([x0, jnp.zeros(2, dtype)])
    us0 = jnp.zeros((cfg.horizon, 2), dtype)
    lam0 = jnp.zeros((cfg.horizon + 1, n_con(model)), dtype)

    def make_solve(n):
        @jax.jit
        def run():
            def body(_, carry):
                us, lam = carry
                r = S.solve(model, p, cfg, z0, us, lam)
                return r.us, r.lam
            return jax.lax.fori_loop(0, n, body, (us0, lam0))
        return run

    slope, intercept = slope_time(make_solve)
    one = jax.jit(lambda: S.solve(model, p, cfg, z0, us0, lam0).us)
    ca = cost_analysis(one)
    flops = ca.get("flops")
    results["nmpc_single_solve_h10"] = {
        "device_s_per_solve": slope,
        "dispatch_intercept_s": intercept,
        "solve_rate_hz_in_program": 1.0 / slope,
        "cost_analysis": ca,
        "achieved_flops_per_s": (flops / slope) if flops else None,
        "pct_of_bf16_peak": (100 * flops / slope / PEAK_BF16_FLOPS) if flops else None,
        "note": "serial 10x10 chain: device time IS the latency; MFU ~0 by construction",
    }
    print("nmpc single:", json.dumps(results["nmpc_single_solve_h10"], indent=1), flush=True)

    # ------------------------------------------------------ (b) search_step B=1024
    rtrack = Track.load(os.path.join(repo, "data", "tracks", "buckmore.json"),
                        track_width=0.8)
    vehicle = load_vehicle(os.path.join(repo, "data", "vehicles", "tbr18.json"))
    B = 1024
    key = jax.random.PRNGKey(0)
    alphas = jax.random.uniform(key, (B, rtrack.size), rtrack.left.dtype)
    sigma = jnp.asarray(0.1, rtrack.left.dtype)
    mesh = pmesh.make_mesh(1, sp=1)

    def make_search(n):
        @jax.jit
        def run_inner():
            def body(i, carry):
                a, k = carry
                k, kr = jax.random.split(k)
                a, t, _ = pmesh.search_step(rtrack, vehicle, a, kr, sigma)
                return a, k
            return jax.lax.fori_loop(0, n, body, (alphas, key))

        def run():  # set_mesh must wrap the jit CALL, not live inside the trace
            with jax.set_mesh(mesh):
                return run_inner()
        return run

    slope, intercept = slope_time(make_search)
    with jax.set_mesh(mesh):
        one_s = jax.jit(lambda: pmesh.search_step(rtrack, vehicle, alphas, key, sigma)[1])
        ca = cost_analysis(one_s)
    flops = ca.get("flops")
    bts = ca.get("bytes_accessed")
    results["search_step_B1024"] = {
        "device_s_per_round": slope,
        "dispatch_intercept_s": intercept,
        "evals_per_s_in_program": B / slope,
        "cost_analysis": ca,
        "achieved_flops_per_s": (flops / slope) if flops else None,
        "achieved_hbm_bytes_per_s": (bts / slope) if bts else None,
        "pct_of_bf16_peak": (100 * flops / slope / PEAK_BF16_FLOPS) if flops else None,
        "pct_of_hbm_peak": (100 * bts / slope / PEAK_HBM_BPS) if bts else None,
    }
    print("search B=1024:", json.dumps(results["search_step_B1024"], indent=1), flush=True)

    # ---------------------------------------------------- (c) batched NMPC B=128
    Bn = 128
    cfg_b = cfg
    z0_b = jnp.tile(z0, (Bn, 1))
    us_b = jnp.zeros((Bn, cfg.horizon, 2), dtype)
    lam_b = jnp.zeros((Bn, cfg.horizon + 1, n_con(model)), dtype)

    def make_batch(n):
        @jax.jit
        def run():
            def body(_, carry):
                us, lam = carry
                r = S.solve_batch(model, p, cfg_b, z0_b, us, lam)
                return r.us, r.lam
            return jax.lax.fori_loop(0, n, body, (us_b, lam_b))
        return run

    slope, intercept = slope_time(make_batch)
    one_b = jax.jit(lambda: S.solve_batch(model, p, cfg_b, z0_b, us_b, lam_b).us)
    ca = cost_analysis(one_b)
    flops = ca.get("flops")
    bts = ca.get("bytes_accessed")
    results["nmpc_batch_B128"] = {
        "device_s_per_batch_solve": slope,
        "dispatch_intercept_s": intercept,
        "solves_per_s_in_program": Bn / slope,
        "cost_analysis": ca,
        "achieved_flops_per_s": (flops / slope) if flops else None,
        "achieved_hbm_bytes_per_s": (bts / slope) if bts else None,
        "pct_of_bf16_peak": (100 * flops / slope / PEAK_BF16_FLOPS) if flops else None,
        "pct_of_hbm_peak": (100 * bts / slope / PEAK_HBM_BPS) if bts else None,
    }
    print("nmpc batch B=128:", json.dumps(results["nmpc_batch_B128"], indent=1), flush=True)

    if args.trace:
        from lap_time_optimization.utils import profiling

        with profiling.trace(args.trace):
            jax.block_until_ready(make_solve(3)())
            with jax.set_mesh(mesh):
                jax.block_until_ready(make_search(3)())
            jax.block_until_ready(make_batch(3)())
        results["meta"]["trace_dir"] = args.trace

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
