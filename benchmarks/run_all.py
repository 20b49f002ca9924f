"""Full benchmark battery — one process, one device handle.

Produces benchmarks/results_<platform>.json with every headline measurement:
single-stream NMPC rates (h10/h20), batched throughput, a full-lap closed
loop, batched racing-line evaluation throughput (scan vs parallel),
and racing-line optimizer timings.

Run: python benchmarks/run_all.py            (the GPU if JAX finds one)
     JAX_PLATFORMS=cpu python benchmarks/run_all.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

import numpy as np


def bench(fn, *args, n=20, warmup=1):
    import jax

    for _ in range(warmup):
        r = fn(*args)
    jax.block_until_ready(r)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
    jax.block_until_ready(r)
    return (time.perf_counter() - t0) / n


def main():
    import jax
    import jax.numpy as jnp

    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.models.bicycle import BicycleModel
    from lap_time_optimization.mpc import runner
    from lap_time_optimization.mpc import track as mpc_track
    from lap_time_optimization.mpc.solver import OCPParams, SolverConfig
    from lap_time_optimization.ops import spline, velocity
    from lap_time_optimization.track import Track

    platform = jax.devices()[0].platform
    out = {"platform": platform, "device": str(jax.devices()[0])}
    print(f"[bench] platform {platform}", flush=True)

    # ---------------- NMPC ----------------
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=DATA)
    model = BicycleModel(vehicle=load_vehicle("MX5"), track=track)
    x0 = jnp.asarray(runner.X0_REFERENCE, jnp.float32)
    p = OCPParams.reference(jnp.float32)

    for N in (10, 20):
        cfg = SolverConfig.for_horizon(N)
        steps = 50
        dt = bench(lambda: runner.closed_loop(model, p, cfg, x0, steps), n=3)
        out[f"nmpc_h{N}_hz"] = round(steps / dt, 1)
        print(f"[bench] nmpc h{N}: {steps/dt:.1f} Hz", flush=True)

    cfg10 = SolverConfig.for_horizon(10)
    for B in (32, 128):
        x0b = jnp.tile(x0[None], (B, 1))
        steps = 10
        dt = bench(lambda: runner.closed_loop_batch(model, p, cfg10, x0b, steps), n=3)
        out[f"nmpc_batch{B}_solves_per_s"] = round(B * steps / dt, 0)
        print(f"[bench] nmpc batch B={B}: {B*steps/dt:.0f} solves/s", flush=True)

    # full lap (multi-lap wrap exercised): 900 steps x 0.1 s
    t0 = time.perf_counter()
    sim = runner.closed_loop(model, p, cfg10, x0, 900)
    sim.xs.block_until_ready()
    wall = time.perf_counter() - t0
    s_final = float(sim.xs[-1, 0])
    out["full_lap_progress_m"] = round(s_final, 1)
    out["full_lap_90s_sim_wall_s"] = round(wall, 2)
    out["full_lap_realtime_factor"] = round(90.0 / wall, 2)
    print(f"[bench] 90 s sim: progress {s_final:.1f} m in {wall:.1f} s wall", flush=True)

    # ---------------- batched velocity profiles ----------------
    rtrack = Track.load(os.path.join(DATA, "tracks", "buckmore.json"), track_width=0.99)
    veh = load_vehicle(os.path.join(DATA, "vehicles", "tbr18.json"))
    sp = rtrack.mid_spline()
    s = jnp.asarray(np.linspace(0, float(sp.length), rtrack.ns)[:-1], jnp.float32)
    k = spline.curvature(sp, s, signed=False).astype(jnp.float32)
    smax = float(sp.length)
    B = 1024
    kb = jnp.tile(k[None], (B, 1)) * jnp.linspace(0.8, 1.2, B, dtype=jnp.float32)[:, None]

    scan_fn = jax.jit(jax.vmap(lambda kk: velocity.solve_profile(veh, s, kk, smax, closed=True)))
    par_fn = jax.jit(jax.vmap(lambda kk: velocity.solve_profile_parallel(veh, s, kk, smax, closed=True)))
    for name, fn in [("scan", scan_fn), ("assoc_parallel", par_fn)]:
        dt = bench(fn, kb, n=10)
        out[f"velocity_batch1024_{name}_ms"] = round(dt * 1000, 2)
        print(f"[bench] velocity B=1024 {name}: {dt*1000:.2f} ms", flush=True)

    # ---------------- racing-line optimizer ----------------
    from lap_time_optimization.optim import racing_line

    dt = bench(lambda: racing_line.minimise_curvature(rtrack, max_iter=600).x, n=3)
    out["curvature_opt_s"] = round(dt, 2)
    print(f"[bench] curvature optimization: {dt:.2f} s", flush=True)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"results_{platform}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
