"""Record scaling evidence for the batched racing-line search.

Two artifacts (BASELINE.md "≥80% scaling efficiency" row):
* `scaling_cpu_virtual8.json` — weak scaling over a 1/2/4/8-device virtual
  CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8). This
  validates the SHARDING (same code path as real multi-chip; collectives
  and partitioning are real, the devices share host cores so efficiency
  numbers are a lower bound on communication overhead, not compute scaling).
* `scaling_device.json` — one-device throughput anchor vs batch size on
  the accelerator JAX finds; the per-device rate a mesh would multiply.
* `nmpc_batch_curve.json` — batched closed-loop NMPC solves/s vs batch
  size, fused kernel vs the XLA path, on that device.

Usage:
  python benchmarks/run_scaling.py --mode cpu
  python benchmarks/run_scaling.py --mode device
  python benchmarks/run_scaling.py --mode device-nmpc
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT_DIR = os.path.dirname(os.path.abspath(__file__))


def load_stack():
    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.track import Track

    repo = os.path.dirname(OUT_DIR)
    track = Track.load(os.path.join(repo, "data", "tracks", "buckmore.json"), track_width=0.8)
    vehicle = load_vehicle(os.path.join(repo, "data", "vehicles", "tbr18.json"))
    return track, vehicle


def run_cpu():
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from lap_time_optimization.parallel import scaling

    track, vehicle = load_stack()
    results = scaling.measure(track, vehicle, device_counts=(1, 2, 4, 8), batch_per_device=64)
    print(scaling.report(results))
    out = os.path.join(OUT_DIR, "scaling_cpu_virtual8.json")
    with open(out, "w") as f:
        json.dump(
            dict(
                mode="weak-scaling, virtual 8-device CPU mesh (sharding validation)",
                batch_per_device=64,
                results={str(k): v for k, v in results.items()},
            ),
            f,
            indent=2,
        )
    print("wrote", out)


def _device_meta():
    import jax

    d = jax.devices()[0]
    if d.platform == "cpu":
        raise SystemExit("--mode device measures an accelerator; JAX found only the CPU")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def run_device(batches=(64, 256, 1024, 4096, 8192, 16384)):
    """One-device `search_step` throughput vs batch size, per solver.

    "scan" (the sp-shardable sequential 3-pass) runs ~860 sequential
    velocity steps per program regardless of B; "assoc" (log-depth) removes
    that serial chain.  The curve's knee is the per-device rate a mesh would
    multiply."""
    import jax
    import jax.numpy as jnp

    from lap_time_optimization.parallel import mesh as pmesh

    meta = _device_meta()
    track, vehicle = load_stack()
    mesh = pmesh.make_mesh(1, sp=1)
    rows = {}
    for solver in ("assoc", "scan"):
        srows = rows[solver] = {}
        for B in batches:
            if solver == "scan" and B > 4096:
                continue  # latency-bound: no knee, just longer programs
            key = jax.random.PRNGKey(0)
            alphas = jax.random.uniform(key, (B, track.size), track.left.dtype)
            sigma = jnp.asarray(0.1, track.left.dtype)
            with jax.set_mesh(mesh):
                a = pmesh.shard_batch(mesh, alphas)
                a, t_best, _ = pmesh.search_step(track, vehicle, a, key, sigma,
                                                 solver=solver)
                _ = float(t_best)  # compile + warm up; readback syncs
                dt = float("inf")
                for _i in range(5):
                    key, kr = jax.random.split(key)
                    t0 = time.perf_counter()
                    a, t_best, _ = pmesh.search_step(track, vehicle, a, kr, sigma,
                                                     solver=solver)
                    _ = float(t_best)
                    dt = min(dt, time.perf_counter() - t0)
            srows[str(B)] = dict(evals_per_s=B / dt, sec_per_round=dt)
            print(f"{solver:6s} B={B}: {B/dt:.0f} evals/s ({dt*1e3:.1f} ms/round)",
                  flush=True)
    out = os.path.join(OUT_DIR, "scaling_device.json")
    with open(out, "w") as f:
        json.dump(
            dict(mode="one-device throughput anchor, per solver", device=meta, results=rows),
            f,
            indent=2,
        )
    print("wrote", out)


def run_device_nmpc(batches=(32, 128, 512, 1024), steps=100):
    """Batched closed-loop NMPC solves/s vs batch size, fused kernel vs the
    XLA path; `steps` is the scan depth per device program."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.models.bicycle import BicycleModel
    from lap_time_optimization.mpc import runner
    from lap_time_optimization.mpc import track as mpc_track
    from lap_time_optimization.mpc.solver import OCPParams, SolverConfig

    repo = os.path.dirname(OUT_DIR)
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=os.path.join(repo, "data"))
    model = BicycleModel(vehicle=load_vehicle("MX5"), track=track)
    x0 = jnp.asarray(runner.X0_REFERENCE, jnp.float32)
    p = OCPParams.reference(jnp.float32, lateral_margin=0.05)
    meta = _device_meta()

    rows = {}
    for B in batches:
        x0b = jnp.tile(x0[None], (B, 1)).at[:, 3].add(jnp.linspace(-1.0, 1.0, B, dtype=x0.dtype))
        rows[B] = {}
        for backend in ("pallas", "xla"):
            cfg = SolverConfig(horizon=10, backend=backend)
            sim = runner.closed_loop_batch(model, p, cfg, x0b, steps)
            np.asarray(sim.xs)  # compile + warm up; readback syncs
            dt = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                sim = runner.closed_loop_batch(model, p, cfg, x0b, steps)
                np.asarray(sim.xs)
                dt = min(dt, time.perf_counter() - t0)
            rows[B][backend] = dict(
                solves_per_s=round(B * steps / dt, 1), wall_s=round(dt, 3), steps=steps,
            )
            print(f"B={B} {backend}: {B*steps/dt:.0f} solves/s", flush=True)
    out = os.path.join(OUT_DIR, "nmpc_batch_curve.json")
    with open(out, "w") as f:
        json.dump(
            dict(
                mode="batched closed-loop NMPC solves/s vs batch size",
                device=meta, horizon=10, steps_per_run=steps,
                note="best-of-3 with readback sync",
                results={str(k): v for k, v in rows.items()},
            ),
            f,
            indent=2,
        )
    print("wrote", out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("cpu", "device", "device-nmpc"), required=True)
    mode = ap.parse_args().mode
    if mode == "cpu":
        run_cpu()
    elif mode == "device":
        run_device()
    else:
        run_device_nmpc()
