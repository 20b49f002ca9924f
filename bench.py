"""Headline benchmark: closed-loop NMPC solve rate on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

The baseline is BASELINE.md's target of 50 Hz closed-loop solve rate (the
reference's do_mpc/IPOPT loop runs at ~0.03 Hz — "a few hours of runtime
for a few seconds of simulation", reference README.md:92); vs_baseline is
reported against the 50 Hz target.  ROADMAP item A0 redefines the metric.

Context lines (stderr): the device and card, feasibility of the applied
states, and the batched fleet's solves/s.  Fails without a GPU.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

TARGET_HZ = 50.0  # BASELINE.md north star


def main():
    import jax
    import jax.numpy as jnp

    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.models.bicycle import BicycleModel
    from lap_time_optimization.mpc import runner
    from lap_time_optimization.mpc import track as mpc_track
    from lap_time_optimization.mpc.solver import OCPParams, SolverConfig

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's first device is {devs[0].platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs), "card": card}
    print(f"[bench] device: {device}", file=sys.stderr)

    repo_data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=repo_data)
    model = BicycleModel(vehicle=load_vehicle("MX5"), track=track)
    x0 = jnp.asarray(runner.X0_REFERENCE, jnp.float32)
    p = OCPParams.reference(jnp.float32, lateral_margin=0.05)
    cfg = SolverConfig(horizon=10)  # backend="auto": the fused kernel on a GPU

    # the reference's full default simulation (src/mpc.py:126), one program
    steps = int(os.environ.get("LTO_BENCH_STEPS", "500"))
    sim = runner.closed_loop(model, p, cfg, x0, steps)  # compile + warm up
    sim.xs.block_until_ready()
    t0 = time.time()
    sim = runner.closed_loop(model, p, cfg, x0, steps)
    sim.xs.block_until_ready()
    wall = time.time() - t0
    hz = steps / wall

    xs = np.asarray(sim.xs)
    # the predicted-horizon tails may carry transient AL slack beyond the
    # 5 cm tightening margin; the margin certifies the APPLIED states, so
    # report both and fail if the applied states leave the true band
    applied_viol = runner.applied_violation(model, p, sim)
    print(
        f"[bench] {steps} closed-loop steps in {wall:.2f}s; progress "
        f"{xs[-1,0]:.1f} m, max predicted-horizon violation "
        f"{float(np.max(np.asarray(sim.violations))):.4f}, "
        f"max APPLIED-state violation {applied_viol:.4f} (true band)",
        file=sys.stderr,
    )
    assert applied_viol < 1e-2, (
        f"applied-state violation {applied_viol} breaches the 1e-2 gate"
    )

    # batched fleet: B parallel loops from the start state with speeds
    # fanned over ±1 m/s (perturbing every state component instead sends
    # some loops out of the band)
    B = int(os.environ.get("LTO_BENCH_BATCH", "32"))
    bsteps = max(10, steps // 5)
    x0b = jnp.tile(x0[None], (B, 1)).at[:, 3].add(jnp.linspace(-1.0, 1.0, B, dtype=x0.dtype))
    simb = runner.closed_loop_batch(model, p, cfg, x0b, bsteps)
    simb.xs.block_until_ready()
    t0 = time.time()
    simb = runner.closed_loop_batch(model, p, cfg, x0b, bsteps)
    simb.xs.block_until_ready()
    bwall = time.time() - t0
    fleet_viol = runner.applied_violation(model, p, simb)
    print(
        f"[bench] batched throughput: {B} loops x {bsteps} steps in "
        f"{bwall:.2f}s = {B * bsteps / bwall:.0f} solves/s; max APPLIED-state "
        f"violation {fleet_viol:.4f}",
        file=sys.stderr,
    )
    assert fleet_viol < 1e-2, (
        f"fleet applied-state violation {fleet_viol} breaches the 1e-2 gate"
    )
    print(
        json.dumps(
            {
                "metric": "nmpc_closed_loop_solve_rate",
                "value": round(hz, 2),
                "unit": "Hz",
                "vs_baseline": round(hz / TARGET_HZ, 3),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
