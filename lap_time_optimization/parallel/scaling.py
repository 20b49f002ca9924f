"""Scaling-efficiency harness: batched-search throughput vs device count.

BASELINE.md deliverable: ≥80% scaling efficiency for batched racing-line
search when adding devices/hosts.  This harness times the same sharded
`search_step` on 1, 2, …, K-device meshes and reports throughput
(candidate-evaluations/s) and efficiency relative to linear scaling.

On the CI host this runs on the virtual 8-device CPU mesh; on hardware it
measures real chips.  Multi-host runs use the identical code path after
`parallel.distributed.initialize()` — the mesh just spans hosts.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from lap_time_optimization.parallel import mesh as pmesh


def measure(
    track,
    vehicle,
    device_counts=(1, 2, 4, 8),
    batch_per_device: int = 64,
    rounds: int = 3,
    seed: int = 0,
) -> dict:
    """Return {n_devices: {"evals_per_s", "efficiency"}} for weak scaling.

    Weak scaling: the batch grows with the device count (the production
    regime — more chips search more candidates), so perfect scaling keeps
    time/round constant.
    """
    avail = len(jax.devices())
    results = {}
    base_rate = None
    for nd in device_counts:
        if nd > avail:
            continue
        mesh = pmesh.make_mesh(nd, sp=1)
        B = batch_per_device * nd
        key = jax.random.PRNGKey(seed)
        alphas = jax.random.uniform(key, (B, track.size), track.left.dtype)
        sigma = jnp.asarray(0.1, track.left.dtype)
        with jax.set_mesh(mesh):
            a = pmesh.shard_batch(mesh, alphas)
            # warmup / compile
            a, t_best, _ = pmesh.search_step(track, vehicle, a, key, sigma)
            t_best.block_until_ready()
            t0 = time.perf_counter()
            for i in range(rounds):
                key, kr = jax.random.split(key)
                a, t_best, _ = pmesh.search_step(track, vehicle, a, kr, sigma)
            t_best.block_until_ready()
            dt = (time.perf_counter() - t0) / rounds
        rate = B / dt
        if base_rate is None:
            base_rate = rate / nd  # per-device baseline from the first entry
        results[nd] = {
            "evals_per_s": rate,
            "sec_per_round": dt,
            "efficiency": rate / (base_rate * nd),
        }
    return results


def report(results: dict) -> str:
    lines = ["devices  evals/s   sec/round  efficiency"]
    for nd, r in sorted(results.items()):
        lines.append(
            f"{nd:7d}  {r['evals_per_s']:8.1f}  {r['sec_per_round']:9.4f}  {r['efficiency']:.2%}"
        )
    return "\n".join(lines)
