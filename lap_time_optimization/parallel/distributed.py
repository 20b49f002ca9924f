"""Multi-host initialization and mesh construction.

The reference has no distributed backend at all (SURVEY.md §5 — its only
parallelism is a single-host multiprocessing.Pool).  Here multi-host runs are
first-class: initialize the JAX distributed runtime, build a global
('dp', 'sp') mesh spanning all hosts, and reuse the exact same sharded search
code (`parallel.mesh`) — per-host process boundaries are invisible to the
program, XLA routes dp collectives over ICI within a slice and DCN across
slices.

Coverage: the single-process no-op path is exercised by tests/test_parallel.py;
the multi-PROCESS path runs for real in tests/test_distributed.py — two OS
processes (4 virtual CPU devices each) join through
`jax.distributed.initialize` into one 8-device global mesh, and the
sp-sharded velocity solver's ppermute/all_gather collectives cross the
process boundary every sweep.  That is the same runtime path two hosts
take over the network; what a CPU test cannot exercise is only the
physical transport.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed when running multi-process.

    No-ops when single-process (the common CI / 1-host case).  Arguments
    default to the standard JAX env vars (JAX_COORDINATOR_ADDRESS etc.) or
    cluster auto-detection.
    """
    num = num_processes if num_processes is not None else int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1 and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(sp: int = 1) -> Mesh:
    """('dp', 'sp') mesh over all global devices (all hosts)."""
    devs = np.asarray(jax.devices())
    n = len(devs)
    sp = sp if sp > 0 and n % sp == 0 else 1
    return Mesh(devs.reshape(n // sp, sp), axis_names=("dp", "sp"))
