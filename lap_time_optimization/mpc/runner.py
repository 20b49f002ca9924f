"""Closed-loop NMPC driver: solver + plant fused into one on-device scan.

Replaces the reference's 500× Python loop of IPOPT `make_step` calls
(src/mpc.py:140-153, "a few hours of runtime for a few seconds of simulation"
per README.md:92).  Here controller and plant are the same XLA program: each
step warm-starts the AL-iLQR from the shifted previous solution, applies the
first input, and integrates the plant (plant == model, like the reference's
do_mpc simulator over the same ODE).  The entire simulation is a single
`lax.scan`, so a full 500-step run is one device launch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from lap_time_optimization.models.bicycle import NU, BicycleModel
from lap_time_optimization.mpc import solver as solver_mod
from lap_time_optimization.mpc.solver import OCPParams, SolverConfig, n_con
from lap_time_optimization.utils import checkpoint

#: Reference initial state [s, n, mu, vx, vy, r, steer, throttle]
#: (src/mpc.py:107-110)
X0_REFERENCE = np.array([0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.1])


class SimResult(NamedTuple):
    xs: jax.Array  # (steps+1, NX) states (x[0] = x0)
    us: jax.Array  # (steps+1, NU) applied inputs (u[0] = 0)
    costs: jax.Array  # (steps,) OCP cost per solve
    violations: jax.Array  # (steps,) max constraint violation per solve
    sdot: jax.Array  # (steps,) track progress rate per step


def _presolve(model, p, cfg, x0):
    """Burn in the t=0 warm start (do_mpc's set_initial_guess analogue,
    reference src/mpc.py:118) and return the initial scan carry."""
    dtype = x0.dtype
    N = cfg.horizon
    us_warm = jnp.zeros((N, NU), dtype)
    lam_warm = jnp.zeros((N + 1, n_con(model)), dtype)
    u_prev = jnp.zeros((NU,), dtype)
    z0_init = jnp.concatenate([x0, u_prev])
    for _ in range(2):
        warm = solver_mod.solve(model, p, cfg, z0_init, us_warm, lam_warm)
        us_warm, lam_warm = warm.us, warm.lam
    return (x0, us_warm, lam_warm, u_prev)


def _step_fn(model, p, cfg, carry, _):
    """One control cycle: solve, clip the applied input, integrate the plant,
    shift the warm start."""
    x, us_warm, lam_warm, u_prev = carry
    z0 = jnp.concatenate([x, u_prev])
    res = solver_mod.solve(model, p, cfg, z0, us_warm, lam_warm)
    # actuator saturation: the AL solver leaves O(1e-2) slack on the
    # input/actuator boxes at fixed iteration budgets; the physical
    # actuators (and the reference's hard NLP bounds,
    # src/mpc/controller.py:79-103) cannot exceed them, so the APPLIED
    # input is clipped to the rate limits AND so the (exactly
    # integrated) steer/throttle states stay inside their boxes.
    rate_lim = jnp.stack([p.dsteer_max, p.dthrottle_max])
    box = jnp.stack([p.steer_max, p.throttle_max])
    act = jnp.stack([x[6], x[7]])
    lo = jnp.maximum(-rate_lim, (-box - act) / cfg.dt)
    hi = jnp.minimum(rate_lim, (box - act) / cfg.dt)
    u0 = jnp.clip(res.us[0], lo, hi)
    x_next = model.step(x, u0, cfg.dt, substeps=cfg.substeps)
    # shift warm starts one stage forward
    us_next = jnp.concatenate([res.us[1:], res.us[-1:]], axis=0)
    lam_next = jnp.concatenate([res.lam[1:], res.lam[-1:]], axis=0)
    sdot = (x_next[0] - x[0]) / cfg.dt
    out = (x_next, u0, res.cost, res.max_violation, sdot)
    return (x_next, us_next, lam_next, u0), out


def _closed_loop_impl(model, p, cfg, x0, steps):
    dtype = x0.dtype
    carry0 = _presolve(model, p, cfg, x0)
    (_, _, _, _), (xs, us, costs, viols, sdots) = jax.lax.scan(
        partial(_step_fn, model, p, cfg), carry0, None, length=steps
    )
    xs_full = jnp.concatenate([x0[None], xs], axis=0)
    us_full = jnp.concatenate([jnp.zeros((1, NU), dtype), us], axis=0)
    return SimResult(xs=xs_full, us=us_full, costs=costs, violations=viols, sdot=sdots)


# Jitted closures with model/p embedded as COMPILE-TIME CONSTANTS, keyed by
# the identity of their array leaves (each entry keeps the arrays alive, so
# an id collision between live distinct arrays is impossible; eviction only
# costs a recompile).  As constants, XLA can fold the solver's table and
# operand preparation out of the scan; as traced jit arguments it cannot.
# Whether that still pays on the GPU is ROADMAP item A2.
_CONST_JIT_CACHE: dict = {}


def _const_jit(tag: str, build, model, p, cfg, steps: int):
    leaves = jax.tree_util.tree_leaves((model, p))
    if any(isinstance(l, jax.core.Tracer) for l in leaves):
        # traced model (e.g. under an outer transform): no host cache — the
        # closure inlines into the outer trace, which is the constant-folding
        # path anyway when the outer closure holds concrete arrays
        return build
    key = (tag, cfg, steps, tuple(id(l) for l in leaves))
    hit = _CONST_JIT_CACHE.get(key)
    if hit is None:
        if len(_CONST_JIT_CACHE) > 32:  # bound growth; eviction = recompile
            _CONST_JIT_CACHE.pop(next(iter(_CONST_JIT_CACHE)))
        hit = (jax.jit(build), (model, p))
        _CONST_JIT_CACHE[key] = hit
    return hit[0]


def closed_loop(
    model: BicycleModel,
    p: OCPParams,
    cfg: SolverConfig,
    x0: jax.Array,
    steps: int,
) -> SimResult:
    """Run `steps` control cycles from x0; everything stays on device.

    ONE device program: presolve + a `steps`-long scan of solve→clip→plant→
    shift.  model/p are baked in as compile-time constants (see
    `_const_jit`)."""
    fn = _const_jit(
        "single",
        lambda x0_: _closed_loop_impl(model, p, cfg, x0_, steps),
        model, p, cfg, steps,
    )
    return fn(x0)


def _run_chunk(model, p, cfg, carry, steps: int):
    fn = _const_jit(
        "chunk",
        lambda c: jax.lax.scan(partial(_step_fn, model, p, cfg), c, None,
                               length=steps),
        model, p, cfg, steps,
    )
    return fn(carry)


def _presolve_jit(model, p, cfg, x0):
    # const-jit like the drivers (NOT model/p-as-args): the chunked driver's
    # presolve must constant-fold exactly like the single-scan program's
    # inlined presolve, or the bit-identical-trajectory guarantee breaks
    fn = _const_jit("presolve", lambda x0_: _presolve(model, p, cfg, x0_),
                    model, p, cfg, 0)
    return fn(x0)


def _sim_fingerprint(model, p, cfg, x0) -> str:
    """Digest of everything that determines a chunked simulation's trajectory
    besides (steps, chunk): model/track/OCP parameter leaves, the full solver
    config, and x0.  Stored in the checkpoint so a file written under a
    different configuration at the same path is ignored instead of silently
    spliced into this run (ADVICE r3)."""
    import hashlib

    h = hashlib.sha256()
    h.update(repr(cfg).encode())
    for leaf in jax.tree_util.tree_leaves((model, p)):
        a = np.asarray(leaf)
        h.update(str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    h.update(np.asarray(x0).tobytes())
    return h.hexdigest()


def closed_loop_chunked(
    model: BicycleModel,
    p: OCPParams,
    cfg: SolverConfig,
    x0: jax.Array,
    steps: int,
    chunk: int = 100,
    checkpoint_path: str | None = None,
) -> SimResult:
    """`closed_loop` split into fixed-size device programs: the warm-start
    carry crosses chunk boundaries on device, so the trajectory is IDENTICAL
    to the single-scan version (tested bit-for-bit) while compile time stays
    constant in `steps` — one `chunk`-step program compiled once, reused for
    laps of any length.  Use this for long simulations, where one
    chunk-sized program bounds compile time and gives checkpoint points.

    `checkpoint_path`: persist the full simulation state (warm-start
    inputs/multipliers, plant state, per-step outputs) after every chunk;
    an interrupted run restarted with the same arguments resumes at the
    last completed chunk and produces the identical trajectory (the carry
    crosses the save/load boundary exactly — tested in tests/test_mpc.py).
    """
    dtype = x0.dtype
    if steps <= 0:
        return SimResult(
            xs=x0[None], us=jnp.zeros((1, NU), dtype),
            costs=jnp.zeros((0,), dtype), violations=jnp.zeros((0,), dtype),
            sdot=jnp.zeros((0,), dtype),
        )
    xs_l, us_l, costs_l, viols_l, sdots_l = [], [], [], [], []
    done = 0
    carry = None
    fingerprint = (
        _sim_fingerprint(model, p, cfg, x0) if checkpoint_path is not None else ""
    )
    if checkpoint_path is not None and checkpoint.exists(checkpoint_path):
        state = checkpoint.load(checkpoint_path)
        if (
            int(state["steps"]) == steps
            and int(state["chunk"]) == chunk
            and np.array_equal(state["x0"], np.asarray(x0))
            and str(state.get("fingerprint", "")) == fingerprint
        ):
            done = int(state["done"])
            carry = tuple(
                jnp.asarray(state[f"carry{i}"], dtype) for i in range(4)
            )
            if done:
                xs_l = [jnp.asarray(state["xs"], dtype)]
                us_l = [jnp.asarray(state["us"], dtype)]
                costs_l = [jnp.asarray(state["costs"], dtype)]
                viols_l = [jnp.asarray(state["violations"], dtype)]
                sdots_l = [jnp.asarray(state["sdot"], dtype)]
    if carry is None:
        carry = _presolve_jit(model, p, cfg, x0)
    while done < steps:
        n = min(chunk, steps - done)
        # constant program shape: always run `chunk` steps, discard the tail
        # of the final partial chunk on host
        carry_next, (xs, us, costs, viols, sdots) = _run_chunk(model, p, cfg, carry, chunk)
        if n < chunk:
            xs, us, costs, viols, sdots = (
                a[:n] for a in (xs, us, costs, viols, sdots)
            )
        else:
            carry = carry_next
        xs_l.append(xs); us_l.append(us); costs_l.append(costs)
        viols_l.append(viols); sdots_l.append(sdots)
        done += n
        if checkpoint_path is not None and done < steps:
            checkpoint.save(
                checkpoint_path,
                steps=steps, chunk=chunk, done=done, x0=np.asarray(x0),
                fingerprint=fingerprint,
                xs=np.concatenate([np.asarray(a) for a in xs_l]),
                us=np.concatenate([np.asarray(a) for a in us_l]),
                costs=np.concatenate([np.asarray(a) for a in costs_l]),
                violations=np.concatenate([np.asarray(a) for a in viols_l]),
                sdot=np.concatenate([np.asarray(a) for a in sdots_l]),
                **{f"carry{i}": np.asarray(c) for i, c in enumerate(carry)},
            )
    cat = lambda parts: jnp.concatenate(parts, axis=0)
    xs_full = jnp.concatenate([x0[None], cat(xs_l)], axis=0)
    us_full = jnp.concatenate([jnp.zeros((1, NU), dtype), cat(us_l)], axis=0)
    return SimResult(
        xs=xs_full, us=us_full,
        costs=cat(costs_l), violations=cat(viols_l), sdot=cat(sdots_l),
    )


def _presolve_batch(model, p, cfg, x0_b):
    """Batched t=0 warm-start burn-in (see `_presolve`)."""
    dtype = x0_b.dtype
    Bt = x0_b.shape[0]
    N = cfg.horizon
    us_warm = jnp.zeros((Bt, N, NU), dtype)
    lam_warm = jnp.zeros((Bt, N + 1, n_con(model)), dtype)
    u_prev = jnp.zeros((Bt, NU), dtype)
    z0_b = jnp.concatenate([x0_b, u_prev], axis=1)
    for _ in range(2):
        warm = solver_mod.solve_batch(model, p, cfg, z0_b, us_warm, lam_warm)
        us_warm, lam_warm = warm.us, warm.lam
    return (x0_b, us_warm, lam_warm, u_prev)


def _step_fn_batch(model, p, cfg, carry, _):
    """Batched control cycle (see `_step_fn`): one solve_batch + vmapped
    plant integration; per-instance input clipping is elementwise."""
    x_b, us_warm, lam_warm, u_prev_b = carry
    z0_b = jnp.concatenate([x_b, u_prev_b], axis=1)
    res = solver_mod.solve_batch(model, p, cfg, z0_b, us_warm, lam_warm)
    rate_lim = jnp.stack([p.dsteer_max, p.dthrottle_max])
    box = jnp.stack([p.steer_max, p.throttle_max])
    act = x_b[:, 6:8]
    lo = jnp.maximum(-rate_lim, (-box - act) / cfg.dt)
    hi = jnp.minimum(rate_lim, (box - act) / cfg.dt)
    u0_b = jnp.clip(res.us[:, 0], lo, hi)
    x_next = jax.vmap(lambda x, u: model.step(x, u, cfg.dt, substeps=cfg.substeps))(
        x_b, u0_b
    )
    us_next = jnp.concatenate([res.us[:, 1:], res.us[:, -1:]], axis=1)
    lam_next = jnp.concatenate([res.lam[:, 1:], res.lam[:, -1:]], axis=1)
    sdot = (x_next[:, 0] - x_b[:, 0]) / cfg.dt
    out = (x_next, u0_b, res.cost, res.max_violation, sdot)
    return (x_next, us_next, lam_next, u0_b), out


def closed_loop_batch(
    model: BicycleModel,
    p: OCPParams,
    cfg: SolverConfig,
    x0_batch: jax.Array,
    steps: int,
) -> SimResult:
    """Fleet of independent closed loops (B, ...) on ONE chip: B cars /
    scenarios / parameter variations simulated simultaneously.  Throughput
    scales with B until the chip saturates, amortizing the per-step
    dispatch latency that bounds the single-stream rate.  For a multi-chip
    fleet use `closed_loop_fleet`.

    The whole simulation is one scan whose body solves ALL B OCPs at once
    via `solver.solve_batch`: on the kernel backend the serial
    Riccati/line-search chains of all B instances run in one launch of the
    fused kernel (one program per instance); on the XLA backend
    solve_batch IS vmap(solve)."""
    fn = _const_jit(
        "batch",
        lambda x0b: _closed_loop_batch_impl(model, p, cfg, x0b, steps),
        model, p, cfg, steps,
    )
    return fn(x0_batch)


def _closed_loop_batch_impl(
    model: BicycleModel,
    p: OCPParams,
    cfg: SolverConfig,
    x0_batch: jax.Array,
    steps: int,
) -> SimResult:
    dtype = x0_batch.dtype
    Bt = x0_batch.shape[0]
    carry0 = _presolve_batch(model, p, cfg, x0_batch)
    _, (xs, us, costs, viols, sdots) = jax.lax.scan(
        partial(_step_fn_batch, model, p, cfg), carry0, None, length=steps
    )
    # (steps, B, ...) -> (B, steps, ...) to match vmap(closed_loop) layout
    xs = jnp.swapaxes(xs, 0, 1)
    us = jnp.swapaxes(us, 0, 1)
    xs_full = jnp.concatenate([x0_batch[:, None], xs], axis=1)
    us_full = jnp.concatenate([jnp.zeros((Bt, 1, NU), dtype), us], axis=1)
    return SimResult(
        xs=xs_full,
        us=us_full,
        costs=jnp.swapaxes(costs, 0, 1),
        violations=jnp.swapaxes(viols, 0, 1),
        sdot=jnp.swapaxes(sdots, 0, 1),
    )


def closed_loop_fleet(
    model: BicycleModel,
    p: OCPParams,
    cfg: SolverConfig,
    x0_batch: jax.Array,
    steps: int,
    mesh,
) -> SimResult:
    """Mesh-sharded fleet: the batch axis splits over the mesh's 'dp' axis
    via `shard_map`, each device running `closed_loop_batch` on its local
    slice of initial states.  The loops are independent (no cross-device
    collectives in the steady state), so scaling is linear in mesh size —
    this is the multi-chip serving path replacing the reference's
    one-IPOPT-process-per-simulation workflow (src/mpc.py:140-153).

    A batch that does not divide mesh.shape['dp'] is padded by repeating the
    last initial state (a real fleet size is rarely a mesh multiple); the
    padded instances run as ordinary loop copies and their rows are dropped
    before returning, so results for the real instances are bit-identical to
    `closed_loop_batch` on one device (tested on the virtual 8-device CPU
    mesh, tests/test_parallel.py)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    dp = mesh.shape["dp"]
    b = x0_batch.shape[0]
    pad = (-b) % dp
    if pad:
        x0_batch = jnp.concatenate(
            [x0_batch, jnp.repeat(x0_batch[-1:], pad, axis=0)], axis=0
        )

    # model/p ride in as closed-over constants → replicated to every device;
    # only the initial-state batch is sharded.
    fleet = jax.shard_map(
        lambda xb: closed_loop_batch(model, p, cfg, xb, steps),
        mesh=mesh,
        in_specs=P("dp"),
        out_specs=P("dp"),
        check_vma=False,
    )
    x0_batch = jax.device_put(x0_batch, NamedSharding(mesh, P("dp")))
    with jax.set_mesh(mesh):
        res = jax.jit(fleet)(x0_batch)
    if pad:
        res = SimResult(*(a[:b] for a in res))
    return res


def applied_violation(model: BicycleModel, p: OCPParams, result: SimResult) -> float:
    """Max constraint violation of the APPLIED closed-loop states/inputs
    against the TRUE (margin-0) band.

    `SimResult.violations` holds the per-solve max over the *predicted*
    horizon trajectories, whose tail stages carry the fixed-iteration AL
    solver's transient slack; the tightening margin (`p.lateral_margin`)
    exists so the states the plant actually visits stay feasible.  This is
    the number that certifies it (gated < 1e-2 in tests/test_mpc.py,
    tests/test_gpu_smoke.py and chip_smoke.py).  A batched result (leading
    batch axis, as from `closed_loop_batch`) gives the max over all loops."""
    from lap_time_optimization.mpc.solver import constraints

    xs = result.xs[..., 1:, :].reshape(-1, result.xs.shape[-1])
    us = result.us[..., 1:, :].reshape(-1, NU)
    g = jax.vmap(
        lambda x, u: constraints(
            model, p, jnp.concatenate([x, jnp.zeros(NU, x.dtype)]), u
        )
    )(xs, us)
    return float(jnp.max(g))


def tire_logs(model: BicycleModel, xs: jax.Array):
    """Per-step slip angles and lateral forces (reference src/mpc.py:148-151)."""

    def one(x):
        af, ar = model.slip_angles(x[3], x[4], x[5], x[6])
        fyf, fyr = model.lateral_forces(af, ar)
        return jnp.stack([af, ar]), jnp.stack([fyf, fyr])

    alphas, fys = jax.vmap(one)(xs)
    return alphas, fys


def to_sim_results(model: BicycleModel, result: SimResult) -> dict:
    """Serialize with the reference `sim_results.json` schema
    (src/mpc.py:156-159): x/y of shape (steps+1, 8, 1), u (steps+1, 2, 1),
    Fy and alpha (steps+1, 2).  y == x (state-feedback estimator,
    src/mpc.py:119)."""
    xs = np.asarray(result.xs, dtype=np.float64)
    us = np.asarray(result.us, dtype=np.float64)
    alphas, fys = tire_logs(model, result.xs)
    alphas = np.array(alphas, dtype=np.float64)  # copy: jax buffers are read-only
    fys = np.array(fys, dtype=np.float64)
    # zero the t=0 log rows like the reference (src/mpc.py:134-135)
    alphas[0] = 0.0
    fys[0] = 0.0
    x_col = xs[:, :, None]
    u_col = us[:, :, None]
    return {
        "x": x_col.tolist(),
        "y": x_col.tolist(),
        "u": u_col.tolist(),
        "Fy": fys.tolist(),
        "alpha": alphas.tolist(),
    }
