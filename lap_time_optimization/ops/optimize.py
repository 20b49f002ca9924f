"""Jittable bounded minimization (the scipy.optimize replacement).

The reference drives every racing-line method through scipy's L-BFGS-B with
*finite-difference* gradients (src/trajectory.py:68-74,90-96,139-145): each
L-BFGS iteration costs O(n_ctrl)≈132 extra spline refits.  Here the pipeline
is differentiable, so we run optax's L-BFGS (two-loop recursion + zoom
linesearch) with analytic `jax.grad` — one objective + one gradient evaluation
per iteration, all inside a single compiled `lax.while_loop`.

Box constraints [lo, hi] are handled by a smooth sigmoid reparameterization,
which keeps the iterates strictly feasible and the problem unconstrained (the
optimum saturates asymptotically at the bounds, where the reference's active
constraints sit).  The whole minimizer is vmappable, which is what enables
batched multi-start / per-sector / per-epsilon sweeps on one chip.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

# L-BFGS inner products in full f32 (a GPU may run f32 dots in TF32)
_HIGHEST = jax.lax.Precision.HIGHEST


class MinimizeResult(NamedTuple):
    x: jax.Array
    fun: jax.Array
    n_iter: jax.Array
    grad_norm: jax.Array


def _logit(p):
    return jnp.log(p) - jnp.log1p(-p)


def bounded_transform(lo, hi):
    """Return (to_params, to_theta) maps for the box [lo, hi]."""

    def to_params(theta):
        return lo + (hi - lo) * jax.nn.sigmoid(theta)

    def to_theta(x):
        p = jnp.clip((x - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
        return _logit(p)

    return to_params, to_theta


def lbfgs_stepper(
    fun: Callable[[jax.Array], jax.Array],
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
):
    """Resumable L-BFGS: returns `(init, run)` where `run(carry, n_steps)`
    advances at most `n_steps` iterations (bounded `lax.while_loop`) and can be
    called repeatedly — running k then m steps is step-for-step identical to
    running k+m in one program.

    Why segments exist: data-dependent linesearch trip counts make a full
    to-convergence `while_loop` unboundedly long; host-dispatched segments
    keep every program short and give the host checkpoint / heartbeat
    points between segments.  Whether one `while_loop` is better on the GPU
    is ROADMAP item A5.
    """
    opt = optax.lbfgs(memory_size=memory_size)
    value_and_grad = optax.value_and_grad_from_state(fun)

    def init(x0):
        return (x0, opt.init(x0), jnp.asarray(0), jnp.asarray(jnp.inf, x0.dtype))

    def run(carry, n_steps: int):
        stop_at = jnp.minimum(carry[2] + n_steps, max_iter)

        def cond(c):
            _, _, it, gnorm = c
            return (it < stop_at) & (gnorm > tol)

        def body(c):
            params, state, it, _ = c
            value, grad = value_and_grad(params, state=state)
            updates, state = opt.update(grad, state, params, value=value, grad=grad, value_fn=fun)
            params = optax.apply_updates(params, updates)
            return params, state, it + 1, jnp.linalg.norm(grad)

        return jax.lax.while_loop(cond, body, carry)

    return init, run


def _two_loop(grad, mem_s, mem_y, mem_rho, count, gamma):
    """Classic L-BFGS two-loop recursion over a rolling (m, d) buffer.

    `mem_rho[j] = 1/(s_jᵀy_j)` with 0 marking empty or cautious-skipped slots
    (their terms vanish identically, so slot order among invalid entries is
    irrelevant).  Iterates most-recent→oldest backward, oldest→most-recent
    forward, via offsets from the rolling write index."""
    m = mem_rho.shape[0]

    def bwd(i, carry):
        q, alpha = carry
        j = (count - 1 - i) % m  # most recent first
        a = mem_rho[j] * jnp.dot(mem_s[j], q, precision=_HIGHEST)
        return q - a * mem_y[j], alpha.at[j].set(a)

    q, alpha = jax.lax.fori_loop(
        0, m, bwd, (grad, jnp.zeros(m, grad.dtype))
    )
    r = gamma * q

    def fwd(i, r):
        j = (count - m + i) % m  # oldest first
        b = mem_rho[j] * jnp.dot(mem_y[j], r, precision=_HIGHEST)
        return r + (alpha[j] - b) * mem_s[j]

    return jax.lax.fori_loop(0, m, fwd, r)


def lbfgs_ladder_stepper(
    fun: Callable[[jax.Array], jax.Array],
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
    n_rungs: int = 13,
    armijo_c: float = 1e-4,
):
    """L-BFGS with a *batched best-of-ladder* line search.

    Why this exists: optax's zoom linesearch probes step sizes SEQUENTIALLY —
    about 15 serial pipeline evaluations per L-BFGS iteration on the
    global-search polish, against one value+grad.  On a batched accelerator
    the right shape
    is to evaluate ALL candidate steps at once: one vmapped objective batch
    over a geometric ladder η ∈ {2, 1, ½, …, 2^{2-L}} costs roughly the same
    latency as ONE evaluation (the assoc velocity solver's depth is
    batch-independent), so each iteration is ~2 evaluation-latencies total:
    one value+grad at x, one (L,)-batched value sweep of x + η·d.

    Acceptance: the best-decrease rung satisfying Armijo
    f(x+ηd) ≤ f(x) + c·η·∇fᵀd; if none qualifies, the best strictly-improving
    rung.  The ladder is *self-centering*: on acceptance the window re-centers
    around the accepted step (so the next iteration's rungs bracket the
    objective's current natural step size, extending effective resolution far
    beyond `n_rungs`); on rejection the whole window shifts down by its span
    and the iteration retries — the iterate freezes (grad_norm forced to 0 so
    segment hosts observe convergence) only once the center underflows ~1e-12,
    i.e. repeated rejections at ever-finer scales found no descent.  The
    curvature (Wolfe-2) condition is NOT enforced per-step; instead the
    memory update is *cautious*: a pair with sᵀy ≤ 1e-10·|s||y| is skipped
    (ρ=0), which keeps the inverse-Hessian approximation PSD — the standard
    safeguard when pairing L-BFGS with non-Wolfe searches.  A non-descent
    direction (∇fᵀd ≥ 0, possible right after skipped pairs) falls back to
    steepest descent scaled by γ.

    Same `(init, run)` segment contract as `lbfgs_stepper` (the ~60 s device
    program deadline applies equally — see that docstring).
    """
    ladder = 2.0 ** (1.0 - jnp.arange(n_rungs))  # 2, 1, 1/2, ..., 2^(2-L)
    span = 2.0 ** (n_rungs - 2)  # top-rung / bottom-rung ratio

    def init(x0):
        d = x0.shape[-1]
        dtype = x0.dtype
        mem = dict(
            s=jnp.zeros((memory_size, d), dtype),
            y=jnp.zeros((memory_size, d), dtype),
            rho=jnp.zeros(memory_size, dtype),
            gamma=jnp.asarray(1.0, dtype),
            count=jnp.asarray(0),
            center=jnp.asarray(1.0, dtype),  # self-centering ladder scale
        )
        f0, g0 = jax.value_and_grad(fun)(x0)
        return (x0, mem, jnp.asarray(0), jnp.linalg.norm(g0), f0, g0)

    def run(carry, n_steps: int):
        stop_at = jnp.minimum(carry[2] + n_steps, max_iter)

        def cond(c):
            _, _, it, gnorm, _, _ = c
            return (it < stop_at) & (gnorm > tol)

        def body(c):
            x, mem, it, _, f, g = c
            dtype = x.dtype
            direction = -_two_loop(g, mem["s"], mem["y"], mem["rho"],
                                   mem["count"], mem["gamma"])
            slope = jnp.dot(g, direction, precision=_HIGHEST)
            # fall back to scaled steepest descent on a non-descent direction
            bad = slope >= 0.0
            direction = jnp.where(bad, -mem["gamma"] * g, direction)
            slope = jnp.where(bad, -mem["gamma"] * jnp.dot(g, g, precision=_HIGHEST), slope)
            # first iteration: trust-region the unit ball like optax does
            first = mem["count"] == 0
            dn = jnp.linalg.norm(direction)
            scale0 = jnp.where(first & (dn > 1.0), 1.0 / dn, 1.0)
            etas = (ladder * scale0 * mem["center"]).astype(dtype)
            f_trial = jax.vmap(lambda e: fun(x + e * direction))(etas)
            f_trial = jnp.where(jnp.isnan(f_trial), jnp.inf, f_trial)
            armijo_ok = f_trial <= f + armijo_c * etas * slope
            # best decrease among Armijo-satisfying rungs (closest rung to the
            # 1-D minimizer along d); plain argmin if none qualifies
            best_ok = jnp.argmin(jnp.where(armijo_ok, f_trial, jnp.inf))
            j_best = jnp.argmin(f_trial)
            j = jnp.where(jnp.any(armijo_ok), best_ok, j_best)
            improved = f_trial[j] < f
            eta = jnp.where(improved, etas[j], 0.0)
            x_new = x + eta * direction
            f_new = jnp.where(improved, f_trial[j], f)
            g_new = jax.grad(fun)(x_new)
            # self-centering: bracket the accepted step (×4 puts it two rungs
            # below the top, leaving headroom to grow); on rejection shift the
            # whole window below its current bottom rung and retry
            center = jnp.where(
                improved,
                jnp.clip(4.0 * etas[j] / scale0, 2.0 ** -24, 1e3),
                mem["center"] / span,
            )
            # cautious memory update: skip pairs with non-positive curvature
            s = x_new - x
            y = g_new - g
            sy = jnp.dot(s, y, precision=_HIGHEST)
            ok = (sy > 1e-10 * jnp.linalg.norm(s) * jnp.linalg.norm(y)) & improved
            idx = mem["count"] % memory_size
            # on a skipped pair leave slot idx UNTOUCHED (ADVICE r4): count
            # does not advance, so once the ring is full idx points at the
            # oldest still-live pair — writing zeros there would erase real
            # curvature history on every rejected/cautious-skipped iteration
            mem_new = dict(
                s=mem["s"].at[idx].set(jnp.where(ok, s, mem["s"][idx])),
                y=mem["y"].at[idx].set(jnp.where(ok, y, mem["y"][idx])),
                rho=mem["rho"].at[idx].set(
                    jnp.where(ok, 1.0 / jnp.where(sy == 0, 1.0, sy),
                              mem["rho"][idx])),
                gamma=jnp.where(ok, sy / jnp.dot(y, y, precision=_HIGHEST), mem["gamma"]),
                count=mem["count"] + jnp.where(ok, 1, 0),
                center=center,
            )
            # converged only when repeated rejections have pushed the window
            # to underflow: no descent exists at any representable step
            dead_end = (~improved) & (center < 1e-12)
            gnorm = jnp.where(dead_end, 0.0, jnp.linalg.norm(g_new))
            return (x_new, mem_new, it + 1, gnorm, f_new, g_new)

        return jax.lax.while_loop(cond, body, carry)

    return init, run


def minimize_lbfgs(
    fun: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
    linesearch: str = "zoom",
) -> MinimizeResult:
    """Unconstrained L-BFGS run to tolerance in-graph.

    `linesearch`: "zoom" (optax sequential zoom) or "ladder" (batched
    best-of-ladder — see `lbfgs_ladder_stepper`)."""
    stepper = lbfgs_ladder_stepper if linesearch == "ladder" else lbfgs_stepper
    init, run = stepper(fun, max_iter=max_iter, tol=tol, memory_size=memory_size)
    carry = run(init(x0), max_iter)
    params, it, gnorm = carry[0], carry[2], carry[3]
    return MinimizeResult(x=params, fun=fun(params), n_iter=it, grad_norm=gnorm)


def minimize_bounded(
    fun: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    lo: float = 0.0,
    hi: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
    linesearch: str = "zoom",
) -> MinimizeResult:
    """Minimize fun(x) subject to lo <= x <= hi elementwise.

    Drop-in for `scipy.optimize.minimize(..., method='L-BFGS-B',
    bounds=Bounds(lo, hi))` as used throughout the reference.  `linesearch`
    as in `minimize_lbfgs`.
    """
    lo = jnp.asarray(lo, x0.dtype)
    hi = jnp.asarray(hi, x0.dtype)
    to_params, to_theta = bounded_transform(lo, hi)

    def fun_theta(theta):
        return fun(to_params(theta))

    res = minimize_lbfgs(fun_theta, to_theta(x0), max_iter=max_iter, tol=tol,
                         memory_size=memory_size, linesearch=linesearch)
    x = to_params(res.x)
    return MinimizeResult(x=x, fun=res.fun, n_iter=res.n_iter, grad_norm=res.grad_norm)


def minimize_bounded_chunked(
    fun: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    lo: float = 0.0,
    hi: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
    linesearch: str = "zoom",
    chunk: int = 50,
) -> MinimizeResult:
    """`minimize_bounded` split into ≤`chunk`-iteration device programs.

    Why: the zoom linesearch's data-dependent trip counts make one
    to-convergence `while_loop` unboundedly long; segments bound each
    device program and give the host checkpoint points (whether one
    program is better on the GPU is ROADMAP item A5).  Segmentation reuses `bounded_stepper`'s (init, run, finalize) contract,
    so iterates are step-for-step identical to the single program."""
    init, run, fin = bounded_stepper(
        fun, lo=lo, hi=hi, max_iter=max_iter, tol=tol,
        memory_size=memory_size, dtype=x0.dtype, linesearch=linesearch,
    )
    run_j = jax.jit(run, static_argnums=(1,))
    carry = jax.jit(init)(x0)
    prev_it = -1
    while True:
        carry = run_j(carry, chunk)
        it = int(carry[2])
        if it >= max_iter or it == prev_it:  # budget exhausted or converged
            break
        prev_it = it
    return jax.jit(fin)(carry)


def bounded_stepper(
    fun: Callable[[jax.Array], jax.Array],
    lo: float = 0.0,
    hi: float = 1.0,
    max_iter: int = 200,
    tol: float = 1e-6,
    memory_size: int = 15,
    dtype=jnp.float32,
    linesearch: str = "zoom",
):
    """Segmented variant of `minimize_bounded`: `(init, run, finalize)`.

    `init(x0)` → carry; `run(carry, n_steps)` → carry (≤ n_steps iterations);
    `finalize(carry)` → MinimizeResult in the original (bounded) coordinates.
    All three are pure and jittable; the host loop between `run` calls bounds
    device-program duration (see `lbfgs_stepper`).  The host can detect
    convergence by carry[2] (iteration count) not advancing.

    `linesearch`: "zoom" (optax sequential zoom — scipy-faithful default) or
    "ladder" (`lbfgs_ladder_stepper` — batched best-of-ladder, one program
    per iteration instead of a serial zoom; the global searches' refinement
    default).
    """
    lo = jnp.asarray(lo, dtype)
    hi = jnp.asarray(hi, dtype)
    to_params, to_theta = bounded_transform(lo, hi)

    def fun_theta(theta):
        return fun(to_params(theta))

    stepper = lbfgs_ladder_stepper if linesearch == "ladder" else lbfgs_stepper
    init0, run = stepper(fun_theta, max_iter=max_iter, tol=tol, memory_size=memory_size)

    def init(x0):
        return init0(to_theta(x0))

    def finalize(carry) -> MinimizeResult:
        x = to_params(carry[0])
        if linesearch == "ladder":
            # the ladder carry already holds f(x) (carry[4], maintained every
            # accepted step as fun_theta(x) == fun(to_params(x))): reuse it
            # instead of re-tracing a full objective evaluation — the
            # re-evaluating finalize was the single heaviest compile of a
            # cold BO run (benchmarks/run_compile_census.py)
            return MinimizeResult(x=x, fun=carry[4], n_iter=carry[2],
                                  grad_norm=carry[3])
        return MinimizeResult(x=x, fun=fun(x), n_iter=carry[2], grad_norm=carry[3])

    return init, run, finalize
