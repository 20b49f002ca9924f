"""On-device Gaussian-process regression (Matérn-5/2) for Bayesian search.

Replaces sklearn's `GaussianProcessRegressor(kernel=Matern(nu=2.5),
n_restarts_optimizer=10)` (reference src/trajectory_bayesian_nonlinear.py:161-162):
kernel algebra, Cholesky solves, and the marginal-likelihood length-scale fit
all run as batched XLA ops, with the 1-D MLE solved by a vmapped two-stage
grid instead of looped quasi-Newton restarts (see `fit`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

def _jitter(dtype) -> float:
    """Cholesky jitter: sklearn GaussianProcessRegressor's default alpha=1e-10
    in f64 (oracle parity), scaled up for f32 — the BO dataset accumulates
    (near-)duplicate polished incumbents, so K is numerically singular and
    1e-10 cannot keep a float32 Cholesky positive-definite (eps ≈ 1.2e-7;
    observed in an f32 BO run: NaN length scale from round 7 on)."""
    return 1e-10 if jnp.dtype(dtype).itemsize >= 8 else 3e-5


def matern52(x1: jax.Array, x2: jax.Array, length_scale) -> jax.Array:
    """Matérn ν=5/2 kernel matrix for x1 (n,d), x2 (m,d)."""
    d2 = jnp.sum((x1[:, None, :] - x2[None, :, :]) ** 2, axis=-1)
    r = jnp.sqrt(jnp.maximum(d2, 1e-30))
    c = jnp.sqrt(5.0) * r / length_scale
    return (1.0 + c + c * c / 3.0) * jnp.exp(-c)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GP:
    x_train: jax.Array  # (n, d)
    chol: jax.Array  # (n, n) lower Cholesky of K + jitter I
    weights: jax.Array  # (n,) K^{-1} y
    y_train: jax.Array  # (n,)
    length_scale: jax.Array  # scalar
    mask: jax.Array  # (n,) real-row mask for padded datasets


def _masked_kernel(x, ell, mask, dtype):
    """K + jitter, with padded rows/cols turned into decoupled unit-variance
    points (off-diagonal zero): they contribute a constant to the likelihood
    and nothing to predictions, so padded fits equal unpadded fits."""
    n = x.shape[0]
    K = matern52(x, x, ell)
    m2 = mask[:, None] & mask[None, :]
    K = jnp.where(m2, K, 0.0)
    K = K.at[jnp.arange(n), jnp.arange(n)].set(jnp.where(mask, K[jnp.arange(n), jnp.arange(n)], 1.0))
    return K + _jitter(dtype) * jnp.eye(n, dtype=dtype)


def _nll(log_ell: jax.Array, x: jax.Array, y: jax.Array, mask: jax.Array) -> jax.Array:
    """Negative log marginal likelihood at a given log length-scale."""
    n = x.shape[0]
    K = _masked_kernel(x, jnp.exp(log_ell), mask, x.dtype)
    with jax.default_matmul_precision("highest"):  # full f32, never TF32
        L = jnp.linalg.cholesky(K)
        alpha = jax.scipy.linalg.cho_solve((L, True), y)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    return (
        0.5 * jnp.dot(y, alpha, precision=jax.lax.Precision.HIGHEST)
        + 0.5 * logdet + 0.5 * n * jnp.log(2.0 * jnp.pi)
    )


@partial(jax.jit, static_argnames=("n_restarts", "max_iter", "n_grid"))
def fit(
    x: jax.Array,
    y: jax.Array,
    key: jax.Array,
    n_restarts: int = 10,
    max_iter: int = 50,
    mask: jax.Array | None = None,
    ell0: jax.Array | None = None,
    n_grid: int = 64,
) -> GP:
    """MLE length-scale fit by vmapped two-stage grid refinement, then factorize.

    The marginal likelihood here is ONE-dimensional (a single isotropic
    length scale over the sklearn-default bracket [1e-2, 1e2] — narrowed
    from sklearn's [1e-5, 1e5] for conditioning; the racing-line alphas live
    in a unit box so this brackets every plausible scale).  The batched
    optimizer for a 1-D smooth objective is therefore NOT an iterative
    quasi-Newton chain (sklearn's `n_restarts_optimizer=10` L-BFGS, which
    serializes 25-50 zoom-linesearch iterations of tiny Choleskys) but an
    exhaustive grid:
    stage 1 factorizes `n_grid` log-spaced scales in ONE vmapped program,
    stage 2 refines `n_grid` scales across the two cells bracketing the
    stage-1 argmin.  Resolution ≈ (range/n_grid²) in log-space ≈ 0.2%
    relative — far below what moves GP posteriors, with σ-rule behavior
    identical to the L-BFGS restarts.

    `mask` marks real rows in a padded dataset: Bayesian search grows its
    dataset one point per round, so callers pad to fixed-size buckets to
    avoid per-round recompilation; padded rows are decoupled and do not
    affect the fit or predictions.

    `ell0` (a known-good scale, e.g. the previous round's fit) is appended
    to the stage-1 candidate set so a warm incumbent always competes.
    `key`/`n_restarts`/`max_iter` are kept for call-site compatibility with
    the restart-based fit (the grid is deterministic and needs none of them).
    """
    del key, n_restarts, max_iter
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if mask is None:
        mask = jnp.ones((x.shape[0],), dtype=bool)
    y = jnp.where(mask, y, 0.0)
    lo, hi = jnp.log(jnp.asarray(1e-2, x.dtype)), jnp.log(jnp.asarray(1e2, x.dtype))
    first = (
        jnp.zeros((1,), x.dtype)  # ell = 1.0, the sklearn initial value
        if ell0 is None
        else jnp.log(jnp.asarray(ell0, x.dtype)).reshape(1)
    )
    nll_v = jax.vmap(lambda le: _nll(le, x, y, mask))

    grid1 = jnp.concatenate([jnp.linspace(lo, hi, n_grid), first])
    f1 = nll_v(grid1)
    f1 = jnp.where(jnp.isfinite(f1), f1, jnp.inf)
    c = grid1[jnp.argmin(f1)]
    h = (hi - lo) / (n_grid - 1)
    grid2 = jnp.linspace(c - h, c + h, n_grid)
    f2 = nll_v(grid2)
    f2 = jnp.where(jnp.isfinite(f2), f2, jnp.inf)

    log_ells = jnp.concatenate([grid1, grid2])
    nlls = jnp.concatenate([f1, f2])
    ell = jnp.exp(log_ells[jnp.argmin(nlls)])
    # if every restart NaN'd (pathologically conditioned K), fall back to the
    # first start (the warm ell0 / sklearn init) rather than poisoning the GP
    ell = jnp.where(jnp.isfinite(ell) & (ell > 0), ell, jnp.exp(first[0]))
    K = _masked_kernel(x, ell, mask, x.dtype)
    with jax.default_matmul_precision("highest"):
        L = jnp.linalg.cholesky(K)
        weights = jax.scipy.linalg.cho_solve((L, True), y)
    return GP(x_train=x, chol=L, weights=weights, y_train=y, length_scale=ell, mask=mask)


@jax.jit
def predict(gp: GP, x_query: jax.Array):
    """Posterior mean and std at x_query (m, d)."""
    kq = matern52(gp.x_train, x_query, gp.length_scale)  # (n, m)
    kq = jnp.where(gp.mask[:, None], kq, 0.0)  # padded rows carry no signal
    mean = jnp.matmul(kq.T, gp.weights, precision=jax.lax.Precision.HIGHEST)
    with jax.default_matmul_precision("highest"):
        v = jax.scipy.linalg.solve_triangular(gp.chol, kq, lower=True)  # (n, m)
    var = 1.0 - jnp.sum(v * v, axis=0)  # Matérn prior variance is 1 at r=0
    return mean, jnp.sqrt(jnp.maximum(var, 0.0))
