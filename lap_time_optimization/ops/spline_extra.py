"""Alternative spline bases: trigonometric and tension (hyperbolic) splines.

The reference ships a spline-basis comparison driver (`src/simplify.py`) with
an enum POLY/TRIG/HYP (src/simplify.py:12-16) whose body is entirely commented
out — the comparison was never finished.  This module finishes it in JAX:

* **TrigSpline2D** — trigonometric (Fourier) interpolation through the
  control points at uniform-in-index parameter nodes scaled to the chord
  length.  Uniform nodes make the collocation matrix a DFT (closed curves)
  or a DCT-I cosine system (open curves) — perfectly conditioned, unlike
  full-Nyquist trigonometric interpolation at nonuniform chord nodes, which
  rings catastrophically between clustered nodes.  The fit is one dense n×n
  solve; evaluation of any derivative order is a dense (n_samples × n_basis)
  @ (n_basis × 2) matmul — one dense product instead of gather-heavy
  piecewise evaluation, and every derivative is analytic (the basis is
  entire), so curvature is exact.
* **TensionSpline2D** — exponential/hyperbolic spline under tension: on each
  interval the curve satisfies x'''' − τ²x'' = 0 (basis {1, t, sinh τt,
  cosh τt}).  As τ→0 it converges to the C² cubic spline of `ops.spline`; as
  τ→∞ it tightens toward the control polygon, suppressing the overshoot cubic
  splines show at sharp corner sequences.  The fit is the classic moment
  system with tension-modified coefficients (cyclic for closed tracks,
  natural ends for open), solved densely like `ops.spline.fit`.

Both are jit/vmap/grad-compatible, so either basis can be dropped into the
racing-line pipeline in place of the cubic spline.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from lap_time_optimization.ops.spline import chord_lengths


# ============================================================== trigonometric
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrigSpline2D:
    """Trigonometric interpolant x(u) = Σ_c coeffs[:,c]·φ_c(u).

    Closed: column 0 is the constant, columns (2k−1, 2k) are cos(kωu),
    sin(kωu) with ω = 2π/T (for an even basis count the last column is the
    Nyquist cosine alone).  Open: pure cosine basis φ_c = cos(cπu/T) — the
    interpolant is the even (mirror) extension of the data.
    """

    coeffs: jax.Array  # (2, n_basis)
    omega: jax.Array  # fundamental angular frequency
    nodes: jax.Array  # (n_pts,) parameter values of the control points
    controls: jax.Array  # (2, n_pts) original control points
    length: jax.Array  # chord-length parameter span T
    closed: bool = dataclasses.field(metadata=dict(static=True), default=False)


def _trig_col_freqs(n_basis: int, closed: bool):
    """Per-column harmonic index k and cos/sin selector."""
    cols = jnp.arange(n_basis)
    if closed:
        return (cols + 1) // 2, (cols % 2) == 1
    return cols, jnp.ones((n_basis,), bool)  # cosine-only (even extension)


def _trig_basis(u: jax.Array, omega, n_basis: int, der: int, closed: bool) -> jax.Array:
    """φ_c^{(der)}(u) for all columns c: shape (*u.shape, n_basis)."""
    k, is_cos = _trig_col_freqs(n_basis, closed)
    w = k * omega  # (n_basis,)
    phase = w * u[..., None] + der * (jnp.pi / 2.0)
    # d/du cos(wu) = w·cos(wu + π/2); d/du sin(wu) = w·sin(wu + π/2)
    vals = jnp.where(is_cos, jnp.cos(phase), jnp.sin(phase)) * w**der
    const = jnp.where(der == 0, jnp.ones_like(u), jnp.zeros_like(u))
    return vals.at[..., 0].set(const)


@partial(jax.jit, static_argnames=("closed",))
def trig_fit(points: jax.Array, closed: bool) -> TrigSpline2D:
    """Interpolating trigonometric fit through `points` (2, n_pts).

    Nodes are uniform in control-point index, scaled to the total chord
    length T (closed curves: node j = jT/n with the duplicated final point at
    T; open: node j = jT/(n−1)).  On the uniform grid the trig basis is
    orthogonal, so the fit is a DFT quadrature — one small (2×m)@(m×n)
    matmul, exact and f32-stable (no linear solve; whether an FFT would win
    on the GPU is unmeasured).  A dense
    collocation solve at chord-length nodes with a full-Nyquist basis would
    instead be ill-conditioned and oscillate wildly wherever nodes cluster.
    """
    points = jnp.asarray(points)
    t = chord_lengths(points)
    T = t[-1]
    if closed:
        n = points.shape[1] - 1
        q = points[:, :n]
        nodes = T * jnp.arange(points.shape[1], dtype=points.dtype) / n
        omega = 2.0 * jnp.pi / T
        q_nodes = nodes[:n]
    else:
        # even (mirror) extension -> pure cosine series over period 2T
        n = points.shape[1]
        q = jnp.concatenate([points, points[:, -2:0:-1]], axis=1)  # (2, 2(n-1))
        nodes = T * jnp.arange(n, dtype=points.dtype) / (n - 1)
        omega = jnp.pi / T
        q_nodes = 2.0 * T * jnp.arange(q.shape[1], dtype=points.dtype) / q.shape[1]
    m = q.shape[1]
    # a_k = (2/m) Σ_j q_j cos(kω u_j),  b_k = (2/m) Σ_j q_j sin(kω u_j);
    # the constant and (for even counts) Nyquist columns are not doubled
    k_cols, _ = _trig_col_freqs(n, closed)
    phi = _trig_basis(q_nodes, omega, n, 0, closed)  # (m, n)
    scale = jnp.where((k_cols > 0) & (2 * k_cols != m), 2.0, 1.0)
    coeffs = jnp.matmul(q, phi, precision=jax.lax.Precision.HIGHEST) * (scale / m)
    return TrigSpline2D(
        coeffs=coeffs, omega=omega, nodes=nodes, controls=points, length=T, closed=closed
    )


@partial(jax.jit, static_argnames=("der",))
def trig_evaluate(sp: TrigSpline2D, u: jax.Array, der: int = 0) -> jax.Array:
    """Evaluate the interpolant (or analytic derivative) at `u`; (2, *u.shape)."""
    u = jnp.asarray(u)
    phi = _trig_basis(u, sp.omega, sp.coeffs.shape[1], der, sp.closed)
    return jnp.einsum("cb,...b->c...", sp.coeffs, phi, precision=jax.lax.Precision.HIGHEST)


# ==================================================================== tension
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TensionSpline2D:
    """Hyperbolic spline under tension, stored per-interval like Spline2D."""

    tk: jax.Array  # (m+1,) interval edges
    pj: jax.Array  # (2, m) left endpoints
    pj1: jax.Array  # (2, m) right endpoints
    zj: jax.Array  # (2, m) second derivative at left endpoint
    zj1: jax.Array  # (2, m) second derivative at right endpoint
    h: jax.Array  # (m,) interval widths
    tau: jax.Array  # scalar tension (per unit parameter)
    controls: jax.Array
    length: jax.Array
    closed: bool = dataclasses.field(metadata=dict(static=True), default=False)


def _tension_weights(tau, h):
    """Off-diagonal a and diagonal-contribution b of the tension moment
    system; a→h/6, b→h/3 as τ→0 (the cubic limit)."""
    th = tau * h
    a = 1.0 / (tau**2 * h) - 1.0 / (tau * jnp.sinh(th))
    b = jnp.cosh(th) / (tau * jnp.sinh(th)) - 1.0 / (tau**2 * h)
    return a, b


@partial(jax.jit, static_argnames=("closed",))
def tension_fit(points: jax.Array, closed: bool, tension: float = 0.5) -> TensionSpline2D:
    """Fit an interpolating C² tension spline; `tension` is τ per unit of
    chord-length parameter (τ→0 recovers `ops.spline.fit` exactly)."""
    points = jnp.asarray(points)
    t = chord_lengths(points)
    tau = jnp.asarray(tension, points.dtype)
    if closed:
        n = points.shape[1] - 1
        p = points[:, :n]
        h = jnp.diff(t)  # (n,)
        a, b = _tension_weights(tau, h)
        idx = jnp.arange(n)
        im1 = (idx - 1) % n
        ip1 = (idx + 1) % n
        rhs = (p[:, ip1] - p) / h - (p - p[:, im1]) / h[im1]
        A = jnp.zeros((n, n), dtype=h.dtype)
        A = A.at[idx, im1].add(a[im1])
        A = A.at[idx, idx].add(b[im1] + b)
        A = A.at[idx, ip1].add(a)
        with jax.default_matmul_precision("highest"):
            z = jnp.linalg.solve(A, rhs.T).T
        return TensionSpline2D(
            tk=t, pj=p, pj1=p[:, ip1], zj=z, zj1=z[:, ip1], h=h, tau=tau,
            controls=points, length=t[-1], closed=True,
        )
    n = points.shape[1]
    h = jnp.diff(t)  # (n-1,)
    a, b = _tension_weights(tau, h)
    i = jnp.arange(1, n - 1)
    rhs = jnp.zeros((2, n), dtype=points.dtype)
    rhs = rhs.at[:, i].set(
        (points[:, i + 1] - points[:, i]) / h[i] - (points[:, i] - points[:, i - 1]) / h[i - 1]
    )
    A = jnp.zeros((n, n), dtype=h.dtype)
    A = A.at[i, i - 1].add(a[i - 1])
    A = A.at[i, i].add(b[i - 1] + b[i])
    A = A.at[i, i + 1].add(a[i])
    # natural ends: z_0 = z_{n-1} = 0
    A = A.at[0, 0].set(1.0)
    A = A.at[n - 1, n - 1].set(1.0)
    with jax.default_matmul_precision("highest"):
        z = jnp.linalg.solve(A, rhs.T).T
    return TensionSpline2D(
        tk=t, pj=points[:, :-1], pj1=points[:, 1:], zj=z[:, :-1], zj1=z[:, 1:],
        h=h, tau=tau, controls=points, length=t[-1], closed=False,
    )


@partial(jax.jit, static_argnames=("der",))
def tension_evaluate(sp: TensionSpline2D, u: jax.Array, der: int = 0) -> jax.Array:
    """Evaluate the tension spline (or derivative) at `u`; (2, *u.shape).

    Segment form: x(t) = [z_j sinh(τ·ta′) + z_{j+1} sinh(τ·tb)]/(τ² sinh τh)
    + (p_j − z_j/τ²)·ta′/h + (p_{j+1} − z_{j+1}/τ²)·tb/h, with ta′ = distance
    to the right knot and tb = distance from the left knot."""
    u = jnp.asarray(u)
    if sp.closed:
        u = jnp.mod(u, sp.length)
    m = sp.h.shape[0]
    j = jnp.clip(jnp.searchsorted(sp.tk, u, side="right") - 1, 0, m - 1)
    ta = sp.tk[j + 1] - u
    tb = u - sp.tk[j]
    h = sp.h[j]
    tau = sp.tau
    zj, zj1 = sp.zj[:, j], sp.zj1[:, j]
    pj, pj1 = sp.pj[:, j], sp.pj1[:, j]
    sinh_th = jnp.sinh(tau * h)
    inv_h = 1.0 / h
    if der == 0:
        return (
            (zj * jnp.sinh(tau * ta) + zj1 * jnp.sinh(tau * tb)) / (tau**2 * sinh_th)
            + (pj - zj / tau**2) * ta * inv_h
            + (pj1 - zj1 / tau**2) * tb * inv_h
        )
    if der == 1:
        return (
            (-zj * jnp.cosh(tau * ta) + zj1 * jnp.cosh(tau * tb)) / (tau * sinh_th)
            - (pj - zj / tau**2) * inv_h
            + (pj1 - zj1 / tau**2) * inv_h
        )
    if der == 2:
        return (zj * jnp.sinh(tau * ta) + zj1 * jnp.sinh(tau * tb)) / sinh_th
    raise ValueError(f"der must be in 0..2, got {der}")


# ============================================================ shared geometry
def planar_curvature(d1: jax.Array, d2: jax.Array, signed: bool = False) -> jax.Array:
    """κ from first/second parameter derivatives (2, ...) — same formula as
    reference src/path.py:56-61."""
    num = d1[0] * d2[1] - d1[1] * d2[0]
    den = (d1[0] ** 2 + d1[1] ** 2) ** 1.5
    k = num / den
    return k if signed else jnp.abs(k)


def curvature(sp, u: jax.Array, signed: bool = False) -> jax.Array:
    """Basis-generic curvature for TrigSpline2D / TensionSpline2D."""
    ev = trig_evaluate if isinstance(sp, TrigSpline2D) else tension_evaluate
    return planar_curvature(ev(sp, u, der=1), ev(sp, u, der=2), signed)


def gamma2(sp, u: jax.Array) -> jax.Array:
    """Curvature energy Σκ² (the racing-line smoothness objective)."""
    k = curvature(sp, u, signed=True)
    return jnp.sum(k * k)


def arc_length(sp, u: jax.Array) -> jax.Array:
    """Trapezoid arc length over the sample grid `u`."""
    ev = trig_evaluate if isinstance(sp, TrigSpline2D) else tension_evaluate
    d1 = ev(sp, u, der=1)
    speed = jnp.sqrt(d1[0] ** 2 + d1[1] ** 2)
    return jnp.sum(0.5 * (speed[1:] + speed[:-1]) * jnp.diff(u))
