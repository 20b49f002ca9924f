"""Racing-line optimization methods (curvature / compromise / lap time / sectors).

Capability parity with reference src/trajectory.py, redesigned for batched JAX:

* the alphas → spline-fit → curvature → velocity-profile → lap-time pipeline
  is ONE jitted differentiable graph (the reference refits FITPACK splines
  inside a finite-difference L-BFGS-B objective, src/trajectory.py:60-146);
* scalar searches (the compromise epsilon, src/trajectory.py:99-126) become
  vmapped grid sweeps — every epsilon candidate runs its own full L-BFGS in
  parallel on the same chip;
* the sector method (src/trajectory.py:148-213) replaces the reference's
  `multiprocessing.Pool` with a vmap over padded sector windows, so all
  sectors × all epsilons optimize simultaneously.

All entry points take the Track/vehicle pytrees as arguments; static metadata
(sample counts, closedness) lives in the pytree treedef so jit specializes per
track shape once and caches across method calls.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lap_time_optimization.ops import optimize, spline, velocity
from lap_time_optimization.track import Track
from lap_time_optimization.utils import corners as corner_utils
from lap_time_optimization.utils.config import CompromiseConfig, CornerConfig

# Defaults sourced from the central config (reference values:
# src/__main__.py:109-112 for corners, src/trajectory.py:99 for epsilon)
_CORNERS = CornerConfig()
_COMPROMISE = CompromiseConfig()
K_MIN, PROXIMITY, LENGTH = _CORNERS.k_min, _CORNERS.proximity, _CORNERS.length
EPS_MIN, EPS_MAX = _COMPROMISE.eps_min, _COMPROMISE.eps_max


# --------------------------------------------------------------------------- core pipeline
def path_and_samples(track: Track, alphas: jax.Array):
    """Fit the racing-line spline and the fixed-count sample grid.

    `track.ns` (per-metre count from the centerline, src/trajectory.py:35) is
    static; the sample grid spans the *current* path length each evaluation
    (src/trajectory.py:45)."""
    sp = track.path_spline(alphas)
    s = jnp.linspace(0.0, sp.length, track.ns)
    return sp, s


def profile(track: Track, vehicle, sp: spline.Spline2D, s: jax.Array) -> jax.Array:
    """Velocity profile over s[:-1] (reference src/trajectory.py:47-52)."""
    k = spline.curvature(sp, s[:-1], signed=False)
    return velocity.solve_profile(vehicle, s[:-1], k, sp.length, track.closed)


def lap_time_of(track: Track, vehicle, alphas: jax.Array) -> jax.Array:
    sp, s = path_and_samples(track, alphas)
    v = profile(track, vehicle, sp, s)
    return velocity.lap_time(s, v)


def evaluate(track: Track, vehicle, alphas: jax.Array):
    """Full diagnostics for reporting: (lap_time, path_length, v, s)."""
    sp, s = path_and_samples(track, alphas)
    v = profile(track, vehicle, sp, s)
    return velocity.lap_time(s, v), sp.length, v, s


evaluate_jit = jax.jit(evaluate)


# --------------------------------------------------------------------------- objectives
def gamma2_objective(track: Track, alphas: jax.Array) -> jax.Array:
    sp, s = path_and_samples(track, alphas)
    return spline.gamma2(sp, s)


def compromise_objective(track: Track, alphas: jax.Array, eps: jax.Array) -> jax.Array:
    sp, s = path_and_samples(track, alphas)
    return (1.0 - eps) * spline.gamma2(sp, s) + eps * sp.length


# --------------------------------------------------------------------------- methods
@partial(jax.jit, static_argnames=("max_iter", "linesearch"))
def minimise_curvature(track: Track, max_iter: int = 400,
                       linesearch: str = "zoom") -> optimize.MinimizeResult:
    """Γ²-minimizing path, analytic-gradient L-BFGS (vs src/trajectory.py:60-75)."""
    x0 = jnp.full((track.size,), 0.5, dtype=track.left.dtype)
    return optimize.minimize_bounded(lambda a: gamma2_objective(track, a), x0,
                                     max_iter=max_iter, linesearch=linesearch)


@partial(jax.jit, static_argnames=("max_iter", "linesearch"))
def minimise_compromise(track: Track, eps, max_iter: int = 400,
                        linesearch: str = "zoom") -> optimize.MinimizeResult:
    """(1−ε)Γ² + ε·length (vs src/trajectory.py:77-97)."""
    x0 = jnp.full((track.size,), 0.5, dtype=track.left.dtype)
    eps = jnp.asarray(eps, x0.dtype)
    return optimize.minimize_bounded(lambda a: compromise_objective(track, a, eps), x0,
                                     max_iter=max_iter, linesearch=linesearch)


@partial(jax.jit, static_argnames=("max_iter", "linesearch"))
def _compromise_sweep(track: Track, vehicle, eps_grid: jax.Array, max_iter: int = 400,
                      linesearch: str = "zoom"):
    """Batched: for every ε in the grid, optimize the compromise and score the
    resulting lap time.  Returns (alphas(B,n), lap_times(B,))."""

    def solve_one(eps):
        res = minimise_compromise(track, eps, max_iter=max_iter, linesearch=linesearch)
        return res.x, lap_time_of(track, vehicle, res.x)

    return jax.vmap(solve_one)(eps_grid)


def minimise_optimal_compromise(
    track: Track,
    vehicle,
    eps_min: float = EPS_MIN,
    eps_max: float = EPS_MAX,
    n_grid: int = 16,
    n_refine: int = 1,
    max_iter: int = 400,
    linesearch: str = "zoom",
):
    """Optimal-ε compromise via vmapped grid sweep + local zoom.

    The reference nests a scalar bounded search around a full L-BFGS per ε
    (src/trajectory.py:99-126, ~25 serial inner solves); here each sweep runs
    `n_grid` inner solves *in parallel* and zooms `n_refine` times.  Returns
    (alphas, epsilon, history) where history is the (ε, lap_time) log matching
    the reference's `epsilon_history`.
    """
    lo, hi = float(eps_min), float(eps_max)
    history = []
    best = None
    for _ in range(1 + n_refine):
        eps_grid = jnp.linspace(lo, hi, n_grid)
        alphas_b, times_b = _compromise_sweep(track, vehicle, eps_grid,
                                              max_iter=max_iter, linesearch=linesearch)
        times = np.asarray(times_b)
        history.extend(zip(np.asarray(eps_grid).tolist(), times.tolist()))
        i = int(np.argmin(times))
        cand = (float(times[i]), float(eps_grid[i]), alphas_b[i])
        if best is None or cand[0] < best[0]:
            best = cand
        cell = (hi - lo) / (n_grid - 1)
        lo = max(float(eps_min), float(eps_grid[i]) - cell)
        hi = min(float(eps_max), float(eps_grid[i]) + cell)
    _, epsilon, alphas = best
    return alphas, epsilon, np.asarray(history)


def minimise_lap_time(track: Track, vehicle, max_iter: int = 300,
                      linesearch: str = "zoom", chunk: int = 50) -> optimize.MinimizeResult:
    """Directly minimise lap time through the differentiable profile solver
    (vs src/trajectory.py:128-146, which numerically differentiates the full
    3-pass solve).

    Host-chunked into ≤`chunk`-iteration device programs: this objective runs
    the full velocity pipeline per evaluation with data-dependent zoom
    linesearch trip counts, so one to-convergence program is unboundedly
    long (see `optimize.minimize_bounded_chunked`; ROADMAP item A5).
    Iterates are identical to the single-program run."""
    x0 = jnp.full((track.size,), 0.5, dtype=track.left.dtype)
    return optimize.minimize_bounded_chunked(
        lambda a: lap_time_of(track, vehicle, a), x0,
        max_iter=max_iter, linesearch=linesearch, chunk=chunk)


# --------------------------------------------------------------------------- corners / estimated
def detect_track_corners(track: Track, k_min=K_MIN, proximity=PROXIMITY, length=LENGTH):
    """Corner detection on the centerline (host-side, reference src/track.py:78-80)."""
    mid = track.mid_spline()
    s = np.linspace(0.0, float(mid.length), track.ns)
    k = np.asarray(spline.curvature(mid, jnp.asarray(s), signed=False))
    control_dists = np.asarray(mid.tk)
    return corner_utils.detect_corners(k, s, control_dists, k_min, proximity, length)


def minimise_estimated_compromise(track: Track, vehicle, max_iter: int = 400):
    """ε estimated as 0.406 × mean corner curvature (src/__main__.py:139-147)."""
    _, mask = detect_track_corners(track)
    mid = track.mid_spline()
    s = np.linspace(0.0, float(mid.length), track.ns)
    k = np.asarray(spline.curvature(mid, jnp.asarray(s[mask]), signed=False))
    epsilon = float(0.406 * np.mean(k))
    res = minimise_compromise(track, epsilon, max_iter=max_iter)
    return res.x, epsilon


# --------------------------------------------------------------------------- sectors
@partial(jax.jit, static_argnames=("ns_pad", "max_iter", "n_grid"))
def _sector_sweep(left_w, right_w, vehicle, ns_pad: int, n_grid: int, max_iter: int):
    """Batched sector × epsilon compromise solve over open sub-tracks.

    left_w/right_w: (nc, 2, L) padded boundary windows.  Returns per-sector
    (alphas (nc, L), epsilon (nc,)) chosen by lap time over the window.
    """
    eps_grid = jnp.linspace(EPS_MIN, EPS_MAX, n_grid, dtype=left_w.dtype)

    def solve_sector(lw, rw):
        diffs = rw - lw

        def obj(alphas, eps):
            controls = lw + alphas[None, :] * diffs
            sp = spline.fit(controls, closed=False)
            s = jnp.linspace(0.0, sp.length, ns_pad)
            return (1.0 - eps) * spline.gamma2(sp, s) + eps * sp.length

        def solve_eps(eps):
            x0 = jnp.full((lw.shape[1],), 0.5, dtype=lw.dtype)
            res = optimize.minimize_bounded(lambda a: obj(a, eps), x0, max_iter=max_iter)
            controls = lw + res.x[None, :] * diffs
            sp = spline.fit(controls, closed=False)
            s = jnp.linspace(0.0, sp.length, ns_pad)
            k = spline.curvature(sp, s[:-1], signed=False)
            v = velocity.solve_profile(vehicle, s[:-1], k, sp.length, closed=False)
            return res.x, velocity.lap_time(s, v)

        alphas_b, times_b = jax.vmap(solve_eps)(eps_grid)
        i = jnp.argmin(times_b)
        return alphas_b[i], eps_grid[i]

    return jax.vmap(solve_sector)(left_w, right_w)


def optimise_sectors(
    track: Track,
    vehicle,
    k_min=K_MIN,
    proximity=PROXIMITY,
    length=LENGTH,
    n_grid: int = 8,
    max_iter: int = 300,
):
    """Sector-parallel compromise optimization with cross-faded merging.

    Replaces the reference's `Pool(os.cpu_count()-1)` fan-out
    (src/trajectory.py:148-213) with a single vmapped solve over padded sector
    windows: windows are sliced [sector start → next corner entry), padded to
    a common length so they batch, optimized as *open* sub-tracks, and merged
    with the reference's linear cross-fade over the straights
    (src/trajectory.py:197-202).
    """
    corners, _ = detect_track_corners(track, k_min, proximity, length)
    nc = corners.shape[0]
    if nc == 0:
        raise ValueError("no corners detected; sector optimization is undefined")
    n = track.size
    left = np.asarray(track.left)
    right = np.asarray(track.right)

    spans, idx_windows = [], []
    for i in range(nc):
        a = int(corners[(i - 1) % nc, 1])
        d = int(corners[(i + 1) % nc, 0])
        idxs = corner_utils.idx_modulo(a, d, n)
        spans.append((a, int(corners[i, 0]), int(corners[i, 1]), d))
        idx_windows.append(idxs)

    L = max(len(w) for w in idx_windows)
    # pad windows by continuing around the track so every batch entry is a
    # genuine boundary slice of identical static length
    padded = np.stack(
        [np.array([(w[0] + j) % n for j in range(L)], dtype=int) for w in idx_windows]
    )
    left_w = jnp.asarray(left[:, padded].transpose(1, 0, 2))  # (nc, 2, L)
    right_w = jnp.asarray(right[:, padded].transpose(1, 0, 2))

    # static per-metre sample count for the padded windows
    mids = 0.5 * (left[:, padded] + right[:, padded])  # (2, nc, L)
    seglen = np.hypot(*np.diff(mids, axis=2)).sum(axis=1)
    ns_pad = int(math.ceil(seglen.max())) + 1

    alphas_w, eps_w = _sector_sweep(left_w, right_w, vehicle, ns_pad, n_grid, max_iter)
    alphas_w = np.asarray(alphas_w)

    # merge with linear cross-fades over the shared straights
    alphas = np.zeros(n)
    for i, (a, b, c, d) in enumerate(spans):
        span = (d - a) % n
        weights = np.ones(span)
        head = (b - a) % n
        tail = (d - c) % n
        if head:
            weights[:head] = np.linspace(0, 1, head)
        if tail:
            weights[span - tail:] = np.linspace(1, 0, tail)
        idxs = idx_windows[i]
        alphas[idxs] += alphas_w[i, :span] * weights
    return jnp.asarray(alphas), np.asarray(eps_w), corners
