"""NMPC track: racing-line artifacts → differentiable lookup tables.

Capability parity with reference src/mpc/track.py, which loads the five
racing-line artifacts and builds CasADi `interpolant` tables for curvature
k(s), boundary distances NL(s)/NR(s), and reference velocity vref(s).  Here
the tables are plain arrays sampled on a uniform arc-length grid, evaluated
with `jnp.interp` inside the jitted solver — the piecewise-linear semantics
match `ca.interpolant("linear")`.

Differences by design (SURVEY.md §7 "quirks to fix"):
* `n_samples` is derived from the velocities artifact instead of the
  hardcoded 846 (reference src/mpc.py:88);
* closed-lap lookups wrap s modulo the lap length instead of clamping at the
  table edge, so multi-lap simulations stay on the track;
* the boundary-distance search is the vectorized nearest-boundary-sample
  distance (the reference's perpendicular-line machinery at
  src/mpc/track.py:113-161 reduces to exactly this: it iterates every
  boundary sample and keeps the minimum Euclidean distance within radius 10).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from lap_time_optimization.ops import spline
from lap_time_optimization.utils import io


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MPCTrack:
    """Lookup tables over a uniform arc-length grid, plus plot geometry."""

    s_grid: jax.Array  # (n,) arc lengths, uniform in [0, s_max]
    k_vals: jax.Array  # (n,) signed curvature of the optimal path
    nl_vals: jax.Array  # (n,) distance to left boundary
    nr_vals: jax.Array  # (n,) distance to right boundary
    vref_vals: jax.Array  # (n,) reference velocity profile
    s_max: jax.Array  # scalar lap length (arc length)
    path_xy: jax.Array  # (2, n) optimal path points at s_grid (for replay)
    path_tangent: jax.Array  # (2, n) unit tangents at s_grid (for replay)
    left_xy: jax.Array  # (2, n) left boundary samples (for plots)
    right_xy: jax.Array  # (2, n) right boundary samples (for plots)
    closed: bool = dataclasses.field(metadata=dict(static=True), default=True)

    # ----------------------------------------------------------- jit lookups
    def _wrap(self, s):
        return jnp.mod(s, self.s_max) if self.closed else s

    def _uinterp(self, s, vals):
        """Piecewise-linear lookup on the UNIFORM arc grid: direct index
        arithmetic (one gather) instead of jnp.interp's binary search — these
        lookups sit inside every dynamics/constraint evaluation of the NMPC
        hot loop.  The cell index is clipped to [0, n-2] as an integer (an
        epsilon shaved off a float upper bound would round away in f32 for
        large tables) and frac to [0, 1], so the lookup is exact and
        in-bounds at both table edges in any dtype."""
        n = self.s_grid.shape[0]
        inv_ds = (n - 1) / self.s_max
        t = self._wrap(s) * inv_ds
        i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
        frac = jnp.clip(t - i, 0.0, 1.0)
        return vals[i] * (1.0 - frac) + vals[i + 1] * frac

    def curvature(self, s):
        """k(s), the symbolic-lookup replacement (src/mpc/track.py:26-37,
        src/mpc/model.py:66-67)."""
        return self._uinterp(s, self.k_vals)

    def dist_left(self, s):
        return self._uinterp(s, self.nl_vals)

    def dist_right(self, s):
        return self._uinterp(s, self.nr_vals)

    def v_ref(self, s):
        """vref(s) (reference `velocities_interp`, src/mpc/track.py:39-42)."""
        return self._uinterp(s, self.vref_vals)

    def position(self, s):
        """Cartesian point + unit tangent at arc length s (host/replay use)."""
        sw = self._wrap(s)
        x = jnp.interp(sw, self.s_grid, self.path_xy[0])
        y = jnp.interp(sw, self.s_grid, self.path_xy[1])
        tx = jnp.interp(sw, self.s_grid, self.path_tangent[0])
        ty = jnp.interp(sw, self.s_grid, self.path_tangent[1])
        return jnp.stack([x, y]), jnp.stack([tx, ty])


def _resample_closed(points: np.ndarray, n_samples: int):
    """Fit a closed spline through `points` (2, m) and return arc-uniform
    samples: (s_grid, xy, tangent, signed curvature, s_max)."""
    pts = jnp.asarray(points)
    if not np.allclose(points[:, 0], points[:, -1]):
        pts = jnp.concatenate([pts, pts[:, :1]], axis=1)
    sp = spline.fit(pts, closed=True)
    # dense arc-length table, then invert onto a uniform arc grid
    u_dense, arc_dense = spline.arc_length_table(sp, n_samples=4 * n_samples)
    s_max = float(arc_dense[-1])
    s_grid = jnp.linspace(0.0, s_max, n_samples)
    u_grid = spline.u_of_arc_length(u_dense, arc_dense, s_grid)
    xy = spline.evaluate(sp, u_grid)
    d1 = spline.evaluate(sp, u_grid, der=1)
    tangent = d1 / jnp.linalg.norm(d1, axis=0, keepdims=True)
    k = spline.curvature(sp, u_grid, signed=True)
    return s_grid, xy, tangent, k, s_max


def load(
    vehicle_name: str,
    track_name: str,
    method: str,
    base_dir: str | None = None,
    n_samples: int | None = None,
) -> MPCTrack:
    """Load the artifact set for (vehicle, track, method) and build tables.

    Mirrors reference src/mpc/track.py:10-42 with n_samples defaulting to the
    velocities artifact length.
    """
    if base_dir is None:
        base_dir = io.default_data_dir()
    d = io.artifact_dir(base_dir, vehicle_name, track_name, method)
    px, py = io.load_artifact(os.path.join(d, "path.json"))
    lx, ly = io.load_artifact(os.path.join(d, "left.json"))
    rx, ry = io.load_artifact(os.path.join(d, "right.json"))
    velocities = io.load_artifact(os.path.join(d, "velocities.json"))
    if n_samples is None:
        n_samples = len(velocities)
    return build(
        np.stack([px, py]), np.stack([lx, ly]), np.stack([rx, ry]), velocities, n_samples
    )


def with_brake_preview(track: MPCTrack, a_brake: float, vref_scale: float = 1.0) -> MPCTrack:
    """Return a copy of `track` whose vref table is the braking-curve
    envelope of the original: the largest profile the car can actually track
    given a physical deceleration budget `a_brake` [m/s²] on the TRACKED
    target `vref_scale·vref`.

    Why this exists: the racing-line vref artifact is brake-feasible for the
    *racing-line* vehicle model (full-traction friction-circle braking, ~10+
    m/s² — reference src/velocity.py:55-76), but the NMPC plant can only
    brake at ≈ C_m·T/m ≈ 1 m/s² plus drag (reference src/mpc/model.py:160:
    Fx = C_m·throttle − Cr0 − Cr2·vx², throttle ≥ −1).  A short horizon
    (h=10 → 1 s lookahead) therefore cannot see corner-entry braking points
    early enough, which is the measured f32 h10 marginality documented in
    docs/PERFORMANCE.md.  The envelope

        w̃(s) = min_{d ≥ 0} sqrt(w(s+d)² + 2·a_brake·d),   w = vref_scale·vref

    moves braking information upstream into the table itself (a pure
    build-time transform — zero solver cost), so the tracked target is
    achievable under the budget regardless of horizon length.

    This is exactly the velocity solver's deceleration pass
    (ops/velocity.py) applied to the vref table with a constant decel bound.
    `a_brake = inf` (or ≤ 0) returns the track unchanged.  Because the
    stage cost tracks `vref_scale·vref`, the envelope is computed on the
    scaled profile and divided back out, i.e. the stored table satisfies
        (vref_scale·ṽ)²[i] ≤ (vref_scale·ṽ)²[i+1] + 2·a_brake·ds.
    """
    if not np.isfinite(a_brake) or a_brake <= 0.0:
        return track
    if not np.isfinite(vref_scale) or vref_scale <= 0.0:
        raise ValueError(
            f"vref_scale must be positive (got {vref_scale}): the envelope is "
            f"computed on the TRACKED target vref_scale*vref"
        )
    v = np.asarray(track.vref_vals, dtype=np.float64)
    n = v.shape[0]
    ds = float(track.s_max) / (n - 1)
    # envelope on the scaled target == envelope on vref with a/scale²
    a_eff = a_brake / (vref_scale * vref_scale)
    w2 = v * v
    # Backward (anti-driving-direction) passes to a fixed point: each sweep
    # propagates braking information one lap upstream, and for very small
    # a_eff the braking distance can exceed a lap, so iterate until the pass
    # makes no update (monotone decreasing and bounded below by 0, so this
    # terminates; 2 sweeps suffice for any a_eff with braking distance under
    # two laps, the practical regime).
    while True:
        changed = False
        for i in range(n - 2, -1, -1):
            cap = w2[i + 1] + 2.0 * a_eff * ds
            if cap < w2[i]:
                w2[i] = cap
                changed = True
        if track.closed and w2[0] < w2[-1]:
            # stitch the lap seam: sample 0 and n-1 are the same point
            w2[-1] = w2[0]
            changed = True
        if not changed or not track.closed:
            break
    return dataclasses.replace(track, vref_vals=jnp.asarray(np.sqrt(w2), track.vref_vals.dtype))


def build(path_pts, left_pts, right_pts, velocities, n_samples: int) -> MPCTrack:
    """Construct the lookup tables from raw point sets."""
    s_grid, path_xy, tangent, k, s_max = _resample_closed(np.asarray(path_pts), n_samples)
    _, left_xy, _, _, _ = _resample_closed(np.asarray(left_pts), n_samples)
    _, right_xy, _, _, _ = _resample_closed(np.asarray(right_pts), n_samples)

    # nearest-boundary-sample distance at every path sample (host-side setup;
    # native C++ kernel with numpy fallback, utils/native.py)
    from lap_time_optimization.utils import native

    path_np = np.asarray(path_xy, dtype=np.float64)
    nl = jnp.asarray(native.nearest_distances(path_np, np.asarray(left_xy, dtype=np.float64)), path_xy.dtype)
    nr = jnp.asarray(native.nearest_distances(path_np, np.asarray(right_xy, dtype=np.float64)), path_xy.dtype)

    # vref(s): the velocities artifact is sampled per metre along the racing
    # line (ns-1 entries over [0, s_max)); resample onto the arc grid
    velocities = np.asarray(velocities)
    s_vel = np.linspace(0.0, s_max, len(velocities), endpoint=False)
    vref = jnp.interp(s_grid, jnp.asarray(s_vel), jnp.asarray(velocities))

    return MPCTrack(
        s_grid=s_grid,
        k_vals=k,
        nl_vals=nl,
        nr_vals=nr,
        vref_vals=vref,
        s_max=jnp.asarray(s_max),
        path_xy=path_xy,
        path_tangent=tangent,
        left_xy=left_xy,
        right_xy=right_xy,
        closed=True,
    )
