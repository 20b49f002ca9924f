"""Track: cone boundaries, usable-width shrink, alpha → control-point mapping.

Capability parity with reference src/track.py, redesigned so the pieces that
sit inside the optimization loop (`control_points`) are pure JAX functions of
a pytree, while one-time loading/shrinking stays on the host.

The racing line is parameterized by per-control-point lateral offsets
alpha ∈ [0, 1]: control point i is `left_i + alpha_i * (right_i - left_i)`
(reference src/track.py:82-87).  For closed tracks alpha wraps (the duplicated
last cone reuses alpha_0).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from lap_time_optimization.ops import spline
from lap_time_optimization.utils import io


def is_closed(left: np.ndarray, right: np.ndarray) -> bool:
    """A track is closed iff first == last cone on both sides (src/utils.py:17-22)."""
    return bool(np.all(left[:, 0] == left[:, -1]) and np.all(right[:, 0] == right[:, -1]))


def shrink_boundaries(left: np.ndarray, right: np.ndarray, usable_width: float):
    """Shrink both boundaries toward the centerline by the unusable fraction.

    `usable_width` ∈ [0.001, 1.0] is the fraction of track width the car may
    use; each boundary moves inward by (1-usable)/2 of the local width
    (reference src/track.py:96-118, clamping at src/track.py:17-21).
    """
    usable_width = min(1.0, max(0.001, usable_width))
    margin = (1.0 - usable_width) / 2.0
    diff = right - left
    return left + margin * diff, right - margin * diff


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Track:
    """Track geometry as a pytree; static metadata marks shapes/name.

    `size` is the number of *independent* control points (closed tracks drop
    the duplicated last cone), `ns` the per-metre sample count derived from the
    centerline length — both fixed at load time like the reference
    (src/track.py:24, src/trajectory.py:35).
    """

    left: jax.Array  # (2, n_cones) shrunk left boundary
    right: jax.Array  # (2, n_cones) shrunk right boundary
    diffs: jax.Array  # (2, n_cones) right - left
    widths: jax.Array  # (n_cones,) boundary-to-boundary distance
    old_left: jax.Array  # (2, n_cones) original (unshrunk) boundary, for plots
    old_right: jax.Array  # (2, n_cones)
    length: jax.Array  # scalar: centerline chord length
    closed: bool = dataclasses.field(metadata=dict(static=True), default=True)
    size: int = dataclasses.field(metadata=dict(static=True), default=0)
    ns: int = dataclasses.field(metadata=dict(static=True), default=0)
    name: str = dataclasses.field(metadata=dict(static=True), default="")
    decongest_stride: int = dataclasses.field(metadata=dict(static=True), default=3)

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, name_or_path: str, track_width: float = 1.0) -> "Track":
        """Load a track JSON (by name or path) and apply the width shrink."""
        path = io.resolve_track(name_or_path)
        name, left, right = io.load_track_json(path)
        return cls.from_cones(left, right, track_width=track_width, name=name)

    @classmethod
    def from_cones(
        cls,
        left: np.ndarray,
        right: np.ndarray,
        track_width: float | None = None,
        name: str = "",
        old_left: np.ndarray | None = None,
        old_right: np.ndarray | None = None,
    ) -> "Track":
        left = np.asarray(left, dtype=np.float64)
        right = np.asarray(right, dtype=np.float64)
        if old_left is None:
            old_left, old_right = left, right
        if track_width is not None:
            left, right = shrink_boundaries(left, right, track_width)
        closed = is_closed(left, right)
        size = left.shape[1] - int(closed)
        diffs = right - left
        widths = np.hypot(diffs[0], diffs[1])
        mid = 0.5 * (left + right)
        # centerline chord length over all cones (incl. the closing segment)
        seg = np.hypot(*np.diff(mid, axis=1))
        length = float(np.sum(seg))
        ns = math.ceil(length)
        return cls(
            left=jnp.asarray(left),
            right=jnp.asarray(right),
            diffs=jnp.asarray(diffs),
            widths=jnp.asarray(widths),
            old_left=jnp.asarray(old_left),
            old_right=jnp.asarray(old_right),
            length=jnp.asarray(length),
            closed=closed,
            size=size,
            ns=ns,
            name=name,
        )

    # ------------------------------------------------------------- jax paths
    def control_points(self, alphas: jax.Array) -> jax.Array:
        """Map alphas (size,) to spline control points (2, n_cones).

        Closed tracks reuse alphas[0] for the duplicated final cone
        (reference src/track.py:82-87).
        """
        if self.closed:
            alphas = jnp.concatenate([alphas, alphas[:1]])
        return self.left + alphas[None, :] * self.diffs

    def mid_spline(self) -> spline.Spline2D:
        """Spline through the centerline (alphas = 0.5)."""
        alphas = jnp.full((self.size,), 0.5, dtype=self.left.dtype)
        return spline.fit(self.control_points(alphas), self.closed)

    def path_spline(self, alphas: jax.Array, method: str | None = None) -> spline.Spline2D:
        """Racing-line spline for an alpha vector.  `method` selects the
        closed-curve moment solve (see `spline.FIT_METHOD_CLOSED*`): batched
        forward-only callers pass `spline.FIT_METHOD_CLOSED_BATCHED`."""
        return spline.fit(self.control_points(alphas), self.closed, method)

    # --------------------------------------------------------- decongested BO
    @property
    def decongested_indices(self) -> np.ndarray:
        """Every 3rd *distinct* control-point index, the reduced BO
        parameterization (reference src/track.py:40-49; the reference strides
        over the duplicated-endpoint array, which is equivalent for tracks
        whose cone count is divisible by 3 and ill-defined otherwise — we
        always close the loop explicitly via `control_points_decongested`)."""
        return np.arange(0, self.size, self.decongest_stride)

    def control_points_decongested(self, alphas: jax.Array) -> jax.Array:
        """alphas over the decongested subset → control points (2, n_dec[+1]).

        Mirrors `control_points_bayesian` (reference src/track.py:89-94): the
        wrap duplicate uses alphas[0] again for closed tracks.
        """
        idx = jnp.asarray(self.decongested_indices)
        left = self.left[:, idx]
        diffs = self.diffs[:, idx]
        if self.closed:
            alphas = jnp.concatenate([alphas, alphas[:1]])
            left = jnp.concatenate([left, left[:, :1]], axis=1)
            diffs = jnp.concatenate([diffs, diffs[:, :1]], axis=1)
        return left + alphas[None, :] * diffs

    @property
    def n_decongested(self) -> int:
        return len(self.decongested_indices)
