"""Track loading, width shrink, alpha mapping, corner detection."""

import jax.numpy as jnp
import numpy as np

from lap_time_optimization.track import Track, shrink_boundaries
from lap_time_optimization.utils import corners as corner_utils


class TestTrackLoad:
    def test_buckmore_closed(self, buckmore):
        assert buckmore.closed
        # buckmore.json holds 132 cone pairs with the first duplicated as the
        # last, so there are 131 independent control points (reference
        # src/track.py:24: size = count - closed)
        assert buckmore.size == 131
        assert buckmore.ns == int(np.ceil(float(buckmore.length)))
        assert 800 < float(buckmore.length) < 900

    def test_width_shrink(self):
        left = np.array([[0.0, 1.0, 2.0], [0.0, 0.0, 0.0]])
        right = np.array([[0.0, 1.0, 2.0], [4.0, 4.0, 4.0]])
        nl, nr = shrink_boundaries(left, right, usable_width=0.5)
        # each boundary moves in by 25% of the 4m width = 1m
        np.testing.assert_allclose(nl[1], 1.0)
        np.testing.assert_allclose(nr[1], 3.0)
        # clamping (reference src/track.py:17-21)
        nl2, nr2 = shrink_boundaries(left, right, usable_width=5.0)
        np.testing.assert_allclose(nl2, left)
        nl3, _ = shrink_boundaries(left, right, usable_width=-1.0)
        assert np.all(nl3[1] > 1.9)  # nearly collapsed to centerline

    def test_control_points_closed_wrap(self, buckmore):
        alphas = jnp.linspace(0.1, 0.9, buckmore.size)
        cp = np.asarray(buckmore.control_points(alphas))
        assert cp.shape == (2, buckmore.size + 1)
        np.testing.assert_allclose(cp[:, -1], cp[:, 0])

    def test_control_points_interpolate_boundaries(self, buckmore):
        cp0 = np.asarray(buckmore.control_points(jnp.zeros(buckmore.size)))
        cp1 = np.asarray(buckmore.control_points(jnp.ones(buckmore.size)))
        np.testing.assert_allclose(cp0[:, : buckmore.size], np.asarray(buckmore.left)[:, : buckmore.size])
        np.testing.assert_allclose(cp1[:, : buckmore.size], np.asarray(buckmore.right)[:, : buckmore.size])

    def test_decongested(self, buckmore):
        idx = buckmore.decongested_indices
        assert idx[0] == 0 and len(idx) == buckmore.n_decongested
        alphas = jnp.full((buckmore.n_decongested,), 0.5)
        cp = np.asarray(buckmore.control_points_decongested(alphas))
        assert cp.shape == (2, buckmore.n_decongested + 1)
        np.testing.assert_allclose(cp[:, -1], cp[:, 0])


class TestCornerUtils:
    def test_idx_modulo(self):
        np.testing.assert_array_equal(corner_utils.idx_modulo(2, 5, 10), [2, 3, 4])
        np.testing.assert_array_equal(corner_utils.idx_modulo(8, 2, 10), [8, 9, 0, 1])

    def test_filter_and_pairs_synthetic(self):
        # 100 samples at 1m spacing: corners at [10,30) and [35,40) and [60,62)
        is_corner = np.zeros(100, dtype=bool)
        is_corner[10:30] = True
        is_corner[35:40] = True
        is_corner[60:62] = True
        dists = np.arange(100.0)
        out = corner_utils.filter_corners(is_corner, dists, length=4.0, proximity=8.0)
        # the 5m straight [30,35) is < proximity → merged; corner [60,62) is
        # 2m < length → dropped
        assert out[10:40].all()
        assert not out[60:62].any()
        pairs = corner_utils.corner_idxs(out)
        assert pairs.shape == (1, 2)
        assert pairs[0][0] == 10 and pairs[0][1] == 40

    def test_detect_on_buckmore(self, buckmore):
        from lap_time_optimization.optim import racing_line

        corners, mask = racing_line.detect_track_corners(buckmore)
        assert corners.ndim == 2 and corners.shape[1] == 2
        assert corners.shape[0] >= 3  # buckmore has multiple real corners
        assert mask.dtype == bool and mask.any() and not mask.all()
        assert np.all(corners >= 0) and np.all(corners <= buckmore.size + 1)
