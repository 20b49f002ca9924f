"""Native C++ geometry kernels vs their numpy fallbacks (exact parity)."""

import numpy as np
import pytest

from lap_time_optimization.utils import corners as corner_utils
from lap_time_optimization.utils import native


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("native toolchain unavailable; numpy fallback covered elsewhere")
    return True


class TestNearestDistances:
    def test_matches_numpy(self, built, rng):
        path = rng.standard_normal((2, 300)) * 50
        boundary = rng.standard_normal((2, 400)) * 50
        got = native.nearest_distances(path, boundary)
        dx = path[0][:, None] - boundary[0][None, :]
        dy = path[1][:, None] - boundary[1][None, :]
        ref = np.sqrt(np.min(dx * dx + dy * dy, axis=1))
        np.testing.assert_allclose(got, ref, rtol=1e-12)

    def test_single_point(self, built):
        got = native.nearest_distances(np.zeros((2, 1)), np.asarray([[3.0], [4.0]]))
        np.testing.assert_allclose(got, [5.0])


class TestFilterCorners:
    def test_matches_python_fallback(self, built, rng):
        for trial in range(20):
            n = 200
            mask = rng.random(n) < 0.4
            mask[0] = False  # already "shifted" form
            dists = np.cumsum(rng.uniform(0.5, 2.0, n))
            got = native.filter_corners_shifted(mask.copy(), dists, length=4.0, proximity=8.0)
            ref = corner_utils._drop_short_corners(
                corner_utils._merge_short_straights(mask.copy(), dists, 8.0), dists, 4.0
            )
            np.testing.assert_array_equal(got, ref)

    def test_full_pipeline_identical_with_and_without_native(self, built, buckmore, monkeypatch):
        from lap_time_optimization.optim import racing_line

        corners_native, mask_native = racing_line.detect_track_corners(buckmore)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
        corners_py, mask_py = racing_line.detect_track_corners(buckmore)
        np.testing.assert_array_equal(corners_native, corners_py)
        np.testing.assert_array_equal(mask_native, mask_py)
