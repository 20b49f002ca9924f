"""Geometry robustness across all four shipped tracks (SURVEY.md §2.2)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from lap_time_optimization.ops import spline, velocity
from lap_time_optimization.track import Track

REF_TRACKS = os.environ.get("LTO_REF_DATA", "/root/reference/data") + "/tracks"

ALL_TRACKS = ["buckmore", "clay", "gyg", "whilton"]


@pytest.mark.parametrize("name", ALL_TRACKS)
class TestEveryTrack:
    @pytest.fixture()
    def track(self, name):
        path = os.path.join(REF_TRACKS, f"{name}.json")
        if not os.path.isfile(path):
            pytest.skip("reference tracks not available")
        return Track.load(path, track_width=0.8)

    def test_loads_closed(self, name, track):
        assert track.closed
        assert track.size > 100
        assert float(track.length) > 500

    def test_spline_and_profile_finite(self, name, track, tbr18):
        sp = track.mid_spline()
        s = jnp.linspace(0.0, sp.length, track.ns)
        k = spline.curvature(sp, s[:-1], signed=False)
        assert bool(jnp.all(jnp.isfinite(k)))
        v = velocity.solve_profile(tbr18, s[:-1], k, sp.length, closed=True)
        assert bool(jnp.all(jnp.isfinite(v))) and bool(jnp.all(v > 0))
        t = float(velocity.lap_time(s, v))
        assert 20.0 < t < 200.0

    @pytest.mark.slow
    def test_curvature_optimization_runs(self, name, track, tbr18):
        from lap_time_optimization.optim import racing_line

        res = racing_line.minimise_curvature(track, max_iter=150)
        lap, length, v, _ = racing_line.evaluate_jit(track, tbr18, res.x)
        assert np.isfinite(float(lap)) and float(lap) > 0
        # optimized line should beat the centerline
        sp = track.mid_spline()
        s = jnp.linspace(0.0, sp.length, track.ns)
        k = spline.curvature(sp, s[:-1], signed=False)
        v_mid = velocity.solve_profile(tbr18, s[:-1], k, sp.length, closed=True)
        t_mid = float(velocity.lap_time(s, v_mid))
        assert float(lap) < t_mid

    def test_corners_detected(self, name, track):
        from lap_time_optimization.optim import racing_line

        corners, mask = racing_line.detect_track_corners(track)
        assert corners.shape[0] >= 2
        assert mask.any()
