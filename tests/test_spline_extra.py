"""Tests for the trigonometric and tension spline bases (ops/spline_extra.py)
and the simplify CLI — the finished version of the reference's unfinished
POLY/TRIG/HYP comparison (src/simplify.py:12-16).

Oracles: exact interpolation at the control sites, finite-difference
derivatives, analytic circles (the trig basis must reproduce a uniformly
sampled circle *exactly*), and the cubic spline of ops/spline as the τ→0
limit of the tension spline.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from lap_time_optimization.ops import spline, spline_extra

REF_DATA = os.environ.get("LTO_REF_DATA", "/root/reference/data")


def circle_points(n, r=10.0, closed=True):
    th = np.linspace(0.0, 2 * np.pi, n + 1)
    pts = np.stack([r * np.cos(th), r * np.sin(th)])
    return pts if closed else pts[:, : n // 2]


def wiggle_points(n=40, closed=True, seed=3):
    rng = np.random.default_rng(seed)
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    r = 10.0 + rng.normal(0, 0.8, n)
    pts = np.stack([r * np.cos(th), r * np.sin(th)])
    if closed:
        pts = np.concatenate([pts, pts[:, :1]], axis=1)
    return pts


def fd_check(ev, sp, u0, der, eps=1e-6, tol=1e-4):
    lo = ev(sp, jnp.asarray(u0 - eps), der - 1)
    hi = ev(sp, jnp.asarray(u0 + eps), der - 1)
    fd = (np.asarray(hi) - np.asarray(lo)) / (2 * eps)
    an = np.asarray(ev(sp, jnp.asarray(u0), der))
    np.testing.assert_allclose(an, fd, rtol=tol, atol=tol)


class TestTrigSpline:
    def test_interpolates_closed(self):
        pts = wiggle_points(closed=True)
        sp = spline_extra.trig_fit(jnp.asarray(pts), closed=True)
        got = np.asarray(spline_extra.trig_evaluate(sp, sp.nodes, 0))
        np.testing.assert_allclose(got, pts, atol=1e-8)

    def test_interpolates_open(self):
        pts = wiggle_points(closed=False)[:, :17]
        sp = spline_extra.trig_fit(jnp.asarray(pts), closed=False)
        got = np.asarray(spline_extra.trig_evaluate(sp, sp.nodes, 0))
        np.testing.assert_allclose(got, pts, atol=1e-7)

    def test_exact_on_uniform_circle(self):
        """Uniformly sampled circle = one Fourier harmonic: position exact
        everywhere (not just at nodes) and curvature exactly 1/r."""
        r = 7.5
        pts = circle_points(24, r=r)
        sp = spline_extra.trig_fit(jnp.asarray(pts), closed=True)
        u = jnp.linspace(0.0, float(sp.length), 257)
        pos = np.asarray(spline_extra.trig_evaluate(sp, u, 0))
        np.testing.assert_allclose(np.hypot(pos[0], pos[1]), r, rtol=1e-9)
        k = np.asarray(spline_extra.curvature(sp, u))
        np.testing.assert_allclose(k, 1.0 / r, rtol=1e-8)

    def test_derivatives_match_fd(self):
        pts = wiggle_points(closed=True)
        sp = spline_extra.trig_fit(jnp.asarray(pts), closed=True)
        u0 = np.linspace(1.0, float(sp.length) - 1.0, 9)
        fd_check(spline_extra.trig_evaluate, sp, u0, der=1)
        fd_check(spline_extra.trig_evaluate, sp, u0, der=2, tol=1e-3)


class TestTensionSpline:
    def test_interpolates_both_topologies(self):
        for closed in (True, False):
            pts = wiggle_points(closed=closed)
            sp = spline_extra.tension_fit(jnp.asarray(pts), closed=closed, tension=0.7)
            t = np.asarray(spline.chord_lengths(jnp.asarray(pts)))
            got = np.asarray(spline_extra.tension_evaluate(sp, jnp.asarray(t), 0))
            np.testing.assert_allclose(got, pts, atol=1e-8)

    def test_tau_to_zero_is_cubic(self):
        """As τ→0 the tension spline converges to the C² cubic spline."""
        pts = wiggle_points(closed=True)
        cub = spline.fit(jnp.asarray(pts), closed=True)
        ten = spline_extra.tension_fit(jnp.asarray(pts), closed=True, tension=1e-4)
        u = jnp.linspace(0.0, float(cub.length), 201)
        np.testing.assert_allclose(
            np.asarray(spline_extra.tension_evaluate(ten, u, 0)),
            np.asarray(spline.evaluate(cub, u, 0)),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(spline_extra.tension_evaluate(ten, u, 1)),
            np.asarray(spline.evaluate(cub, u, 1)),
            atol=1e-5,
        )

    def test_high_tension_tightens_to_polygon(self):
        """Large τ pulls the interpolant toward the control polygon: the
        max deviation from the chords must shrink vs the cubic spline."""
        pts = np.asarray(
            [[0, 1, 2, 3, 4, 5, 6, 7], [0, 1, -1, 1, -1, 1, -1, 0]], dtype=float
        )
        cub = spline.fit(jnp.asarray(pts), closed=False)
        ten = spline_extra.tension_fit(jnp.asarray(pts), closed=False, tension=8.0)
        # sample mid-interval overshoot of the y coordinate beyond [-1, 1]
        u = jnp.linspace(0.0, float(cub.length), 400)
        y_cub = np.asarray(spline.evaluate(cub, u, 0))[1]
        y_ten = np.asarray(spline_extra.tension_evaluate(ten, u, 0))[1]
        over_cub = np.maximum(np.abs(y_cub) - 1.0, 0.0).max()
        over_ten = np.maximum(np.abs(y_ten) - 1.0, 0.0).max()
        assert over_ten < 0.25 * over_cub

    def test_second_derivative_is_moment(self):
        pts = wiggle_points(closed=True)
        sp = spline_extra.tension_fit(jnp.asarray(pts), closed=True, tension=0.5)
        # x'' at the left knot of interval j equals the solved moment z_j
        t0 = sp.tk[:-1]
        d2 = np.asarray(spline_extra.tension_evaluate(sp, t0, 2))
        np.testing.assert_allclose(d2, np.asarray(sp.zj), atol=1e-8)

    def test_derivatives_match_fd(self):
        pts = wiggle_points(closed=True)
        sp = spline_extra.tension_fit(jnp.asarray(pts), closed=True, tension=1.2)
        u0 = np.asarray(sp.tk)[:-1][3:8] + 0.37  # interior points
        fd_check(spline_extra.tension_evaluate, sp, u0, der=1)
        fd_check(spline_extra.tension_evaluate, sp, u0, der=2, tol=1e-3)


class TestSimplifyCLI:
    @pytest.fixture(scope="class")
    def results(self, tmp_path_factory):
        if not os.path.isdir(REF_DATA):
            pytest.skip("reference data directory not available")
        from lap_time_optimization.cli.simplify import main

        out = tmp_path_factory.mktemp("simplify")
        return main(
            [
                os.path.join(REF_DATA, "tracks", "buckmore.json"),
                os.path.join(REF_DATA, "vehicles", "tbr18.json"),
                "0.8",
                "--all",
                "--plot-path",
                "--output-dir",
                str(out),
            ]
        ), out

    def test_all_bases_interpolate_and_agree(self, results):
        res, _ = results
        assert [r["basis"] for r in res] == ["poly", "trig", "hyp"]
        laps = {r["basis"]: r["lap_time_s"] for r in res}
        for r in res:
            assert r["fit_residual_m"] < 1e-6
            # centerline lap on buckmore+tbr18; bases differ in how much
            # curvature they concentrate at corners (tension/trig are
            # tighter than the cubic), so laps agree only loosely
            assert 35.0 < r["lap_time_s"] < 60.0
        assert abs(laps["poly"] - laps["hyp"]) / laps["poly"] < 0.15
        assert abs(laps["poly"] - laps["trig"]) / laps["poly"] < 0.20
        # cubic is the smoothest interpolant (it minimizes ∫|x''|²)
        assert res[0]["gamma2"] <= min(r["gamma2"] for r in res) + 1e-9

    def test_plots_written(self, results):
        res, out = results
        plot_dir = os.path.join(str(out), "plots", "tbr18", "buckmore", "simplify")
        for basis in ("poly", "trig", "hyp"):
            assert os.path.exists(os.path.join(plot_dir, f"path_{basis}.png"))
