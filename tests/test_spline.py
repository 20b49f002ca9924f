"""Spline kernels vs scipy oracles (SURVEY.md §4 test plan: geometry unit tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.interpolate import CubicSpline, splev, splprep

from lap_time_optimization.ops import spline


def _closed_controls(track):
    alphas = jnp.full((track.size,), 0.5)
    return np.asarray(track.control_points(alphas))


class TestClosedSplineVsFitpack:
    """The periodic C² cubic interpolant is unique, so our moment-form fit must
    reproduce FITPACK's `splprep(..., per=1)` to roundoff."""

    @pytest.fixture(scope="class")
    def fitted(self, buckmore):
        controls = _closed_controls(buckmore)
        sp = spline.fit(jnp.asarray(controls), closed=True)
        dists = np.asarray(spline.chord_lengths(jnp.asarray(controls)))
        tck, _ = splprep(controls, u=dists, k=3, s=0, per=1)
        return sp, tck, dists

    def test_positions(self, fitted, rng):
        sp, tck, dists = fitted
        u = rng.uniform(0, dists[-1], size=500)
        ours = np.asarray(spline.evaluate(sp, jnp.asarray(u)))
        ref = np.asarray(splev(u, tck))
        np.testing.assert_allclose(ours, ref, atol=1e-8)

    def test_interpolates_controls(self, fitted):
        sp, _, dists = fitted
        ours = np.asarray(spline.evaluate(sp, jnp.asarray(dists)))
        np.testing.assert_allclose(ours, np.asarray(sp.controls), atol=1e-9)

    def test_derivatives(self, fitted, rng):
        sp, tck, dists = fitted
        u = rng.uniform(0, dists[-1], size=300)
        for der in (1, 2):
            ours = np.asarray(spline.evaluate(sp, jnp.asarray(u), der=der))
            ref = np.asarray(splev(u, tck, der=der))
            np.testing.assert_allclose(ours, ref, atol=1e-8)

    def test_curvature_and_gamma2(self, fitted, rng):
        sp, tck, dists = fitted
        u = rng.uniform(0, dists[-1], size=400)
        d1 = np.asarray(splev(u, tck, der=1))
        d2 = np.asarray(splev(u, tck, der=2))
        k_ref = (d1[0] * d2[1] - d1[1] * d2[0]) / (d1[0] ** 2 + d1[1] ** 2) ** 1.5
        k_ours = np.asarray(spline.curvature(sp, jnp.asarray(u), signed=True))
        np.testing.assert_allclose(k_ours, k_ref, atol=1e-10)
        np.testing.assert_allclose(
            float(spline.gamma2(sp, jnp.asarray(u))), np.sum(k_ref**2), rtol=1e-10
        )


class TestTridiagVsDense:
    """The O(n) cyclic Thomas + Sherman–Morrison moment solve (the production
    closed-spline path, VERDICT r4 item 5) must agree with the O(n³) dense
    solve to roundoff — values AND gradients (the search differentiates
    through the fit)."""

    def test_moments_match(self, buckmore, rng):
        controls = jnp.asarray(_closed_controls(buckmore))
        sp_t = spline.fit(controls, closed=True, method="tridiag")
        sp_d = spline.fit(controls, closed=True, method="dense")
        np.testing.assert_allclose(np.asarray(sp_t.Mj), np.asarray(sp_d.Mj), atol=1e-9)
        u = rng.uniform(0, float(sp_d.length), size=300)
        np.testing.assert_allclose(
            np.asarray(spline.curvature(sp_t, jnp.asarray(u))),
            np.asarray(spline.curvature(sp_d, jnp.asarray(u))),
            atol=1e-10,
        )

    def test_gradients_match(self, buckmore):
        alphas = jnp.full((buckmore.size,), 0.4, buckmore.left.dtype)

        def g2(a, method):
            controls = buckmore.control_points(a)
            sp = spline.fit(controls, closed=True, method=method)
            u = jnp.linspace(0.0, sp.length, 200)
            return spline.gamma2(sp, u[:-1])

        gt = jax.grad(lambda a: g2(a, "tridiag"))(alphas)
        gd = jax.grad(lambda a: g2(a, "dense"))(alphas)
        np.testing.assert_allclose(np.asarray(gt), np.asarray(gd), atol=1e-7)


class TestOpenSpline:
    def test_matches_cubicspline_notaknot(self, rng):
        t = np.sort(rng.uniform(0, 10, size=40))
        t[0], t[-1] = 0.0, 10.0
        x = np.cos(t) + 0.1 * rng.standard_normal(40)
        y = np.sin(t) + 0.1 * rng.standard_normal(40)
        pts = np.stack([x, y])
        # our fit parameterizes by chord length; oracle uses the same parameter
        dists = np.asarray(spline.chord_lengths(jnp.asarray(pts)))
        sp = spline.fit(jnp.asarray(pts), closed=False)
        cs_x = CubicSpline(dists, x, bc_type="not-a-knot")
        cs_y = CubicSpline(dists, y, bc_type="not-a-knot")
        u = rng.uniform(0, dists[-1], size=200)
        ours = np.asarray(spline.evaluate(sp, jnp.asarray(u)))
        np.testing.assert_allclose(ours[0], cs_x(u), atol=1e-8)
        np.testing.assert_allclose(ours[1], cs_y(u), atol=1e-8)
        for der in (1, 2):
            od = np.asarray(spline.evaluate(sp, jnp.asarray(u), der=der))
            np.testing.assert_allclose(od[0], cs_x(u, der), atol=1e-7)
            np.testing.assert_allclose(od[1], cs_y(u, der), atol=1e-7)


class TestDifferentiabilityAndBatching:
    def test_grad_of_gamma2_wrt_alphas(self, buckmore):
        def obj(alphas):
            sp = buckmore.path_spline(alphas)
            s = jnp.linspace(0.0, sp.length, buckmore.ns)
            return spline.gamma2(sp, s)

        alphas = jnp.full((buckmore.size,), 0.5)
        g = jax.grad(obj)(alphas)
        assert g.shape == (buckmore.size,)
        assert bool(jnp.all(jnp.isfinite(g)))
        # finite-difference check on a few coordinates
        f0 = float(obj(alphas))
        for i in [0, 17, 63]:
            h = 1e-6
            fp = float(obj(alphas.at[i].add(h)))
            np.testing.assert_allclose(float(g[i]), (fp - f0) / h, rtol=2e-3, atol=1e-4)

    def test_vmap_over_alpha_batch(self, buckmore, rng):
        alphas = jnp.asarray(rng.uniform(0.2, 0.8, size=(8, buckmore.size)))

        def g2(a):
            sp = buckmore.path_spline(a)
            s = jnp.linspace(0.0, sp.length, buckmore.ns)
            return spline.gamma2(sp, s)

        batched = jax.vmap(g2)(alphas)
        serial = jnp.stack([g2(a) for a in alphas])
        np.testing.assert_allclose(np.asarray(batched), np.asarray(serial), rtol=1e-9)

    def test_arc_length_table(self, buckmore):
        sp = buckmore.mid_spline()
        u, arc = spline.arc_length_table(sp, n_samples=1000)
        assert float(arc[0]) == 0.0
        assert bool(jnp.all(jnp.diff(arc) >= 0))
        # arc length within ~1% of chord-length parameter total
        np.testing.assert_allclose(float(arc[-1]), float(sp.length), rtol=2e-2)
        # round trip: u(s(u)) ≈ u
        s_query = jnp.linspace(0.0, float(arc[-1]), 50)
        u_back = spline.u_of_arc_length(u, arc, s_query)
        assert bool(jnp.all(jnp.diff(u_back) > 0))
