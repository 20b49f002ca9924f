"""Velocity-profile solver vs an independent numpy oracle.

The oracle re-derives the reference's quasi-static 3-pass semantics
(src/velocity.py:9-76) directly from its specification: local lateral limit,
then single forward/backward sweeps from the globally slowest sample with
wraparound for closed laps.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lap_time_optimization.ops import spline, velocity


def oracle_profile(vehicle, s, k, s_max=None):
    """Sequential-numpy oracle for the 3-pass solve."""
    mu_g = float(vehicle.friction_coef) * 9.81
    v_local = np.sqrt(mu_g / np.maximum(np.asarray(k), 1e-12))
    n = len(s)
    i0 = int(np.argmin(v_local))

    # forward sweep (acceleration)
    sr, kr, vr = np.roll(s, -i0), np.roll(np.asarray(k), -i0), np.roll(v_local, -i0)
    wrap_f = (n - i0) % n  # rolled position of original sample 0
    for j in range(n):
        v_prev = vr[j - 1]
        if j == wrap_f and s_max is None:
            continue
        if vr[j] > v_prev:
            force = min(float(vehicle.engine_force(v_prev)), float(vehicle.traction(v_prev, kr[j - 1])))
            a = force / float(vehicle.mass)
            ds = (sr[j] - sr[j - 1]) % s_max if s_max is not None else sr[j] - sr[j - 1]
            vr[j] = min(vr[j], np.sqrt(v_prev**2 + 2 * a * ds))
    v_acc = np.roll(vr, i0)

    # backward sweep (braking)
    sf = np.flip(np.roll(s, -i0))
    kf = np.flip(np.roll(np.asarray(k), -i0))
    vf = np.flip(np.roll(v_local, -i0))
    for j in range(n):
        v_prev = vf[j - 1]
        if j == i0 and s_max is None:
            continue
        if vf[j] > v_prev:
            decel = float(vehicle.traction(v_prev, kf[j - 1])) / float(vehicle.mass)
            ds = (sf[j - 1] - sf[j]) % s_max if s_max is not None else sf[j - 1] - sf[j]
            vf[j] = min(vf[j], np.sqrt(v_prev**2 + 2 * decel * ds))
    v_dec = np.roll(np.flip(vf), i0)
    return np.minimum(v_acc, v_dec)


@pytest.fixture(scope="module")
def buckmore_samples(buckmore):
    sp = buckmore.mid_spline()
    s = np.linspace(0.0, float(sp.length), buckmore.ns)[:-1]
    k = np.asarray(spline.curvature(sp, jnp.asarray(s), signed=False))
    return s, k, float(sp.length)


class TestProfileVsOracle:
    def test_closed_tbr18(self, tbr18, buckmore_samples):
        s, k, s_max = buckmore_samples
        ours = np.asarray(
            velocity.solve_profile(tbr18, jnp.asarray(s), jnp.asarray(k), s_max, closed=True)
        )
        ref = oracle_profile(tbr18, s, k, s_max)
        np.testing.assert_allclose(ours, ref, rtol=1e-8)

    def test_closed_mx5(self, mx5, buckmore_samples):
        s, k, s_max = buckmore_samples
        ours = np.asarray(
            velocity.solve_profile(mx5, jnp.asarray(s), jnp.asarray(k), s_max, closed=True)
        )
        ref = oracle_profile(mx5, s, k, s_max)
        np.testing.assert_allclose(ours, ref, rtol=1e-8)

    def test_open_track(self, tbr18, buckmore_samples):
        s, k, s_max = buckmore_samples
        s_open, k_open = s[:400], k[:400]
        ours = np.asarray(
            velocity.solve_profile(tbr18, jnp.asarray(s_open), jnp.asarray(k_open), None, closed=False)
        )
        ref = oracle_profile(tbr18, s_open, k_open, None)
        np.testing.assert_allclose(ours, ref, rtol=1e-8)

    def test_profile_below_local_limit(self, tbr18, buckmore_samples):
        s, k, s_max = buckmore_samples
        v = np.asarray(
            velocity.solve_profile(tbr18, jnp.asarray(s), jnp.asarray(k), s_max, closed=True)
        )
        v_loc = np.asarray(velocity.local_limit(tbr18, jnp.asarray(k)))
        assert np.all(v <= v_loc + 1e-9)
        assert np.all(v > 0)

    def test_lap_time_positive_and_reasonable(self, tbr18, buckmore_samples):
        s, k, s_max = buckmore_samples
        v = velocity.solve_profile(tbr18, jnp.asarray(s), jnp.asarray(k), s_max, closed=True)
        s_full = np.append(s, s_max)
        t = float(velocity.lap_time(jnp.asarray(s_full), v))
        # centerline lap on buckmore+tbr18 should be tens of seconds
        assert 20.0 < t < 120.0


class TestAnalyticCases:
    def test_constant_curvature_circle(self, tbr18):
        """On a constant-curvature lap the profile equals the lateral limit."""
        radius = 20.0
        n = 400
        s = np.linspace(0, 2 * np.pi * radius, n, endpoint=False)
        k = np.full(n, 1.0 / radius)
        v = np.asarray(
            velocity.solve_profile(tbr18, jnp.asarray(s), jnp.asarray(k), 2 * np.pi * radius, closed=True)
        )
        expected = np.sqrt(float(tbr18.friction_coef) * 9.81 * radius)
        np.testing.assert_allclose(v, expected, rtol=1e-9)

    def test_differentiable(self, tbr18, buckmore):
        import jax

        def lap(alphas):
            sp = buckmore.path_spline(alphas)
            s = jnp.linspace(0.0, sp.length, buckmore.ns)
            kk = spline.curvature(sp, s[:-1], signed=False)
            v = velocity.solve_profile(tbr18, s[:-1], kk, sp.length, closed=True)
            return velocity.lap_time(s, v)

        alphas = jnp.full((buckmore.size,), 0.5)
        g = jax.grad(lap)(alphas)
        assert bool(jnp.all(jnp.isfinite(g)))
        assert float(jnp.linalg.norm(g)) > 0


class TestParallelSolver:
    """Log-depth associative-scan variant must converge to the sequential
    profile (SURVEY.md §5 sequence-parallel plan)."""

    def test_matches_sequential_tbr18(self, tbr18, buckmore_samples):
        s, k, s_max = buckmore_samples
        vs = np.asarray(velocity.solve_profile(tbr18, jnp.asarray(s), jnp.asarray(k), s_max, closed=True))
        vp = np.asarray(
            velocity.solve_profile_parallel(tbr18, jnp.asarray(s), jnp.asarray(k), s_max, closed=True, sweeps=24)
        )
        np.testing.assert_allclose(vp, vs, rtol=1e-6)

    def test_matches_sequential_mx5_few_sweeps(self, mx5, buckmore_samples):
        s, k, s_max = buckmore_samples
        vs = np.asarray(velocity.solve_profile(mx5, jnp.asarray(s), jnp.asarray(k), s_max, closed=True))
        vp = np.asarray(
            velocity.solve_profile_parallel(mx5, jnp.asarray(s), jnp.asarray(k), s_max, closed=True, sweeps=4)
        )
        np.testing.assert_allclose(vp, vs, rtol=1e-5)

    def test_open_track(self, tbr18, buckmore_samples):
        s, k, _ = buckmore_samples
        s_o, k_o = s[:400], k[:400]
        vs = np.asarray(velocity.solve_profile(tbr18, jnp.asarray(s_o), jnp.asarray(k_o), None, closed=False))
        vp = np.asarray(
            velocity.solve_profile_parallel(tbr18, jnp.asarray(s_o), jnp.asarray(k_o), None, closed=False, sweeps=24)
        )
        np.testing.assert_allclose(vp, vs, rtol=1e-6)

    def test_vmappable(self, tbr18, buckmore_samples, rng):
        import jax

        s, k, s_max = buckmore_samples
        k_batch = jnp.asarray(np.stack([k * f for f in (0.9, 1.0, 1.1)]))
        vp = jax.vmap(
            lambda kk: velocity.solve_profile_parallel(tbr18, jnp.asarray(s), kk, s_max, closed=True)
        )(k_batch)
        assert vp.shape == (3, len(s))
        assert bool(jnp.all(jnp.isfinite(vp)))
