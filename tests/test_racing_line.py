"""End-to-end racing-line parity vs the reference README baselines.

Golden oracles (SURVEY.md §4): README results tables for buckmore
(README.md:119-134).  Tolerances are method-appropriate: gradient methods on
a non-convex landscape land on slightly different minimizers than the
reference's finite-difference L-BFGS-B, so lap times are gated at ~2%, while
the direct lap-time method must *beat* the reference (we have exact
gradients through the velocity solver; the reference numerically
differentiates the whole 3-pass solve).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lap_time_optimization.optim import racing_line

REF_CURVATURE_LAP_TBR18 = 39.934  # README.md:121
REF_COMPROMISE_LAP_TBR18 = 37.810  # README.md:121
REF_LAPTIME_LAP_TBR18 = 40.892  # README.md:121
REF_CURVATURE_LAP_MX5 = 49.172  # README.md:130
REF_COMPROMISE_LAP_MX5 = 47.730  # README.md:130
REF_LAPTIME_LAP_MX5 = 53.648  # README.md:130


class TestCurvatureMethod:
    @pytest.fixture(scope="class")
    def result(self, buckmore):
        res = racing_line.minimise_curvature(buckmore, max_iter=600)
        return res

    def test_converges(self, result):
        assert float(result.grad_norm) < 1e-2
        assert np.all(np.asarray(result.x) >= 0.0) and np.all(np.asarray(result.x) <= 1.0)

    def test_gamma2_at_least_as_good_as_reference_optimum(self, buckmore, result):
        """Our optimizer must reach a Γ² at least as low as scipy L-BFGS-B
        (the reference's optimizer) achieves on the identical objective."""
        from scipy.optimize import Bounds, minimize

        import jax

        obj = jax.jit(lambda a: racing_line.gamma2_objective(buckmore, a))
        grad = jax.jit(jax.grad(lambda a: racing_line.gamma2_objective(buckmore, a)))
        res_sp = minimize(
            lambda a: float(obj(jnp.asarray(a))),
            np.full(buckmore.size, 0.5),
            jac=lambda a: np.asarray(grad(jnp.asarray(a))),
            method="L-BFGS-B",
            bounds=Bounds(0.0, 1.0),
        )
        assert float(result.fun) <= res_sp.fun * 1.001

    @pytest.mark.slow
    def test_lap_time_near_reference(self, buckmore99, tbr18):
        """README tables were produced at width≈0.99 (verified empirically);
        gate: no more than 1% WORSE than published (better is a win, not a
        parity failure) — BASELINE.md lap-time tolerance."""
        res = racing_line.minimise_curvature(buckmore99, max_iter=600)
        lap, length, v, _ = racing_line.evaluate_jit(buckmore99, tbr18, res.x)
        assert float(lap) < REF_CURVATURE_LAP_TBR18 * 1.01
        assert abs(float(length) - 860.772) / 860.772 < 0.01

    @pytest.mark.slow
    def test_lap_time_near_reference_mx5(self, buckmore99, mx5):
        res = racing_line.minimise_curvature(buckmore99, max_iter=600)
        lap, _, _, _ = racing_line.evaluate_jit(buckmore99, mx5, res.x)
        assert float(lap) < REF_CURVATURE_LAP_MX5 * 1.01


@pytest.mark.slow
class TestDirectLapTime:
    def test_beats_reference(self, buckmore99, tbr18):
        res = racing_line.minimise_lap_time(buckmore99, tbr18, max_iter=300)
        lap, _, _, _ = racing_line.evaluate_jit(buckmore99, tbr18, res.x)
        # exact gradients must BEAT the reference's finite-difference result
        # (measured 36.420 vs published 40.892)
        assert float(lap) < REF_LAPTIME_LAP_TBR18

    def test_beats_reference_mx5(self, buckmore99, mx5):
        res = racing_line.minimise_lap_time(buckmore99, mx5, max_iter=300)
        lap, _, _, _ = racing_line.evaluate_jit(buckmore99, mx5, res.x)
        # measured 52.011 vs published 53.648
        assert float(lap) < REF_LAPTIME_LAP_MX5


@pytest.mark.slow
class TestCompromise:
    def test_optimal_compromise_parity(self, buckmore99, tbr18):
        """Full README-matrix gate at production budget: published×1.01
        (measured 37.780 vs published 37.810 — beats it)."""
        alphas, epsilon, history = racing_line.minimise_optimal_compromise(buckmore99, tbr18)
        assert 0.0 <= epsilon <= 0.2  # reference bounds, src/trajectory.py:99
        lap, _, _, _ = racing_line.evaluate_jit(buckmore99, tbr18, alphas)
        assert float(lap) < REF_COMPROMISE_LAP_TBR18 * 1.01
        assert history.shape[1] == 2

    def test_optimal_compromise_parity_mx5(self, buckmore99, mx5):
        """Measured 46.070 vs published 47.730 — beats it."""
        alphas, _, _ = racing_line.minimise_optimal_compromise(buckmore99, mx5)
        lap, _, _, _ = racing_line.evaluate_jit(buckmore99, mx5, alphas)
        assert float(lap) < REF_COMPROMISE_LAP_MX5 * 1.01

    def test_estimated_compromise(self, buckmore99, tbr18):
        """No README column exists for --estimated; the binding relative gate
        is that the estimated-ε heuristic must stay within striking distance
        of the tuned compromise (37.810) and decisively beat 40.0
        (measured 38.384 at this budget)."""
        alphas, epsilon = racing_line.minimise_estimated_compromise(buckmore99, tbr18, max_iter=200)
        assert 0.0 < epsilon < 0.2
        lap, _, _, _ = racing_line.evaluate_jit(buckmore99, tbr18, alphas)
        assert float(lap) < 40.0


@pytest.mark.slow
class TestSectors:
    def test_sector_merge(self, buckmore99, tbr18):
        """No README column exists for --sectors; the binding relative gate is
        that per-sector compromise + cross-fade merging must beat the plain
        curvature line (published 39.934) — it optimizes lap time per sector,
        so losing to pure geometry would mean the merge destroys the gains
        (measured 38.902 at this budget)."""
        alphas, eps_w, corners = racing_line.optimise_sectors(
            buckmore99, tbr18, n_grid=4, max_iter=150
        )
        assert alphas.shape == (buckmore99.size,)
        assert np.all(np.asarray(alphas) >= -1e-9) and np.all(np.asarray(alphas) <= 1.0 + 1e-9)
        assert len(eps_w) == corners.shape[0]
        lap, _, _, _ = racing_line.evaluate_jit(buckmore99, tbr18, jnp.clip(alphas, 0.0, 1.0))
        assert float(lap) < REF_CURVATURE_LAP_TBR18
