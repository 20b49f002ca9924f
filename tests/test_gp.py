"""GP regression vs sklearn oracle (the reference's GP backend, tbn.py:161-162)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lap_time_optimization.ops import gp as gp_ops


@pytest.fixture(scope="module")
def dataset(rng):
    x = rng.uniform(0, 1, size=(30, 5))
    y = np.sin(3 * x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.1 * rng.standard_normal(30)
    return x, y


class TestKernel:
    def test_matern52_matches_sklearn(self, dataset):
        sklearn = pytest.importorskip("sklearn.gaussian_process.kernels")
        x, _ = dataset
        for ell in (0.3, 1.0, 2.7):
            ours = np.asarray(gp_ops.matern52(jnp.asarray(x), jnp.asarray(x), ell))
            ref = sklearn.Matern(nu=2.5, length_scale=ell)(x)
            np.testing.assert_allclose(ours, ref, atol=1e-10)


class TestFitPredict:
    def test_predict_matches_sklearn_at_fixed_lengthscale(self, dataset):
        GaussianProcessRegressor = pytest.importorskip(
            "sklearn.gaussian_process"
        ).GaussianProcessRegressor
        from sklearn.gaussian_process.kernels import Matern

        x, y = dataset
        ell = 0.8
        # build our GP at a fixed length scale (bypass MLE) to isolate algebra
        K = np.asarray(gp_ops.matern52(jnp.asarray(x), jnp.asarray(x), ell)) + 1e-10 * np.eye(30)
        L = np.linalg.cholesky(K)
        import scipy.linalg

        weights = scipy.linalg.cho_solve((L, True), y)
        ours = gp_ops.GP(
            x_train=jnp.asarray(x),
            chol=jnp.asarray(L),
            weights=jnp.asarray(weights),
            y_train=jnp.asarray(y),
            length_scale=jnp.asarray(ell),
            mask=jnp.ones((30,), dtype=bool),
        )
        xq = np.linspace(0, 1, 7)[:, None] * np.ones((1, 5))
        mean, std = gp_ops.predict(ours, jnp.asarray(xq))

        skl = GaussianProcessRegressor(
            kernel=Matern(nu=2.5, length_scale=ell), optimizer=None, alpha=1e-10
        ).fit(x, y)
        ref_mean, ref_std = skl.predict(xq, return_std=True)
        np.testing.assert_allclose(np.asarray(mean), ref_mean, atol=1e-8)
        np.testing.assert_allclose(np.asarray(std), ref_std, atol=1e-6)

    def test_mle_fit_reasonable(self, dataset):
        x, y = dataset
        model = gp_ops.fit(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        # interpolates training data closely at the fitted length scale
        mean, _ = gp_ops.predict(model, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(mean), y, atol=1e-3)
        assert 1e-3 < float(model.length_scale) < 1e3


@pytest.mark.slow
class TestGlobalSearch:
    """README-matrix parity gates at production budgets (seed 0, width 0.99):
    every column asserted at published×1.01 (reference README.md:121,130)."""

    def test_nonlinear_parity(self, buckmore99, tbr18):
        from lap_time_optimization.optim import global_search

        best_x, best_f = global_search.nonlinear(buckmore99, tbr18, seed=0)
        assert best_x.shape == (buckmore99.n_decongested,)
        # measured 36.260 vs published 36.178
        assert best_f < 36.178 * 1.01

    def test_bayesian_parity(self, buckmore99, tbr18):
        from lap_time_optimization.optim import global_search

        best_x, best_f, info = global_search.bayesian(buckmore99, tbr18, seed=0)
        # measured 36.249 vs published 36.227
        assert best_f < 36.227 * 1.01
        assert len(info["sigma_history"]) == info["rounds"]

    def test_bayesian_parity_mx5(self, buckmore99, mx5):
        from lap_time_optimization.optim import global_search

        _, best_f, _ = global_search.bayesian(buckmore99, mx5, seed=0)
        assert best_f < 48.056 * 1.01

    def test_bayesian_small_budget_converges(self, buckmore, tbr18, tmp_path):
        """Budget-override smoke: the σ-based stop rule with tiny budgets,
        plus the liveness heartbeat surface (SURVEY §5 failure detection)."""
        import json

        from lap_time_optimization.optim import global_search

        hb = str(tmp_path / "bo_heartbeat.json")
        best_x, best_f, info = global_search.bayesian(
            buckmore, tbr18, seed=0, n_init=6, n_local=16, n_uniform=16,
            max_rounds=6, min_samples=5, sigma_window=4, polish_every=3,
            polish_iters=60, heartbeat_path=hb,
        )
        assert best_f < 42.0
        assert info["rounds"] <= 6
        assert len(info["sigma_history"]) == info["rounds"]
        beat = json.load(open(hb))["heartbeat"]
        assert beat["round"] == info["rounds"] and beat["best"] <= 42.0


class TestPaddedFit:
    def test_padded_equals_unpadded(self, dataset):
        import jax

        x, y = dataset
        key = jax.random.PRNGKey(1)
        plain = gp_ops.fit(jnp.asarray(x), jnp.asarray(y), key)
        cap = 48
        xp = np.zeros((cap, x.shape[1]))
        yp = np.zeros(cap)
        xp[:30] = x
        yp[:30] = y
        mask = jnp.arange(cap) < 30
        padded = gp_ops.fit(jnp.asarray(xp), jnp.asarray(yp), key, mask=mask)
        np.testing.assert_allclose(
            float(padded.length_scale), float(plain.length_scale), rtol=1e-6
        )
        xq = np.linspace(0, 1, 5)[:, None] * np.ones((1, x.shape[1]))
        m1, s1 = gp_ops.predict(plain, jnp.asarray(xq))
        m2, s2 = gp_ops.predict(padded, jnp.asarray(xq))
        np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-8)
        np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), atol=1e-7)


@pytest.mark.slow
class TestCheckpointResume:
    def test_bayesian_resume(self, buckmore, tbr18, tmp_path):
        from lap_time_optimization.optim import global_search

        ck = str(tmp_path / "bo.npz")
        kw = dict(seed=0, n_init=4, n_local=8, n_uniform=8, min_samples=3,
                  sigma_window=3, checkpoint_path=ck)
        # run 3 rounds, then resume for 2 more; the resumed run must continue
        # from the saved dataset (more samples than a fresh 2-round run)
        _, _, info1 = global_search.bayesian(buckmore, tbr18, max_rounds=3, **kw)
        import os
        assert os.path.isfile(ck)
        _, best2, info2 = global_search.bayesian(buckmore, tbr18, max_rounds=5, **kw)
        assert info2["n_samples"] >= info1["n_samples"]
        assert best2 < 60.0


class TestChunkedRefinement:
    """Host-chunked L-BFGS segments must be step-for-step identical to one
    long program (the chunking bounds each device program's duration and
    gives the host checkpoint points — see optimize.minimize_bounded_chunked)."""

    def test_chunked_equals_single_program(self, buckmore, tbr18):
        from lap_time_optimization.optim import global_search

        d = buckmore.n_decongested
        key = jax.random.PRNGKey(7)
        x0 = jax.random.uniform(key, (d,), buckmore.left.dtype, 0.0, 0.99)

        # chunk=100 > max_iter runs everything in ONE device program; chunk=7
        # crosses the jit boundary 5 times.  Identical compiled loop body =>
        # bitwise-identical iterates regardless of segmentation.
        one = global_search._refine_chunked(buckmore, tbr18, x0, 30, "scan", chunk=100)
        seg = global_search._refine_chunked(buckmore, tbr18, x0, 30, "scan", chunk=7)
        assert int(seg.n_iter) == int(one.n_iter)
        np.testing.assert_allclose(np.asarray(seg.x), np.asarray(one.x), rtol=1e-12)
        np.testing.assert_allclose(float(seg.fun), float(one.fun), rtol=1e-12)

    def test_chunked_batched_matches_single_segment(self, buckmore, tbr18):
        from lap_time_optimization.optim import global_search

        d = buckmore.n_decongested
        seeds = jax.random.uniform(jax.random.PRNGKey(3), (3, d), buckmore.left.dtype, 0.0, 0.99)
        t0 = global_search._batch_lap_times(buckmore, tbr18, seeds, "scan")
        one = global_search._refine_chunked(buckmore, tbr18, seeds, 20, "scan", chunk=100, batched=True)
        seg = global_search._refine_chunked(buckmore, tbr18, seeds, 20, "scan", chunk=6, batched=True)
        # segmentation is exact within the (identical-shape) vmapped program
        np.testing.assert_allclose(np.asarray(seg.x), np.asarray(one.x), rtol=1e-12)
        # and the refinement actually improves every seed
        assert np.all(np.asarray(seg.fun) < np.asarray(t0))

    def test_assoc_solver_objective_close_to_scan(self, buckmore, tbr18):
        from lap_time_optimization.optim import global_search

        d = buckmore.n_decongested
        x = jax.random.uniform(jax.random.PRNGKey(11), (5, d), buckmore.left.dtype, 0.0, 0.99)
        t_scan = global_search._batch_lap_times(buckmore, tbr18, x, "scan")
        t_assoc = global_search._batch_lap_times(buckmore, tbr18, x, "assoc")
        np.testing.assert_allclose(np.asarray(t_assoc), np.asarray(t_scan), rtol=2e-3)


class TestNaNHygiene:
    """f32 proposal batches can contain NaN lap times (degenerate spline fits);
    these must be discarded, not poison argmin/the GP (found in an f32 run:
    jnp.argmin returns the NaN index, which sent a garbage candidate to the
    top of the BO dataset and NaN'd the σ stop rule)."""

    def test_gp_targets_replace_nonfinite(self):
        from lap_time_optimization.optim.global_search import _gp_targets

        y = jnp.asarray([40.0, jnp.inf, 37.0, jnp.nan, 99.0])
        mask = jnp.asarray([True, True, True, True, False])
        out = np.asarray(_gp_targets(y, mask))
        np.testing.assert_allclose(out, [40.0, 40.0, 37.0, 40.0, 0.0])

    def test_gp_targets_all_nonfinite(self):
        """Degenerate edge (VERDICT r3 weak #6): if EVERY live observation is
        non-finite there is no worst finite lap to substitute; targets must
        fall back to finite values (0), not -inf, or the substitution itself
        poisons the Cholesky it exists to protect."""
        from lap_time_optimization.optim.global_search import _gp_targets

        y = jnp.asarray([jnp.inf, jnp.nan, jnp.inf, 50.0])
        mask = jnp.asarray([True, True, True, False])
        out = np.asarray(_gp_targets(y, mask))
        assert np.all(np.isfinite(out))
        np.testing.assert_allclose(out, [0.0, 0.0, 0.0, 0.0])

    def test_batch_lap_times_never_nan(self, buckmore, tbr18):
        from lap_time_optimization.optim import global_search

        d = buckmore.n_decongested
        x = jax.random.uniform(jax.random.PRNGKey(5), (8, d), buckmore.left.dtype, 0.0, 0.99)
        t = np.asarray(global_search._batch_lap_times(buckmore, tbr18, x, "scan"))
        assert not np.any(np.isnan(t))
