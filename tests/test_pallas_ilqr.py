"""Parity gates for the fused Pallas iLQR kernel (ops/pallas_ilqr.py).

The kernel runs in interpreter mode on CPU here, compared against the XLA
lax.scan path (`mpc/solver._backward_pass` + `_forward_pass`) on identical
inputs — same Riccati recursion, same line-search ladder, same AL cost.
Deviations are float rounding-order only.  The wrapper's padding, the
rung selection, the Triton lowering and the gradient refusal are checked
here too; compiled parity on the GPU is `chip_smoke.py`'s phase 3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lap_time_optimization.mpc import runner, solver as S
from lap_time_optimization.mpc import track as mpc_track
from lap_time_optimization.mpc.solver import N_CON, NU, OCPParams, SolverConfig
from lap_time_optimization.ops import pallas_ilqr as PK

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


@pytest.fixture(scope="module")
def stack(mx5):
    from lap_time_optimization.models.bicycle import BicycleModel

    d = os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")
    if not os.path.isdir(d):
        pytest.skip("shipped curvature artifacts not available")
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)
    return BicycleModel(vehicle=mx5, track=track)


def _cast(model, dtype):
    """Cast every float leaf of the model pytree (tables run f64 under the
    x64 test env; the f32 case exercises the production GPU precision)."""
    return jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        model,
    )


def _inputs(model, dtype, cfg, p, throttle=0.05):
    x0 = jnp.asarray(runner.X0_REFERENCE, dtype)
    z0 = jnp.concatenate([x0, jnp.zeros((NU,), dtype)])
    us = jnp.full((cfg.horizon, NU), throttle, dtype)
    lams = jnp.zeros((cfg.horizon + 1, S.n_con(model)), dtype)
    zs = S._rollout(model, cfg, z0, us)
    return z0, zs, us, lams


def _kernel_iteration(model, p, cfg, zs, us, lams, rho, reg):
    """One interpreted kernel iteration for a single instance."""
    cost, zs_k, us_k, div = S._iterate_kernel(
        model, p, cfg, zs[None], us[None], lams[None], rho, reg[None], interpret=True
    )
    return cost[0], zs_k[0], us_k[0], div[0]


class TestKernelParity:
    @pytest.mark.parametrize("dtype_name", ["float32", "float64"])
    def test_one_iteration_matches_xla(self, stack, dtype_name):
        dtype = jnp.dtype(dtype_name)
        model = _cast(stack, dtype)
        cfg = SolverConfig(horizon=10)
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        _, zs, us, lams = _inputs(model, dtype, cfg, p)
        rho = jnp.asarray(cfg.rho_init, dtype)
        reg = jnp.asarray(1e-6, dtype)

        cost_x, zs_x, us_x = S._forward_pass(
            model, p, cfg, zs, us,
            *S._backward_pass(model, p, cfg, zs, us, lams, rho, reg)[:2],
            lams, rho,
        )
        new_cost, zs_k, us_k, diverged = _kernel_iteration(
            model, p, cfg, zs, us, lams, rho, reg
        )
        tol = 1e-5 if dtype == jnp.float32 else 1e-11
        assert not bool(diverged)
        np.testing.assert_allclose(np.asarray(zs_k), np.asarray(zs_x), rtol=tol, atol=tol)
        np.testing.assert_allclose(np.asarray(us_k), np.asarray(us_x), rtol=tol, atol=tol)
        np.testing.assert_allclose(float(new_cost), float(cost_x), rtol=10 * tol)

    def test_full_solve_matches_xla(self, stack):
        dtype = jnp.float32
        model = _cast(stack, dtype)
        # small budget: interpreter mode executes op-by-op on host
        cfg_x = SolverConfig(horizon=10, al_iters=1, ilqr_iters=2, backend="xla")
        cfg_p = SolverConfig(horizon=10, al_iters=1, ilqr_iters=2, backend="interpret")
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        z0, _, us, lams = _inputs(model, dtype, cfg_x, p)
        r_x = S.solve(model, p, cfg_x, z0, us, lams)
        r_p = S.solve(model, p, cfg_p, z0, us, lams)
        np.testing.assert_allclose(np.asarray(r_p.us), np.asarray(r_x.us), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(r_p.cost), float(r_x.cost), rtol=1e-4)

    @pytest.mark.parametrize("dtype_name", ["float32", "float64"])
    def test_traction_ellipse_16_rows_match_xla(self, stack, dtype_name):
        """VERDICT r2 weak #6: the kernel is parameterized on the constraint
        count, so `enable_traction_ellipse` keeps the fused-kernel path
        (16 rows) instead of silently downgrading to the XLA scan."""
        import dataclasses

        dtype = jnp.dtype(dtype_name)
        model = dataclasses.replace(_cast(stack, dtype), enable_traction_ellipse=True)
        assert S.n_con(model) == N_CON + 2
        cfg = SolverConfig(horizon=10)
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        _, zs, us, lams = _inputs(model, dtype, cfg, p)
        assert lams.shape[1] == 16
        rho = jnp.asarray(cfg.rho_init, dtype)
        reg = jnp.asarray(1e-6, dtype)

        cost_x, zs_x, us_x = S._forward_pass(
            model, p, cfg, zs, us,
            *S._backward_pass(model, p, cfg, zs, us, lams, rho, reg)[:2],
            lams, rho,
        )
        new_cost, zs_k, us_k, diverged = _kernel_iteration(
            model, p, cfg, zs, us, lams, rho, reg
        )
        tol = 1e-5 if dtype == jnp.float32 else 1e-11
        assert not bool(diverged)
        np.testing.assert_allclose(np.asarray(zs_k), np.asarray(zs_x), rtol=tol, atol=tol)
        np.testing.assert_allclose(np.asarray(us_k), np.asarray(us_x), rtol=tol, atol=tol)
        np.testing.assert_allclose(float(new_cost), float(cost_x), rtol=10 * tol)

    def test_torque_vectoring_matches_xla(self, stack):
        """The kernel's RHS carries the torque-vectoring yaw moment when the
        model enables it (models/bicycle.rhs)."""
        import dataclasses

        dtype = jnp.float64
        model = dataclasses.replace(_cast(stack, dtype), enable_torque_vectoring=True)
        cfg = SolverConfig(horizon=10)
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        _, zs, us, lams = _inputs(model, dtype, cfg, p, throttle=0.3)
        zs = zs.at[:, 6].set(0.1)  # a steering angle, so the moment is nonzero
        rho = jnp.asarray(cfg.rho_init, dtype)
        reg = jnp.asarray(1e-6, dtype)
        cost_x, zs_x, us_x = S._forward_pass(
            model, p, cfg, zs, us,
            *S._backward_pass(model, p, cfg, zs, us, lams, rho, reg)[:2],
            lams, rho,
        )
        new_cost, zs_k, us_k, diverged = _kernel_iteration(
            model, p, cfg, zs, us, lams, rho, reg
        )
        assert not bool(diverged)
        np.testing.assert_allclose(np.asarray(zs_k), np.asarray(zs_x), rtol=1e-11, atol=1e-11)
        np.testing.assert_allclose(float(new_cost), float(cost_x), rtol=1e-10)

    def test_traction_ellipse_full_solve_matches_xla(self, stack):
        import dataclasses

        dtype = jnp.float32
        model = dataclasses.replace(_cast(stack, dtype), enable_traction_ellipse=True)
        cfg_x = SolverConfig(horizon=10, al_iters=1, ilqr_iters=2, backend="xla")
        cfg_p = SolverConfig(horizon=10, al_iters=1, ilqr_iters=2, backend="interpret")
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        z0, _, us, lams = _inputs(model, dtype, cfg_x, p)
        r_x = S.solve(model, p, cfg_x, z0, us, lams)
        r_p = S.solve(model, p, cfg_p, z0, us, lams)
        np.testing.assert_allclose(np.asarray(r_p.us), np.asarray(r_x.us), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(r_p.cost), float(r_x.cost), rtol=1e-4)

    def test_table_lookup_matches_uinterp(self, stack):
        """The kernel's two-point indexed lookup must equal MPCTrack._uinterp,
        wrap and table edges included."""
        model = stack
        dtype = jnp.float64
        tables = PK.tables_matrix(model, dtype)
        track = model.track
        n = track.s_grid.shape[0]
        s = jnp.asarray(np.linspace(-10.0, 2.0 * float(track.s_max), 97), dtype)
        scal = PK.scal_vector(model, OCPParams.reference(dtype), SolverConfig(), 1.0, dtype)
        ctx = PK._Ctx(scal, tables.reshape(-1), n, closed=True, tv=False)
        for row, ref in enumerate(
            (track.curvature(s), track.dist_left(s), track.dist_right(s), track.v_ref(s))
        ):
            got = ctx.lookup(row, s)
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-9, atol=1e-12)


class TestBatchedKernel:
    """Parity gates for the kernel's batch grid (one program per instance):
    per-instance results must match the vmapped XLA path on identical
    inputs.  Instances start at DIFFERENT arc lengths, one near the lap
    seam, so the table lookups wrap."""

    def _batch_inputs(self, model, dtype, cfg, B=3):
        s_max = float(model.track.s_max)
        x0s = []
        for i, s0 in enumerate([0.0, 0.43 * s_max, s_max - 3.0][:B]):
            x = np.array(runner.X0_REFERENCE, dtype=np.float64)
            x[0] = s0
            x[3] = 5.0 + 2.0 * i
            x0s.append(x)
        x0_b = jnp.asarray(np.stack(x0s), dtype)
        z0_b = jnp.concatenate([x0_b, jnp.zeros((B, NU), dtype)], axis=1)
        us_b = jnp.full((B, cfg.horizon, NU), 0.05, dtype)
        lam_b = jnp.zeros((B, cfg.horizon + 1, S.n_con(model)), dtype)
        return z0_b, us_b, lam_b

    @pytest.mark.parametrize("dtype_name", ["float32", "float64"])
    def test_solve_batch_matches_vmap_solve(self, stack, dtype_name):
        dtype = jnp.dtype(dtype_name)
        model = _cast(stack, dtype)
        cfg_x = SolverConfig(horizon=10, al_iters=2, ilqr_iters=3, backend="xla")
        cfg_b = SolverConfig(horizon=10, al_iters=2, ilqr_iters=3, backend="interpret")
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        z0_b, us_b, lam_b = self._batch_inputs(model, dtype, cfg_x)
        r_x = S.solve_batch(model, p, cfg_x, z0_b, us_b, lam_b)  # vmap(solve)
        r_b = S.solve_batch(model, p, cfg_b, z0_b, us_b, lam_b)  # batched kernel
        tol = 2e-4 if dtype == jnp.float32 else 1e-9
        np.testing.assert_allclose(np.asarray(r_b.us), np.asarray(r_x.us), rtol=tol, atol=tol)
        np.testing.assert_allclose(np.asarray(r_b.zs), np.asarray(r_x.zs), rtol=tol, atol=tol)
        np.testing.assert_allclose(
            np.asarray(r_b.cost), np.asarray(r_x.cost), rtol=10 * tol
        )

    def test_solve_batch_traction_ellipse(self, stack):
        import dataclasses

        dtype = jnp.float32
        model = dataclasses.replace(_cast(stack, dtype), enable_traction_ellipse=True)
        cfg_x = SolverConfig(horizon=10, al_iters=1, ilqr_iters=2, backend="xla")
        cfg_b = SolverConfig(horizon=10, al_iters=1, ilqr_iters=2, backend="interpret")
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        z0_b, us_b, lam_b = self._batch_inputs(model, dtype, cfg_x, B=2)
        assert lam_b.shape[2] == 16
        r_x = S.solve_batch(model, p, cfg_x, z0_b, us_b, lam_b)
        r_b = S.solve_batch(model, p, cfg_b, z0_b, us_b, lam_b)
        np.testing.assert_allclose(np.asarray(r_b.us), np.asarray(r_x.us), rtol=2e-4, atol=2e-4)

    @pytest.mark.slow
    def test_closed_loop_batch_kernel_path_matches_xla(self, stack):
        """End-to-end: the batched-kernel closed loop must track the XLA
        closed loop (interpreter mode on CPU; small budgets)."""
        import dataclasses

        dtype = jnp.float32
        model = _cast(stack, dtype)
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        cfg_x = SolverConfig(horizon=10, backend="xla")
        cfg_b = SolverConfig(horizon=10, backend="interpret")
        x0 = jnp.asarray(runner.X0_REFERENCE, dtype)
        x0_b = jnp.stack([x0, x0.at[3].set(6.0)])
        r_x = runner.closed_loop_batch(model, p, cfg_x, x0_b, 3)
        r_b = runner.closed_loop_batch(model, p, cfg_b, x0_b, 3)
        np.testing.assert_allclose(
            np.asarray(r_b.xs), np.asarray(r_x.xs), rtol=2e-3, atol=2e-3
        )


class TestKernelWrapper:
    """What surrounds the kernel, checked without running it: the padding
    to power-of-two blocks, the rung selection, the Triton lowering and the
    refusal to differentiate."""

    def test_pad_stage_inputs_shapes_and_zero_fill(self, rng):
        Bn, N = 3, 10
        r = lambda *shape: jnp.asarray(rng.normal(size=shape))
        A, B, lz = r(Bn, N, 10, 10), r(Bn, N, 10, NU), r(Bn, N, 10)
        lzz, luz, Vz, Vzz = r(Bn, N, 10, 10), r(Bn, N, NU, 10), r(Bn, 10), r(Bn, 10, 10)
        out = PK.pad_stage_inputs(A, B, lz, lzz, luz, Vz, Vzz)
        assert out["A"].shape == out["lzz"].shape == (Bn, 16, 16, 16)
        assert out["Bt"].shape == out["luz"].shape == (Bn, 16, NU, 16)
        assert out["lz"].shape == (Bn, 16, 16)
        assert out["Vz"].shape == (Bn, 16) and out["Vzz"].shape == (Bn, 16, 16)
        np.testing.assert_array_equal(out["A"][:, :N, :10, :10], A)
        np.testing.assert_array_equal(out["Bt"][:, :N, :, :10], jnp.swapaxes(B, 2, 3))
        np.testing.assert_array_equal(out["Vzz"][:, :10, :10], Vzz)
        # the padding is exactly zero, so the padded Riccati rows stay zero
        assert float(jnp.abs(out["A"][:, N:]).max()) == 0.0
        assert float(jnp.abs(out["A"][:, :, 10:]).max()) == 0.0
        assert float(jnp.abs(out["lz"][:, :, 10:]).max()) == 0.0
        assert float(jnp.abs(out["Vz"][:, 10:]).max()) == 0.0

    @pytest.mark.parametrize("L,LP", [(1, 1), (6, 8), (8, 8), (9, 16)])
    def test_pad_ladder_repeats_last_rung(self, L, LP):
        alphas = jnp.linspace(1.0, 0.1, L)
        padded = PK.pad_ladder(alphas)
        assert padded.shape == (LP,)
        np.testing.assert_array_equal(padded[:L], alphas)
        np.testing.assert_array_equal(padded[L:], jnp.full((LP - L,), alphas[-1]))

    def test_select_best_unpads_and_masks(self):
        Bn, N, LP, L = 3, 2, 8, 6
        zall = jnp.arange(Bn * (N + 1) * 10 * LP, dtype=jnp.float64).reshape(Bn, N + 1, 10, LP)
        uall = -jnp.arange(Bn * N * NU * LP, dtype=jnp.float64).reshape(Bn, N, NU, LP)
        costs = jnp.array([
            [5.0, 4.0, 3.0, 9.0, 9.0, 9.0, 0.0, 0.0],      # padded rungs cheapest
            [jnp.nan, 2.0, jnp.inf, 2.0, 7.0, 8.0, 1.0, 1.0],  # tie -> lowest index
            [jnp.nan] * LP,                                 # nothing finite
        ])
        zs, us, cost = PK.select_best(zall, uall, costs, L)
        assert zs.shape == (Bn, N + 1, 10) and us.shape == (Bn, N, NU)
        np.testing.assert_array_equal(cost[:2], [3.0, 2.0])
        assert not np.isfinite(float(cost[2]))  # rejected by the solver's cost test
        np.testing.assert_array_equal(zs[0], zall[0, :, :, 2])
        np.testing.assert_array_equal(us[1], uall[1, :, :, 1])

    @pytest.mark.parametrize("traction_ellipse", [False, True])
    def test_kernel_lowers_for_cuda(self, stack, traction_ellipse):
        """The Triton route's lowering (Pallas -> Triton IR) runs without a
        GPU: every primitive of the kernel must have a rule and every block
        a power-of-two size.  Compiling to PTX needs the card."""
        import dataclasses

        dtype = jnp.float32
        model = dataclasses.replace(_cast(stack, dtype), enable_traction_ellipse=traction_ellipse)
        cfg = SolverConfig(horizon=10)
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        _, zs, us, lams = _inputs(model, dtype, cfg, p)
        rho = jnp.asarray(cfg.rho_init, dtype)
        Bn = 4
        tile = lambda a: jnp.tile(a[None], (Bn,) + (1,) * a.ndim)
        fn = jax.jit(lambda zs, us, lams, reg: S._iterate_kernel(
            model, p, cfg, zs, us, lams, rho, reg, interpret=False))
        lowered = fn.trace(tile(zs), tile(us), tile(lams), jnp.full((Bn,), 1e-6, dtype)).lower(
            lowering_platforms=("cuda",)
        )
        text = lowered.as_text()
        assert "__gpu$xla.gpu.triton" in text
        assert "grid_x = 4" in text and "num_warps = 1" in text

    def test_gradient_through_kernel_is_refused(self, stack):
        """The kernel is forward-only: differentiating a kernel-backed solve
        must fail with a message that names the XLA backend."""
        dtype = jnp.float32
        model = _cast(stack, dtype)
        cfg = SolverConfig(horizon=4, al_iters=1, ilqr_iters=1, backend="interpret")
        p = OCPParams.reference(dtype, lateral_margin=0.05)
        z0, _, us, lams = _inputs(model, dtype, cfg, p)
        loss = lambda z: S.solve(model, p, cfg, z, us, lams).cost
        with pytest.raises(NotImplementedError, match="backend='xla'"):
            jax.grad(loss)(z0)
