"""AL-iLQR vs an independent NLP oracle (scipy SLSQP) on the identical OCP.

The BASELINE gate is "control sequences matching the do_mpc/IPOPT reference
within tolerance"; CasADi/IPOPT cannot run in this environment, so the oracle
is scipy's SLSQP — an SQP of the same class as IPOPT for problems this size —
solving the *same* discretized OCP (same RK4 dynamics, costs, constraints,
single-shooting in the inputs) with exact JAX gradients.  The AL-iLQR
solution must reach a cost within 1% of (or better than) the SLSQP optimum
while staying feasible.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize

from lap_time_optimization.models.bicycle import NU, BicycleModel
from lap_time_optimization.mpc import runner
from lap_time_optimization.mpc import solver as S
from lap_time_optimization.mpc import track as mpc_track
from lap_time_optimization.mpc.solver import N_CON, OCPParams, SolverConfig

REF_DATA = os.environ.get("LTO_REF_DATA", "/root/reference/data")


@pytest.fixture(scope="module")
def stack():
    if not os.path.isdir(os.path.join(REF_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("reference artifacts not available")
    from lap_time_optimization.models import load_vehicle

    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REF_DATA)
    model = BicycleModel(
        vehicle=load_vehicle(os.path.join(REF_DATA, "vehicles", "MX5.json")), track=track
    )
    p = OCPParams.reference(jnp.float64)
    cfg = SolverConfig.accurate(horizon=10)
    return model, p, cfg


def _slsqp_solve(model, p, cfg, z0, us0):
    """Single-shooting SLSQP on the same OCP with exact JAX derivatives."""
    N = cfg.horizon

    def cost_np(u_flat):
        us = jnp.asarray(u_flat.reshape(N, NU))
        zs = S._rollout(model, cfg, z0, us)
        return float(S._true_cost(model, p, zs, us))

    cost_grad = jax.jit(
        jax.grad(
            lambda us: S._true_cost(model, p, S._rollout(model, cfg, z0, us), us)
        )
    )

    def ineq_np(u_flat):
        us = jnp.asarray(u_flat.reshape(N, NU))
        zs = S._rollout(model, cfg, z0, us)
        g = jax.vmap(lambda z, u: S.constraints(model, p, z, u))(zs[:-1], us)
        g_term = S.constraints(model, p, zs[-1], jnp.zeros((NU,)))[:10]
        return -np.concatenate([np.asarray(g).ravel(), np.asarray(g_term)])  # scipy wants >= 0

    ineq_jac = jax.jit(
        jax.jacfwd(
            lambda us: -jnp.concatenate(
                [
                    jax.vmap(lambda z, u: S.constraints(model, p, z, u))(
                        S._rollout(model, cfg, z0, us)[:-1], us
                    ).ravel(),
                    S.constraints(model, p, S._rollout(model, cfg, z0, us)[-1], jnp.zeros((NU,)))[:10],
                ]
            )
        )
    )

    res = scipy.optimize.minimize(
        cost_np,
        np.asarray(us0).ravel(),
        jac=lambda u: np.asarray(cost_grad(jnp.asarray(u.reshape(N, NU)))).ravel(),
        constraints=[
            dict(
                type="ineq",
                fun=ineq_np,
                jac=lambda u: np.asarray(ineq_jac(jnp.asarray(u.reshape(N, NU)))).reshape(
                    -1, N * NU
                ),
            )
        ],
        method="SLSQP",
        options=dict(maxiter=200, ftol=1e-10),
    )
    return res


pytestmark = pytest.mark.slow


class TestAgainstNLPOracle:
    @pytest.mark.parametrize(
        "x0",
        [
            runner.X0_REFERENCE,
            np.array([50.0, 0.3, 0.05, 8.0, 0.1, 0.05, 0.02, 0.3]),
            np.array([200.0, -0.4, -0.08, 12.0, -0.2, -0.1, -0.05, 0.5]),
        ],
        ids=["reference-x0", "mid-track", "fast-offset"],
    )
    def test_cost_within_1pct_of_slsqp(self, stack, x0):
        model, p, cfg = stack
        z0 = jnp.concatenate([jnp.asarray(x0), jnp.zeros(NU)])
        us0 = jnp.zeros((cfg.horizon, NU))
        lam0 = jnp.zeros((cfg.horizon + 1, N_CON))

        ours = S.solve(model, p, cfg, z0, us0, lam0)
        nlp = _slsqp_solve(model, p, cfg, z0, us0)
        assert nlp.success or nlp.status == 9  # 9 = iteration limit, still usable

        # our solution: feasible and within 1% of the SQP optimum (or better)
        assert float(ours.max_violation) < 5e-3
        ours_cost = float(ours.cost)
        assert ours_cost <= nlp.fun * 1.01 + 1e-6, (ours_cost, nlp.fun)
