"""Tests for flag-gated capabilities and the config system.

The reference *defines* torque vectoring but zeroes it (src/mpc/model.py:162-164)
and *defines* the traction-ellipse constraint but never activates it
(src/mpc/model.py:86-99, commented at src/mpc/controller.py:72-74).  Here both
are implemented properly behind flags; these tests pin their semantics so the
flags stay functional.  Also covers the config dataclasses (SURVEY.md §5) and
the CLI sanitizer/profiler flags.
"""

import json

import jax.numpy as jnp
import numpy as np

from lap_time_optimization.mpc import track as mpc_track
from lap_time_optimization.models.bicycle import (
    IDX_R,
    NX,
    BicycleModel,
)
from lap_time_optimization.models.vehicle import GRAV
from lap_time_optimization.utils.config import Config, MPCConfig

import os
import pytest

REF_DATA = os.environ.get("LTO_REF_DATA", "/root/reference/data")


@pytest.fixture(scope="module")
def track():
    if not os.path.isdir(os.path.join(REF_DATA, "plots", "MX-5", "buckmore", "curvature")):
        pytest.skip("reference artifacts not available")
    return mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REF_DATA)


X_NOM = jnp.asarray([5.0, 0.2, 0.05, 8.0, 0.3, 0.1, 0.08, 0.4])
U_NOM = jnp.asarray([0.01, 0.02])


class TestTorqueVectoring:
    def test_flag_off_is_parity(self, track, mx5):
        """Default model has Mtv == 0 exactly (reference zeroes it)."""
        off = BicycleModel(vehicle=mx5, track=track)
        assert off.enable_torque_vectoring is False

    def test_flag_changes_only_rdot(self, track, mx5):
        off = BicycleModel(vehicle=mx5, track=track)
        on = BicycleModel(vehicle=mx5, track=track, enable_torque_vectoring=True)
        f_off = np.asarray(off.rhs(X_NOM, U_NOM))
        f_on = np.asarray(on.rhs(X_NOM, U_NOM))
        same = np.delete(np.arange(NX), IDX_R)
        np.testing.assert_array_equal(f_on[same], f_off[same])
        # Mtv = ptv * (tan(delta) vx / L - r)   (src/mpc/model.py:162-163)
        veh = off.vehicle
        L = float(veh.length_f + veh.length_r)
        rt = np.tan(float(X_NOM[6])) * float(X_NOM[3]) / L
        mtv = float(veh.ptv) * (rt - float(X_NOM[5]))
        expected = f_off[IDX_R] + mtv / float(veh.rotational_inertia)
        np.testing.assert_allclose(f_on[IDX_R], expected, rtol=1e-12)

    def test_tv_steers_yaw_toward_kinematic_rate(self, track, mx5):
        """With r below the kinematic rate, Mtv must increase rdot (and
        vice versa) — the stabilizing sign convention."""
        on = BicycleModel(vehicle=mx5, track=track, enable_torque_vectoring=True)
        off = BicycleModel(vehicle=mx5, track=track)
        x_low = X_NOM.at[IDX_R].set(0.0)  # r < rt (rt > 0 for delta > 0)
        assert float(on.rhs(x_low, U_NOM)[IDX_R]) > float(off.rhs(x_low, U_NOM)[IDX_R])
        x_high = X_NOM.at[IDX_R].set(2.0)  # r > rt
        assert float(on.rhs(x_high, U_NOM)[IDX_R]) < float(off.rhs(x_high, U_NOM)[IDX_R])


class TestTractionEllipse:
    def test_matches_numpy_rederivation(self, track, mx5):
        """g = (ρ·Fx/2)² + Fy² − (αD)² ≤ 0 per axle (src/mpc/model.py:86-99)."""
        model = BicycleModel(vehicle=mx5, track=track)
        thr, vx, vy, r, delta = 0.4, 8.0, 0.3, 0.1, 0.08
        rho, alpha = 1.3, 0.9
        gf, gr = model.traction_ellipse(thr, vx, vy, r, delta, rho=rho, alpha=alpha)
        veh = mx5
        m, lf, lr = float(veh.mass), float(veh.length_f), float(veh.length_r)
        longf = rho * 0.5 * float(veh.C_m) * thr
        af = np.arctan2(vy + lf * r, vx) - delta
        ar = np.arctan2(vy - lr * r, vx)
        Fn_f = lr * m * GRAV / (lf + lr)
        Fn_r = lf * m * GRAV / (lf + lr)
        Fy_f = -Fn_f * float(veh.D_f) * np.sin(float(veh.C_f) * np.arctan(float(veh.B_f) * af))
        Fy_r = -Fn_r * float(veh.D_r) * np.sin(float(veh.C_r) * np.arctan(float(veh.B_r) * ar))
        np.testing.assert_allclose(
            float(gf), longf**2 + Fy_f**2 - (alpha * float(veh.D_f)) ** 2, rtol=1e-10
        )
        np.testing.assert_allclose(
            float(gr), longf**2 + Fy_r**2 - (alpha * float(veh.D_r)) ** 2, rtol=1e-10
        )

    def test_monotone_in_throttle(self, track, mx5):
        """More drive force consumes ellipse margin on both axles."""
        model = BicycleModel(vehicle=mx5, track=track)
        g_lo = model.traction_ellipse(0.1, 8.0, 0.0, 0.0, 0.0)
        g_hi = model.traction_ellipse(0.9, 8.0, 0.0, 0.0, 0.0)
        assert float(g_hi[0]) > float(g_lo[0])
        assert float(g_hi[1]) > float(g_lo[1])

    def test_physical_form_is_satisfiable(self, track, mx5):
        """The reference's form compares N² forces against the normalized
        D² ≈ 1 (unsatisfiable — why it stayed disabled); the corrected
        physical form must be satisfied at gentle driving and violated at
        a full-lock aggressive state."""
        model = BicycleModel(vehicle=mx5, track=track)
        gf, gr = model.traction_ellipse_physical(0.2, 8.0, 0.0, 0.0, 0.0)
        assert float(gf) < 0.0 and float(gr) < 0.0
        # at the Pacejka peak slip (C·atan(B·α) = π/2 → α ≈ 0.265 for the
        # front tire) the lateral force saturates the capacity exactly, so
        # any drive force pushes the ellipse positive
        gf2, _ = model.traction_ellipse_physical(1.0, 10.0, 2.71, 0.0, 0.0)
        assert float(gf2) > 0.0
        # the reference's raw form is indeed hopeless at the same gentle state
        raw_f, _ = model.traction_ellipse(0.2, 8.0, 0.0, 0.0, 0.0)
        assert float(raw_f) > 1e3


class TestTractionEllipseInSolver:
    def test_solver_enforces_ellipse(self, track, mx5):
        """enable_traction_ellipse=True adds 2 rows to the constraint set and
        the closed loop keeps the applied states inside the (normalized)
        ellipse (VERDICT r1: implement the intended-but-disabled feature
        properly behind a flag)."""
        from lap_time_optimization.mpc import runner, solver as S

        model = BicycleModel(vehicle=mx5, track=track, enable_traction_ellipse=True)
        assert S.n_con(model) == 16
        p = S.OCPParams.reference(jnp.float64, lateral_margin=0.05)
        cfg = S.SolverConfig(horizon=10)  # "auto" is the XLA path on the CPU
        x0 = jnp.asarray(runner.X0_REFERENCE, jnp.float64)
        sim = runner.closed_loop(model, p, cfg, x0, 15)
        xs = np.asarray(sim.xs)
        gf, gr = model.traction_ellipse_physical(
            xs[1:, 7], xs[1:, 3], xs[1:, 4], xs[1:, 5], xs[1:, 6]
        )
        assert float(jnp.max(gf)) < 1e-2 and float(jnp.max(gr)) < 1e-2
        assert xs[-1, 0] > 5.0  # still makes progress


class TestConfig:
    def test_defaults_are_reference_constants(self):
        cfg = Config()
        # corner detection, src/__main__.py:109-112
        assert (cfg.corners.k_min, cfg.corners.proximity, cfg.corners.length) == (0.03, 40.0, 10.0)
        # epsilon bounds, src/trajectory.py:99
        assert (cfg.compromise.eps_min, cfg.compromise.eps_max) == (0.0, 0.2)
        # BO stop rule, tbn.py:195 (min_samples raised 20->25 alongside the
        # batch-scaled init batch; window/tol keep the reference values)
        assert (cfg.bayes.sigma_window, cfg.bayes.sigma_tol) == (10, 1e-3)
        assert cfg.bayes.min_samples >= 20
        # MPC weights/horizon/x0, src/mpc/controller.py:9,29; src/mpc.py:107-126
        assert (cfg.mpc.horizon, cfg.mpc.dt, cfg.mpc.steps) == (10, 0.1, 500)
        assert (cfg.mpc.q_n, cfg.mpc.q_mu, cfg.mpc.q_B) == (0.5, 3.0, 1e-2)
        assert cfg.mpc.x0 == (0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.1)

    def test_json_roundtrip(self, tmp_path):
        cfg = Config(mpc=MPCConfig(horizon=20, r_controls=(0.5, 0.25)))
        path = tmp_path / "cfg.json"
        path.write_text(cfg.to_json())
        loaded = Config.load(str(path))
        assert loaded == cfg
        assert isinstance(loaded.mpc.r_controls, tuple)

    def test_partial_override(self):
        loaded = Config.from_dict(json.loads('{"mpc": {"horizon": 25}}'))
        assert loaded.mpc.horizon == 25
        assert loaded.mpc.q_n == 0.5  # untouched defaults survive


class TestCLISanitizerFlags:
    def test_parser_accepts_debug_and_profile_flags(self):
        from lap_time_optimization.cli.race import build_parser

        args = build_parser().parse_args(
            ["t.json", "v.json", "0.8", "--curvature", "--debug-nans", "--profile-dir", "/tmp/x"]
        )
        assert args.debug_nans is True
        assert args.profile_dir == "/tmp/x"
