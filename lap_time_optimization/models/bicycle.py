"""Curvilinear dynamic bicycle model with simplified Pacejka tires.

Exact dynamics parity with the reference's CasADi/do_mpc model
(src/mpc/model.py:130-185), including its sign conventions:

  states  x = [s, n, mu, vx, vy, r, steering_angle, throttle]
  inputs  u = [steering_angle_change, throttle_change]

  sdot   = (vx cos(mu) − vy sin(mu)) / (1 − n k(s))       (model.py:152)
  ndot   = vx sin(mu) + vy cos(mu)                        (model.py:167-169)
  mudot  = r − k(s)·sdot                                  (model.py:170-171)
  vxdot  = (Fx − Fy_f sin(δ) + m vy r)/m                  (model.py:173-175)
  vydot  = (Fy_r + Fy_f cos(δ) − m vx r)/m                (model.py:176-178)
  rdot   = (Fy_f l_f cos(δ) − Fy_r l_r + Mtv)/I_z         (model.py:179-181)
  δdot   = u₀ ;  throttledot = u₁                         (model.py:182-183)

with slip angles α_f = atan2(vy + l_f r, vx) − δ, α_r = atan2(vy − l_r r, vx)
(model.py:101-104), *negated* Pacejka lateral forces
Fy = −Fn·D·sin(C·atan(B·α)) with a static front/rear load split
(model.py:106-114), and Fx = C_m·throttle − Cr0 − Cr2·vx² (model.py:160).

The reference computes torque vectoring Mtv but zeroes it (model.py:162-164);
here it is implemented properly behind the `enable_torque_vectoring` flag
(default off for parity).

Instead of do_mpc's collocation/IDAS integrators, the discrete step is an
explicit RK4 with substeps — fully differentiable and fused by XLA into the
solver's rollout.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from lap_time_optimization.models.vehicle import GRAV, PacejkaVehicle
from lap_time_optimization.mpc.track import MPCTrack

NX = 8  # model states
NU = 2  # inputs

IDX_S, IDX_N, IDX_MU, IDX_VX, IDX_VY, IDX_R, IDX_DELTA, IDX_THROTTLE = range(8)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BicycleModel:
    vehicle: PacejkaVehicle
    track: MPCTrack
    enable_torque_vectoring: bool = dataclasses.field(metadata=dict(static=True), default=False)
    # Adds the friction-ellipse rows to the solver's constraint set
    # (src/mpc/controller.py:72-74 defines-but-disables them; here the
    # *corrected* physical form is actually enforceable — see
    # `traction_ellipse_physical`).
    enable_traction_ellipse: bool = dataclasses.field(metadata=dict(static=True), default=False)

    # ------------------------------------------------------------ tire model
    def slip_angles(self, vx, vy, r, delta):
        """(α_f, α_r) — reference src/mpc/model.py:101-104."""
        veh = self.vehicle
        alpha_f = jnp.arctan2(vy + veh.length_f * r, vx) - delta
        alpha_r = jnp.arctan2(vy - veh.length_r * r, vx)
        return alpha_f, alpha_r

    def lateral_forces(self, alpha_f, alpha_r):
        """Negated Pacejka with static load split — src/mpc/model.py:106-114."""
        veh = self.vehicle
        wheelbase = veh.length_f + veh.length_r
        Fn_f = veh.length_r * veh.mass * GRAV / wheelbase
        Fn_r = veh.length_f * veh.mass * GRAV / wheelbase
        Fy_f = -Fn_f * veh.D_f * jnp.sin(veh.C_f * jnp.arctan(veh.B_f * alpha_f))
        Fy_r = -Fn_r * veh.D_r * jnp.sin(veh.C_r * jnp.arctan(veh.B_r * alpha_r))
        return Fy_f, Fy_r

    def motor_force(self, throttle):
        return self.vehicle.C_m * throttle  # src/mpc/model.py:116-117

    # -------------------------------------------------------------- dynamics
    def rhs(self, x: jax.Array, u: jax.Array) -> jax.Array:
        """Continuous-time RHS, exact parity with src/mpc/model.py:152-183."""
        veh = self.vehicle
        s, n, mu, vx, vy, r, delta, throttle = (x[i] for i in range(NX))
        k = self.track.curvature(s)
        sdot = (vx * jnp.cos(mu) - vy * jnp.sin(mu)) / (1.0 - n * k)
        alpha_f, alpha_r = self.slip_angles(vx, vy, r, delta)
        Fy_f, Fy_r = self.lateral_forces(alpha_f, alpha_r)
        Fx = self.motor_force(throttle) - veh.Cr_0 - veh.Cr_2 * vx * vx
        if self.enable_torque_vectoring:
            rt = jnp.tan(delta) * vx / (veh.length_f + veh.length_r)
            Mtv = veh.ptv * (rt - r)  # src/mpc/model.py:162-163 (zeroed there)
        else:
            Mtv = 0.0
        return jnp.stack(
            [
                sdot,
                vx * jnp.sin(mu) + vy * jnp.cos(mu),
                r - k * sdot,
                (Fx - Fy_f * jnp.sin(delta) + veh.mass * vy * r) / veh.mass,
                (Fy_r + Fy_f * jnp.cos(delta) - veh.mass * vx * r) / veh.mass,
                (Fy_f * veh.length_f * jnp.cos(delta) - Fy_r * veh.length_r + Mtv)
                / veh.rotational_inertia,
                u[0],
                u[1],
            ]
        )

    @partial(jax.jit, static_argnames=("substeps",))
    def step(self, x: jax.Array, u: jax.Array, dt: float, substeps: int = 4) -> jax.Array:
        """Explicit RK4 over `substeps` increments (plant == model, like the
        reference's do_mpc simulator over the same ODE, src/mpc/simulator.py:18-20)."""
        h = dt / substeps

        def rk4(x, _):
            k1 = self.rhs(x, u)
            k2 = self.rhs(x + 0.5 * h * k1, u)
            k3 = self.rhs(x + 0.5 * h * k2, u)
            k4 = self.rhs(x + h * k3, u)
            return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), None

        x_next, _ = jax.lax.scan(rk4, x, None, length=substeps)
        return x_next

    # ------------------------------------------------------------ constraints
    def lateral_constraints(self, s, n, mu):
        """Track-limit constraints ≤ 0 incl. car footprint
        (src/mpc/model.py:70-84; sign(mu)*mu ≡ |mu|)."""
        veh = self.vehicle
        half_len = 0.5 * (veh.length_f + veh.length_r)
        half_wid = 0.5 * veh.width
        lon = half_len * jnp.sin(jnp.abs(mu))
        lat = half_wid * jnp.cos(mu)
        left = n - lon + lat - self.track.dist_left(s)
        right = -n + lon + lat - self.track.dist_right(s)
        return left, right

    def traction_ellipse(self, throttle, vx, vy, r, delta, rho=1.0, alpha=1.0):
        """Friction-ellipse constraints ≤ 0 (defined-but-disabled in the
        reference, src/mpc/model.py:86-99; available here behind a flag)."""
        veh = self.vehicle
        longf = rho * 0.5 * self.motor_force(throttle)
        af, ar = self.slip_angles(vx, vy, r, delta)
        Fy_f, Fy_r = self.lateral_forces(af, ar)
        Df = alpha * veh.D_f
        Dr = alpha * veh.D_r
        return longf**2 + Fy_f**2 - Df**2, longf**2 + Fy_r**2 - Dr**2

    def traction_ellipse_physical(self, throttle, vx, vy, r, delta, rho=1.0, alpha=1.0):
        """Dimensionally consistent friction-ellipse residuals ≤ 0.

        The reference's version (kept verbatim in `traction_ellipse`)
        compares squared tire forces in N² against the *normalized* Pacejka
        peak D² ≈ 1 — unsatisfiable by ~6 orders of magnitude, which is why
        it stayed commented out (src/mpc/model.py:86-99, src/mpc/controller.py:72-74).
        Here the peak force is D·Fn (the actual Pacejka maximum with the
        static load split) and the residual is normalized by (α·D·Fn)², so
        active constraints are O(1) for the augmented Lagrangian:

            g = ((ρ·Fx/2)² + Fy² − (α·D·Fn)²) / (α·D·Fn)²  ≤ 0
        """
        veh = self.vehicle
        wheelbase = veh.length_f + veh.length_r
        Fn_f = veh.length_r * veh.mass * GRAV / wheelbase
        Fn_r = veh.length_f * veh.mass * GRAV / wheelbase
        longf = rho * 0.5 * self.motor_force(throttle)
        af, ar = self.slip_angles(vx, vy, r, delta)
        Fy_f, Fy_r = self.lateral_forces(af, ar)
        cap_f = (alpha * veh.D_f * Fn_f) ** 2
        cap_r = (alpha * veh.D_r * Fn_r) ** 2
        return (
            (longf**2 + Fy_f**2 - cap_f) / cap_f,
            (longf**2 + Fy_r**2 - cap_r) / cap_r,
        )

    def beta_cost(self, x: jax.Array, q_B) -> jax.Array:
        """Kinematic/dynamic side-slip consistency cost B(q_B)
        (src/mpc/model.py:124-128).  Guarded at vx→0."""
        veh = self.vehicle
        vx = x[IDX_VX]
        b_dyn = jnp.arctan(x[IDX_VY] / jnp.maximum(vx, 1e-3))
        b_kin = jnp.arctan(x[IDX_DELTA] * veh.length_r / (veh.length_f + veh.length_r))
        return q_B * (b_dyn - b_kin) ** 2
