"""Fused Pallas kernel (Triton route) for one AL-iLQR iteration on a GPU.

Replaces the two *serial* pieces of an iLQR iteration — the Riccati
backward recursion and the line-search forward rollout — with one kernel
launch.  The per-stage matrices are tiny (NZ=10, NU=2), so on the XLA path
each of the ~900 dependent steps of a solve is at least one kernel launch
whose arithmetic is negligible; here the whole chain runs inside one
program (replaces the reference's per-step IPOPT calls,
src/mpc/controller.py:8-34).

Layout (one program per OCP instance, grid = batch):
* Stage matrices arrive padded to PZ×PZ (NZ → PZ = 16, zero fill), so the
  Riccati products are 16×16 `jnp.dot`s at HIGHEST precision (IEEE f32 on
  the Triton route, never TF32); the padded rows/columns stay exactly zero.
* The line-search ladder is padded to a power of two LP and every state
  component is one (LP,) vector (structure of arrays): all step sizes
  advance through the RK4 chain in lockstep.
* Track lookups are a two-point indexed load from the flattened (4·n,)
  table, the same index arithmetic as `MPCTrack._uinterp`.
* The gains k, K stay in registers between the two passes, as (NP,) and
  (NP, PZ) blocks over the horizon written and read by a one-hot row mask.
* The kernel writes every rung's trajectory and AL cost; the cheapest rung
  is picked in XLA (`select_best`).

Semantics are those of the XLA path (`mpc/solver._backward_pass` +
`_forward_pass`); parity is asserted in tests/test_pallas_ilqr.py in
interpreter mode (CPU) and by `chip_smoke.py` on the GPU.  Forward-only:
differentiating through it raises (the solver's gradient path is XLA).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Must mirror mpc/solver.py constants (imported there; kept standalone here
# to avoid a circular import).
NX = 8
NU = 2
NZ = NX + NU
N_CON = 14
PZ = 16  # NZ padded to the 16-wide block a Triton dot needs

#: warps per program: the program's work is (LP,) vectors and 16×16 tiles,
#: so one warp keeps every reduction inside the warp
NUM_WARPS = 1

# scalar-parameter vector layout (one (NS,) row shared by the batch)
_SCAL_FIELDS = (
    "rho", "s_max", "inv_ds", "h",  # h = dt / substeps
    "mass", "length_f", "length_r", "rot_inertia", "ptv",
    "B_f", "C_f", "D_f", "B_r", "C_r", "D_r",
    "C_m", "Cr_0", "Cr_2",
    "q_n", "q_mu", "q_B", "r_delta", "r_throttle", "vref_scale",
    "mu_max", "steer_max", "throttle_max", "dsteer_max", "dthrottle_max",
    "half_len", "half_wid", "lateral_margin",
)
_S = {name: i for i, name in enumerate(_SCAL_FIELDS)}
NS = len(_SCAL_FIELDS)
GRAV = 9.81


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class _Ctx:
    """Scalars and static facts one program reads everywhere."""

    def __init__(self, scal_ref, tab_ref, n_table, closed, tv):
        self.p = {name: scal_ref[i] for i, name in enumerate(_SCAL_FIELDS)}
        self.tab_ref = tab_ref
        self.n_table = n_table
        self.closed = closed
        self.tv = tv

    def lookup(self, row, s):
        """Row `row` of the (k, nl, nr, vref) tables at arc lengths s (LP,):
        `MPCTrack._uinterp`'s wrap, index clip and frac clip."""
        n = self.n_table
        sw = jnp.mod(s, self.p["s_max"]) if self.closed else s
        t = sw * self.p["inv_ds"]
        i = jnp.clip(jnp.floor(t).astype(jnp.int32), 0, n - 2)
        frac = jnp.clip(t - i.astype(t.dtype), 0.0, 1.0)
        lo = self.tab_ref[row * n + i]
        hi = self.tab_ref[row * n + i + 1]
        return lo * (1.0 - frac) + hi * frac


def _tyre_forces(c, vx, vy, r, delta):
    """Negated Pacejka lateral forces (models/bicycle.lateral_forces)."""
    p = c.p
    lf, lr, m = p["length_f"], p["length_r"], p["mass"]
    alpha_f = jnp.arctan2(vy + lf * r, vx) - delta
    alpha_r = jnp.arctan2(vy - lr * r, vx)
    wheelbase = lf + lr
    Fn_f = lr * m * GRAV / wheelbase
    Fn_r = lf * m * GRAV / wheelbase
    Fy_f = -Fn_f * p["D_f"] * jnp.sin(p["C_f"] * jnp.arctan(p["B_f"] * alpha_f))
    Fy_r = -Fn_r * p["D_r"] * jnp.sin(p["C_r"] * jnp.arctan(p["B_r"] * alpha_r))
    return Fy_f, Fy_r, Fn_f, Fn_r


def _rhs(c, x, u):
    """Curvilinear bicycle RHS (models/bicycle.BicycleModel.rhs) for the
    ladder: x is NX (LP,) vectors, u is NU of them."""
    p = c.p
    s, n_, mu, vx, vy, r, delta, thr = x
    k = c.lookup(0, s)
    sdot = (vx * jnp.cos(mu) - vy * jnp.sin(mu)) / (1.0 - n_ * k)
    Fy_f, Fy_r, _, _ = _tyre_forces(c, vx, vy, r, delta)
    m = p["mass"]
    Fx = p["C_m"] * thr - p["Cr_0"] - p["Cr_2"] * vx * vx
    if c.tv:
        rt = jnp.tan(delta) * vx / (p["length_f"] + p["length_r"])
        mtv = p["ptv"] * (rt - r)
    else:
        mtv = 0.0
    return (
        sdot,
        vx * jnp.sin(mu) + vy * jnp.cos(mu),
        r - k * sdot,
        (Fx - Fy_f * jnp.sin(delta) + m * vy * r) / m,
        (Fy_r + Fy_f * jnp.cos(delta) - m * vx * r) / m,
        (Fy_f * p["length_f"] * jnp.cos(delta) - Fy_r * p["length_r"] + mtv)
        / p["rot_inertia"],
        u[0],
        u[1],
    )


def _dyn_step(c, z, u, substeps):
    """Augmented RK4 step: x integrates over `substeps`, u_prev := u."""
    h = c.p["h"]
    x = z[:NX]
    axpy = lambda a, xs, ks: tuple(xi + a * ki for xi, ki in zip(xs, ks))
    for _ in range(substeps):
        k1 = _rhs(c, x, u)
        k2 = _rhs(c, axpy(0.5 * h, x, k1), u)
        k3 = _rhs(c, axpy(0.5 * h, x, k2), u)
        k4 = _rhs(c, axpy(h, x, k3), u)
        x = tuple(
            xi + (h / 6.0) * (a + 2.0 * b + 2.0 * cc + d)
            for xi, a, b, cc, d in zip(x, k1, k2, k3, k4)
        )
    return x + tuple(u)


def _constraints(c, z, u, n_con):
    """Stage inequalities on the solver-tightened band
    (mpc/solver.tightened_constraints); 16 rows append the friction
    ellipse (models/bicycle.traction_ellipse_physical)."""
    p = c.p
    s, n_, mu, vx, vy, r, delta, thr = z[:NX]
    lon = p["half_len"] * jnp.sin(jnp.abs(mu))
    lat = p["half_wid"] * jnp.cos(mu)
    margin = p["lateral_margin"]
    rows = [
        n_ - lon + lat - c.lookup(1, s) + margin,
        -n_ + lon + lat - c.lookup(2, s) + margin,
        -s,
        mu - p["mu_max"],
        -mu - p["mu_max"],
        -vx,
        delta - p["steer_max"],
        -delta - p["steer_max"],
        thr - p["throttle_max"],
        -thr - p["throttle_max"],
        u[0] - p["dsteer_max"],
        -u[0] - p["dsteer_max"],
        u[1] - p["dthrottle_max"],
        -u[1] - p["dthrottle_max"],
    ]
    if n_con == N_CON + 2:
        Fy_f, Fy_r, Fn_f, Fn_r = _tyre_forces(c, vx, vy, r, delta)
        longf = 0.5 * p["C_m"] * thr
        cap_f = (p["D_f"] * Fn_f) ** 2
        cap_r = (p["D_r"] * Fn_r) ** 2
        rows.append((longf**2 + Fy_f**2 - cap_f) / cap_f)
        rows.append((longf**2 + Fy_r**2 - cap_r) / cap_r)
    elif n_con != N_CON:
        raise ValueError(f"unsupported constraint count {n_con}")
    return rows


def _penalty(c, rows, lams):
    """PHR augmented-Lagrangian sum over rows (mpc/solver._al_penalty)."""
    rho = c.p["rho"]
    pen = 0.0
    for g, lam in zip(rows, lams):
        shifted = jnp.maximum(0.0, lam + rho * g)
        pen = pen + (shifted**2 - lam**2) / (2.0 * rho)
    return pen


def _stage_cost(c, z, u, lams, n_con):
    p = c.p
    s, n_, mu, vx, vy, _, delta, _ = z[:NX]
    vref = c.lookup(3, s)
    b_dyn = jnp.arctan(vy / jnp.maximum(vx, 1e-3))
    b_kin = jnp.arctan(delta * p["length_r"] / (p["length_f"] + p["length_r"]))
    du0 = u[0] - z[NX]
    du1 = u[1] - z[NX + 1]
    lterm = (
        p["q_n"] * n_**2
        + p["q_mu"] * mu**2
        + vy**2
        + (vx - p["vref_scale"] * vref) ** 2
        + p["q_B"] * (b_dyn - b_kin) ** 2
        + p["r_delta"] * du0**2
        + p["r_throttle"] * du1**2
    )
    return lterm + _penalty(c, _constraints(c, z, u, n_con), lams)


def _terminal_cost(c, z, lams, n_con):
    """mterm + AL over the state rows (0-9 and the ellipse rows 14+); the
    input rows are inactive at g = -1 (mpc/solver.al_terminal_cost)."""
    p = c.p
    n_, mu, vy = z[1], z[2], z[4]
    zero = jnp.zeros_like(z[0])
    rows = _constraints(c, z, (zero, zero), n_con)
    rows = [g if (j < 10 or j >= N_CON) else zero - 1.0 for j, g in enumerate(rows)]
    mterm = p["q_n"] * n_**2 + p["q_mu"] * mu**2 + vy**2
    return mterm + _penalty(c, rows, lams)


def _kernel(
    # per-instance inputs (batch axis squeezed by the BlockSpecs)
    A_ref,      # (NP, PZ, PZ)
    lzz_ref,    # (NP, PZ, PZ)
    Bt_ref,     # (NP, NU, PZ)  rows of Bᵀ
    luz_ref,    # (NP, NU, PZ)
    lz_ref,     # (NP, PZ)
    lu_ref,     # (N, NU)
    luu_ref,    # (N, NU, NU)
    Vz_ref,     # (PZ,)         terminal gradient
    Vzz_ref,    # (PZ, PZ)      terminal Hessian
    zs_ref,     # (N+1, NZ)     reference trajectory
    us_ref,     # (N, NU)       reference inputs
    lams_ref,   # (N+1, n_con)
    reg_ref,    # (1,)          Levenberg regularization
    # shared inputs
    tab_ref,    # (4·n,)        k, nl, nr, vref tables, flattened
    alphas_ref, # (LP,)         line-search step sizes
    scal_ref,   # (NS,)
    # outputs
    zall_ref,   # (N+1, NZ, LP) every rung's trajectory
    uall_ref,   # (N, NU, LP)
    cost_ref,   # (LP,)         every rung's AL cost
    ok_ref,     # (1,)          1.0 if the backward pass stayed finite
    *,
    N: int,
    n_table: int,
    n_con: int,
    substeps: int,
    closed: bool,
    tv: bool,
):
    c = _Ctx(scal_ref, tab_ref, n_table, closed, tv)
    dtype = Vz_ref.dtype
    NP = A_ref.shape[0]
    LP = alphas_ref.shape[0]
    reg = reg_ref[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (NP,), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (PZ,), 0)
    dot = functools.partial(
        jnp.dot, preferred_element_type=dtype, precision=jax.lax.Precision.HIGHEST
    )
    outer = lambda a, b: a[:, None] * b[None, :]

    # ---------------------------------------------------------------- Riccati
    def bwd_body(i, carry):
        Vz, Vzz, ok, k0s, k1s, K0s, K1s = carry
        k = N - 1 - i
        A = A_ref[k]
        b0, b1 = Bt_ref[k, 0], Bt_ref[k, 1]
        Qz = lz_ref[k] + jnp.sum(A * Vz[:, None], axis=0)       # lz + Aᵀ Vz
        Qu0 = lu_ref[k, 0] + jnp.sum(b0 * Vz)
        Qu1 = lu_ref[k, 1] + jnp.sum(b1 * Vz)
        VzzA = dot(Vzz, A)
        Qzz = lzz_ref[k] + dot(A.T, VzzA)
        Vb0 = jnp.sum(Vzz * b0[None, :], axis=1)                 # Vzz b0
        Vb1 = jnp.sum(Vzz * b1[None, :], axis=1)
        Q00 = luu_ref[k, 0, 0] + jnp.sum(b0 * Vb0)
        Q01 = luu_ref[k, 0, 1] + jnp.sum(b0 * Vb1)
        Q10 = luu_ref[k, 1, 0] + jnp.sum(b1 * Vb0)
        Q11 = luu_ref[k, 1, 1] + jnp.sum(b1 * Vb1)
        Quz0 = luz_ref[k, 0] + jnp.sum(VzzA * b0[:, None], axis=0)  # (Bᵀ Vzz A)₀
        Quz1 = luz_ref[k, 1] + jnp.sum(VzzA * b1[:, None], axis=0)

        # NU = 2: closed-form inverse of the regularized control Hessian
        a, b, cc, d = Q00 + reg, Q01, Q10, Q11 + reg
        det = a * d - b * cc
        k0 = -(d * Qu0 - b * Qu1) / det
        k1 = -(-cc * Qu0 + a * Qu1) / det
        K0 = -(d * Quz0 - b * Quz1) / det
        K1 = -(-cc * Quz0 + a * Quz1) / det

        Vz_new = (
            Qz
            + K0 * (Q00 * k0 + Q01 * k1) + K1 * (Q10 * k0 + Q11 * k1)
            + K0 * Qu0 + K1 * Qu1
            + Quz0 * k0 + Quz1 * k1
        )
        Vzz_new = (
            Qzz
            + Q00 * outer(K0, K0) + Q01 * outer(K0, K1)
            + Q10 * outer(K1, K0) + Q11 * outer(K1, K1)
            + outer(K0, Quz0) + outer(K1, Quz1)
            + outer(Quz0, K0) + outer(Quz1, K1)
        )
        Vzz_new = 0.5 * (Vzz_new + Vzz_new.T)
        ok = jnp.where(jnp.isfinite(k0) & jnp.isfinite(k1), ok, jnp.zeros_like(ok))
        hit = rows == k
        k0s = jnp.where(hit, k0, k0s)
        k1s = jnp.where(hit, k1, k1s)
        K0s = jnp.where(hit[:, None], K0[None, :], K0s)
        K1s = jnp.where(hit[:, None], K1[None, :], K1s)
        return Vz_new, Vzz_new, ok, k0s, k1s, K0s, K1s

    zeros_np = jnp.zeros((NP,), dtype)
    zeros_k = jnp.zeros((NP, PZ), dtype)
    _, _, ok, k0s, k1s, K0s, K1s = jax.lax.fori_loop(
        0, N, bwd_body,
        (Vz_ref[...], Vzz_ref[...], jnp.asarray(1.0, dtype), zeros_np, zeros_np,
         zeros_k, zeros_k),
    )
    ok_ref[0] = ok

    # ------------------------------------------------------- forward rollout
    alphas = alphas_ref[...]
    z = tuple(jnp.zeros((LP,), dtype) + zs_ref[0, i] for i in range(NZ))
    for i in range(NZ):
        zall_ref[0, i] = z[i]

    def fwd_body(k, carry):
        z, cacc = carry
        hit = rows == k
        K0 = jnp.sum(jnp.where(hit[:, None], K0s, 0.0), axis=0)
        K1 = jnp.sum(jnp.where(hit[:, None], K1s, 0.0), axis=0)
        u0 = us_ref[k, 0] + alphas * jnp.sum(jnp.where(hit, k0s, 0.0))
        u1 = us_ref[k, 1] + alphas * jnp.sum(jnp.where(hit, k1s, 0.0))
        for i in range(NZ):
            dz = z[i] - zs_ref[k, i]
            u0 = u0 + jnp.sum(jnp.where(cols == i, K0, 0.0)) * dz
            u1 = u1 + jnp.sum(jnp.where(cols == i, K1, 0.0)) * dz
        lams = [lams_ref[k, j] for j in range(n_con)]
        cacc = cacc + _stage_cost(c, z, (u0, u1), lams, n_con)
        z = _dyn_step(c, z, (u0, u1), substeps)
        for i in range(NZ):
            zall_ref[k + 1, i] = z[i]
        uall_ref[k, 0] = u0
        uall_ref[k, 1] = u1
        return z, cacc

    z, cacc = jax.lax.fori_loop(0, N, fwd_body, (z, jnp.zeros((LP,), dtype)))
    lams_T = [lams_ref[N, j] for j in range(n_con)]
    cost_ref[...] = cacc + _terminal_cost(c, z, lams_T, n_con)


def scal_vector(model, p, cfg, rho, dtype):
    """Pack model/OCP scalars into the kernel's (NS,) parameter row."""
    veh = model.vehicle
    track = model.track
    n = track.s_grid.shape[0]
    margin = p.lateral_margin
    if margin is None:
        margin = 0.0
    vals = {
        "rho": rho,
        "s_max": track.s_max,
        "inv_ds": (n - 1) / track.s_max,
        "h": cfg.dt / cfg.substeps,
        "mass": veh.mass,
        "length_f": veh.length_f,
        "length_r": veh.length_r,
        "rot_inertia": veh.rotational_inertia,
        "ptv": veh.ptv,
        "B_f": veh.B_f, "C_f": veh.C_f, "D_f": veh.D_f,
        "B_r": veh.B_r, "C_r": veh.C_r, "D_r": veh.D_r,
        "C_m": veh.C_m, "Cr_0": veh.Cr_0, "Cr_2": veh.Cr_2,
        "q_n": p.q_n, "q_mu": p.q_mu, "q_B": p.q_B,
        "r_delta": p.r_delta, "r_throttle": p.r_throttle,
        "vref_scale": p.vref_scale,
        "mu_max": p.mu_max, "steer_max": p.steer_max,
        "throttle_max": p.throttle_max,
        "dsteer_max": p.dsteer_max, "dthrottle_max": p.dthrottle_max,
        "half_len": 0.5 * (veh.length_f + veh.length_r),
        "half_wid": 0.5 * veh.width,
        "lateral_margin": margin,
    }
    return jnp.stack([jnp.asarray(vals[f], dtype) for f in _SCAL_FIELDS])


def tables_matrix(model, dtype):
    """(4, n) stacked lookup tables: k, dist_left, dist_right, vref."""
    t = model.track
    return jnp.stack([t.k_vals, t.nl_vals, t.nr_vals, t.vref_vals]).astype(dtype)


def _pad_axis(x, axis, size):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, size - x.shape[axis])
    return jnp.pad(x, pad)


def pad_stage_inputs(A, B, lz, lzz, luz, Vz, Vzz):
    """Pad the batched stage matrices to the kernel's power-of-two blocks:
    horizon N → NP, state NZ → PZ (zero fill), and B transposed to rows.
    Shapes in: A, lzz (Bt, N, NZ, NZ), B (Bt, N, NZ, NU), lz (Bt, N, NZ),
    luz (Bt, N, NU, NZ), Vz (Bt, NZ), Vzz (Bt, NZ, NZ)."""
    NP = next_pow2(A.shape[1])
    sq = lambda m: _pad_axis(_pad_axis(_pad_axis(m, 1, NP), 2, PZ), 3, PZ)
    return dict(
        A=sq(A),
        lzz=sq(lzz),
        Bt=_pad_axis(_pad_axis(jnp.swapaxes(B, 2, 3), 1, NP), 3, PZ),
        luz=_pad_axis(_pad_axis(luz, 1, NP), 3, PZ),
        lz=_pad_axis(_pad_axis(lz, 1, NP), 2, PZ),
        Vz=_pad_axis(Vz, 1, PZ),
        Vzz=_pad_axis(_pad_axis(Vzz, 1, PZ), 2, PZ),
    )


def pad_ladder(alphas):
    """Step sizes padded to a power of two by repeating the last one; the
    padded rungs' costs are masked out by `select_best`."""
    L = alphas.shape[0]
    LP = next_pow2(L)
    return jnp.concatenate([alphas, jnp.repeat(alphas[-1:], LP - L)])


def select_best(zall, uall, costs, L):
    """Cheapest finite rung among the first L per instance (ties: lowest
    index, like the XLA path's argmin).  zall (Bt, N+1, NZ, LP), uall
    (Bt, N, NU, LP), costs (Bt, LP) → zs (Bt, N+1, NZ), us (Bt, N, NU),
    cost (Bt,)."""
    lane = jnp.arange(costs.shape[1])
    costs = jnp.where((lane < L) & jnp.isfinite(costs), costs, jnp.inf)
    best = jnp.argmin(costs, axis=1)
    pick = lambda a: jnp.take_along_axis(a, best[:, None, None, None], axis=3)[..., 0]
    return pick(zall), pick(uall), jnp.min(costs, axis=1)


def _pallas_iteration(static, A, lzz, Bt, luz, lz, lu, luu, Vz, Vzz, zs, us, lams,
                      reg, tables, alphas, scal):
    substeps, closed, tv, interpret = static
    Bn, NP = A.shape[0], A.shape[1]
    N = lu.shape[1]
    LP = alphas.shape[0]
    n_table = tables.shape[0] // 4
    n_con = lams.shape[2]
    dtype = zs.dtype
    kernel = functools.partial(
        _kernel, N=N, n_table=n_table, n_con=n_con, substeps=substeps,
        closed=closed, tv=tv,
    )

    def per_instance(*shape):
        zeros = (0,) * len(shape)
        return pl.BlockSpec((None, *shape), lambda b: (b, *zeros))

    def shared(*shape):
        zeros = (0,) * len(shape)
        return pl.BlockSpec(shape, lambda b: zeros)

    return pl.pallas_call(
        kernel,
        grid=(Bn,),
        in_specs=[
            per_instance(NP, PZ, PZ), per_instance(NP, PZ, PZ),
            per_instance(NP, NU, PZ), per_instance(NP, NU, PZ),
            per_instance(NP, PZ), per_instance(N, NU), per_instance(N, NU, NU),
            per_instance(PZ), per_instance(PZ, PZ),
            per_instance(N + 1, NZ), per_instance(N, NU),
            per_instance(N + 1, n_con), per_instance(1),
            shared(4 * n_table), shared(LP), shared(NS),
        ],
        out_specs=(
            per_instance(N + 1, NZ, LP), per_instance(N, NU, LP),
            per_instance(LP), per_instance(1),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((Bn, N + 1, NZ, LP), dtype),
            jax.ShapeDtypeStruct((Bn, N, NU, LP), dtype),
            jax.ShapeDtypeStruct((Bn, LP), dtype),
            jax.ShapeDtypeStruct((Bn, 1), dtype),
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="ilqr_riccati_linesearch",
    )(A, lzz, Bt, luz, lz, lu, luu, Vz, Vzz, zs, us, lams, reg, tables, alphas, scal)


_iteration = jax.custom_jvp(_pallas_iteration, nondiff_argnums=(0,))


@_iteration.defjvp
def _iteration_jvp(static, primals, tangents):
    raise NotImplementedError(
        "the fused iLQR kernel is forward-only (no derivative rule); "
        "differentiate the solve with SolverConfig(backend='xla')"
    )


@functools.partial(jax.jit, static_argnames=("substeps", "closed", "tv", "interpret"))
def backward_forward(
    A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, reg, tables, alphas, scal,
    *, substeps: int, closed: bool = True, tv: bool = False, interpret: bool = False,
):
    """One fused iLQR iteration for a batch of OCPs: Riccati backward pass +
    line-search rollout of every step size in `alphas`, one program per
    instance.  Every per-instance argument has a leading batch axis
    (A (Bt, N, NZ, NZ), ..., zs (Bt, N+1, NZ), lams (Bt, N+1, n_con),
    reg (Bt,)); tables (4, n), alphas (L,) and scal (NS,) are shared.
    Returns (zs_new (Bt, N+1, NZ), us_new (Bt, N, NU), cost (Bt,),
    ok (Bt,) 1.0/0.0).  The constraint count (14, or 16 with the
    friction-ellipse rows) is taken from the multiplier shape."""
    padded = pad_stage_inputs(A, B, lz, lzz, luz, Vz, Vzz)
    zall, uall, costs, ok = _iteration(
        (substeps, closed, tv, interpret),
        padded["A"], padded["lzz"], padded["Bt"], padded["luz"], padded["lz"],
        lu, luu, padded["Vz"], padded["Vzz"], zs, us, lams, reg[:, None],
        tables.reshape(-1), pad_ladder(alphas), scal,
    )
    zs_new, us_new, cost = select_best(zall, uall, costs, alphas.shape[0])
    return zs_new, us_new, cost, ok[:, 0]
