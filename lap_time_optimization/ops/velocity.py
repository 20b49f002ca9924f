"""Quasi-static velocity-profile solver (3-pass) as differentiable JAX scans.

Capability-parity rebuild of the reference's `VelocityProfile`
(src/velocity.py:9-76), which runs two sequential Python loops over ~860
per-metre samples:

1. local lateral limit  v = sqrt(μ g / κ)                 (src/velocity.py:28-29)
2. forward pass from the globally slowest point, limiting acceleration by
   min(engine, traction)/m with v' = sqrt(v² + 2 a Δs)    (src/velocity.py:31-53)
3. an identical backward pass for braking                 (src/velocity.py:55-76)

final profile v = min(accel-limited, decel-limited)       (src/velocity.py:26)

Design notes:
* The passes are genuine first-order recurrences with state-dependent
  acceleration, expressed as `lax.scan`.  A single candidate is latency-bound,
  but the scan body is pure vector math, so `vmap` over a candidate batch turns
  every step into wide vector ops — the batched search path (nonlinear/bayes/
  sector methods) runs thousands of profiles per scan sweep.
* Closed-lap wraparound is handled by rolling the sample axis so the scan
  starts at the argmin of the local limit (exactly the reference's roll/flip
  trick), with the wrap Δs taken modulo the lap length.
* Everything is differentiable: the saturated-traction branch uses NaN-safe
  double-where guards (in the vehicle models) and min/where subgradients, so
  `jax.grad` of lap time w.r.t. the alphas replaces the reference's
  finite-difference L-BFGS-B.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

GRAV = 9.81  # m s^-2


def local_limit(vehicle, k_abs: jax.Array) -> jax.Array:
    """Lateral-grip speed limit sqrt(μ g / κ) (src/velocity.py:28-29)."""
    k_safe = jnp.maximum(k_abs, 1e-12)
    return jnp.sqrt(vehicle.friction_coef * GRAV / k_safe)


def _directional_pass(vehicle, v_loc, k_prev, ds, valid, accelerating: bool):
    """One monotone sweep: limit v[j] by the reachable speed from v[j-1].

    All inputs are already rolled/flipped so the sweep is a plain left-to-right
    recurrence; `valid[j]` masks the wrap step on open tracks.
    """

    def step(v_prev, inp):
        v_here, k_p, ds_j, valid_j = inp
        if accelerating:
            force = jnp.minimum(vehicle.engine_force(v_prev), vehicle.traction(v_prev, k_p))
        else:
            force = vehicle.traction(v_prev, k_p)
        accel = force / vehicle.mass
        vlim = jnp.sqrt(v_prev * v_prev + 2.0 * accel * ds_j)
        v_new = jnp.where(valid_j & (v_here > v_prev), jnp.minimum(v_here, vlim), v_here)
        return v_new, v_new

    _, v_out = jax.lax.scan(step, v_loc[-1], (v_loc, k_prev, ds, valid))
    return v_out


@partial(jax.jit, static_argnames=("closed",))
def solve_profile(vehicle, s: jax.Array, k_abs: jax.Array, s_max, closed: bool = True):
    """Solve the 3-pass velocity profile.

    Args:
      vehicle: a vehicle pytree exposing `engine_force(v)` / `traction(v, k)`.
      s: (N,) sample distances, excluding the duplicated endpoint for closed
         laps (matching reference usage, src/trajectory.py:49-52).
      k_abs: (N,) absolute curvature at the samples.
      s_max: lap length for closed laps (ignored when closed=False).
      closed: static flag selecting wraparound semantics.

    Returns: (N,) velocity profile v = min(v_acc, v_dec).
    """
    s = jnp.asarray(s)
    k_abs = jnp.asarray(k_abs)
    n = s.shape[0]
    v_local = local_limit(vehicle, k_abs)
    i0 = jnp.argmin(v_local)
    idx = jnp.arange(n)

    sr = jnp.roll(s, -i0)
    kr = jnp.roll(k_abs, -i0)
    vr = jnp.roll(v_local, -i0)

    # ---- forward (acceleration) pass
    ds_raw = sr - jnp.roll(sr, 1)
    if closed:
        ds_fwd = jnp.mod(ds_raw, s_max)
        valid_fwd = jnp.ones((n,), dtype=bool)
    else:
        ds_fwd = ds_raw
        valid_fwd = idx != jnp.mod(-i0, n)
    v_acc = _directional_pass(vehicle, vr, jnp.roll(kr, 1), ds_fwd, valid_fwd, accelerating=True)
    v_acc = jnp.roll(v_acc, i0)

    # ---- backward (braking) pass: flip, sweep, unflip
    sf = jnp.flip(sr)
    kf = jnp.flip(kr)
    vf = jnp.flip(vr)
    ds_raw_b = jnp.roll(sf, 1) - sf
    if closed:
        ds_bwd = jnp.mod(ds_raw_b, s_max)
        valid_bwd = jnp.ones((n,), dtype=bool)
    else:
        ds_bwd = ds_raw_b
        valid_bwd = idx != i0
    v_dec = _directional_pass(vehicle, vf, jnp.roll(kf, 1), ds_bwd, valid_bwd, accelerating=False)
    v_dec = jnp.roll(jnp.flip(v_dec), i0)

    return jnp.minimum(v_acc, v_dec)


def lap_time(s: jax.Array, v: jax.Array) -> jax.Array:
    """Lap time Σ Δs / v with s (ns,) samples and v (ns-1,) profile
    (reference src/trajectory.py:54-58)."""
    return jnp.sum(jnp.diff(s) / v)


# --------------------------------------------------------------------------- parallel solver
def _minplus_scan(c: jax.Array, b: jax.Array) -> jax.Array:
    """Solve x_i = min(c_i, x_{i-1} + b_i) with x_{-1} = +inf in log depth.

    The affine-min maps f_i(x) = min(c_i, x + b_i) compose associatively:
    (c_j, b_j) ∘ (c_i, b_i) = (min(c_j, c_i + b_j), b_i + b_j), so the whole
    recurrence is one `associative_scan` — ~log2(N) wide VPU steps instead of
    N sequential scan steps.
    """

    def combine(left, right):
        c_l, b_l = left
        c_r, b_r = right
        return jnp.minimum(c_r, c_l + b_r), b_l + b_r

    c_out, _ = jax.lax.associative_scan(combine, (c, b), axis=-1)
    return c_out


def _parallel_pass(vehicle, v_loc, k_prev, ds, valid, accelerating: bool, sweeps: int):
    """Fixpoint of the monotone sweep via repeated frozen-coefficient scans.

    Linearize in v²: with e_i = v_i², the exact recurrence is
      e_i = min(e_loc_i, e_{i-1} + 2·a(v_{i-1}, k_{i-1})·Δs_i)
    Freezing a at the current iterate turns each sweep into a min-plus scan
    (nonlinear Jacobi); iterates oscillate around the exact profile with a
    contraction rate set by |da/dv|·Δs and converge to the sequential
    fixpoint — see `solve_profile_parallel` for sweep-count guidance
    (SURVEY.md §5 sequence-parallel plan).
    """
    e_loc = v_loc * v_loc
    big = jnp.asarray(jnp.finfo(v_loc.dtype).max / 4, v_loc.dtype)

    def sweep(e, _):
        v = jnp.sqrt(e)
        v_prev = jnp.roll(v, 1, axis=-1)
        if accelerating:
            force = jnp.minimum(vehicle.engine_force(v_prev), vehicle.traction(v_prev, k_prev))
        else:
            force = vehicle.traction(v_prev, k_prev)
        b = 2.0 * (force / vehicle.mass) * ds
        # masked (open-track wrap) entries break the chain: allow unlimited
        # increase across them so the scan restarts from the local limit
        b = jnp.where(valid, b, big)
        # cyclic closure: fold the link from the last element into position 0
        # (x_{-1} = e[-1] rather than +inf); exact because a second trip
        # around the lap cannot lower anything further once e has converged
        link0 = jnp.where(valid[0], e[-1] + b[0], big)
        c = e_loc.at[0].set(jnp.minimum(e_loc[0], link0))
        e_new = jnp.minimum(e_loc, _minplus_scan(c, b))
        return e_new, None

    e, _ = jax.lax.scan(sweep, e_loc, None, length=sweeps)
    return jnp.sqrt(e)


@partial(jax.jit, static_argnames=("closed", "sweeps"))
def solve_profile_parallel(
    vehicle, s: jax.Array, k_abs: jax.Array, s_max, closed: bool = True, sweeps: int = 16
):
    """Log-depth variant of `solve_profile` for large candidate batches.

    Identical physics, different schedule: each directional pass runs
    `sweeps` frozen-coefficient associative scans (O(sweeps·log N) wide ops)
    instead of N sequential steps, so vmapped batches keep the VPU busy and
    the sample axis can shard over the mesh's 'sp' axis.  Converges to the
    sequential profile (oracle-tested): smooth traction laws (MX5) contract
    in ~4 sweeps; friction-circle laws whose traction vanishes at the local
    limit (tbr18) are stiffer and need ~16 (the default covers both).

    Note: the scan starts at the rolled global minimum like the sequential
    pass, and one extra wrap chain link is handled by seeding the scan with
    the (never-limited) minimum at position 0.
    """
    s = jnp.asarray(s)
    k_abs = jnp.asarray(k_abs)
    n = s.shape[0]
    v_local = local_limit(vehicle, k_abs)
    i0 = jnp.argmin(v_local)
    idx = jnp.arange(n)

    sr = jnp.roll(s, -i0)
    kr = jnp.roll(k_abs, -i0)
    vr = jnp.roll(v_local, -i0)

    ds_raw = sr - jnp.roll(sr, 1)
    if closed:
        ds_fwd = jnp.mod(ds_raw, s_max)
        valid_fwd = jnp.ones((n,), dtype=bool)
    else:
        ds_fwd = ds_raw
        valid_fwd = idx != jnp.mod(-i0, n)
    # position 0 is the global minimum: it is never limited, and the chain
    # from the last element cannot lower it, so dropping that link (mask) is
    # exact and makes the scan a plain prefix problem
    valid_fwd = valid_fwd & (idx != 0)
    v_acc = _parallel_pass(vehicle, vr, jnp.roll(kr, 1), ds_fwd, valid_fwd, True, sweeps)
    v_acc = jnp.roll(v_acc, i0)

    sf = jnp.flip(sr)
    kf = jnp.flip(kr)
    vf = jnp.flip(vr)
    ds_raw_b = jnp.roll(sf, 1) - sf
    if closed:
        ds_bwd = jnp.mod(ds_raw_b, s_max)
        valid_bwd = jnp.ones((n,), dtype=bool)
    else:
        ds_bwd = ds_raw_b
        valid_bwd = idx != i0
    v_dec = _parallel_pass(vehicle, vf, jnp.roll(kf, 1), ds_bwd, valid_bwd, False, sweeps)
    v_dec = jnp.roll(jnp.flip(v_dec), i0)

    return jnp.minimum(v_acc, v_dec)
