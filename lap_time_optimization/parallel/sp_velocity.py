"""Sequence-parallel velocity-profile solver: the sample axis sharded across
devices with explicit collectives (SURVEY.md §5 long-context plan).

The quasi-static profile solve is a cyclic min-plus recurrence over ~N
per-metre samples.  `ops.velocity.solve_profile_parallel` already reduces the
depth to O(sweeps·log N) on one device; this module distributes the sample
axis over the mesh's 'sp' axis with `shard_map`:

* each device owns a contiguous block of the (rolled) sample arrays;
* the neighbor halo (previous device's last velocity) arrives by `ppermute`
  — the ring halo exchange riding ICI;
* each frozen-coefficient sweep runs a *block-scan*: local associative
  min-plus scan + an `all_gather` of the tiny per-block summaries, composed
  into the incoming prefix for each block — one collective round per sweep
  instead of N sequential steps.

Exactness: identical fixpoint to the sequential solver (same Jacobi sweeps as
the single-device parallel schedule), oracle-tested on the virtual CPU mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from lap_time_optimization.ops.velocity import local_limit

_BIG = 1e30


def _block_sweep(vehicle, e, e_loc, k_prev, ds, chain_ok, valid0, accelerating: bool, axis: str):
    """One frozen-coefficient sweep under shard_map; arrays are local blocks.

    `chain_ok` (float 0/1) marks links that may constrain their successor;
    masked links get an unbounded gain so the scan restarts from the local
    limit there (open-track wrap semantics)."""
    sp_idx = jax.lax.axis_index(axis)
    n_sp = jax.lax.axis_size(axis)

    v = jnp.sqrt(e)
    # halo: previous element of v; block-first element needs the previous
    # device's last value (ring ppermute, wrapping for the cyclic closure)
    left_halo = jax.lax.ppermute(v[-1], axis, [(i, (i + 1) % n_sp) for i in range(n_sp)])
    v_prev = jnp.concatenate([left_halo[None], v[:-1]])

    if accelerating:
        force = jnp.minimum(vehicle.engine_force(v_prev), vehicle.traction(v_prev, k_prev))
    else:
        force = vehicle.traction(v_prev, k_prev)
    b = 2.0 * (force / vehicle.mass) * ds
    b = jnp.where(chain_ok > 0.5, b, _BIG)

    # cyclic closure into global element 0 (lives on device 0): the link from
    # the global last element, e[-1] + b[0]; invalid (open-track) masks to BIG
    e_last_global = jax.lax.ppermute(
        e[-1], axis, [(n_sp - 1, 0)]
    )  # only device 0 receives a meaningful value
    link0 = jnp.where(valid0, e_last_global + b[0], _BIG)
    c = e_loc
    c = jnp.where(
        (sp_idx == 0) & (jnp.arange(c.shape[0]) == 0), jnp.minimum(c, link0), c
    )

    # local min-plus scan: within-block composed maps (c_i, B_i)
    def combine(left, right):
        c_l, b_l = left
        c_r, b_r = right
        return jnp.minimum(c_r, c_l + b_r), b_l + b_r

    c_scan, b_scan = jax.lax.associative_scan(combine, (c, b))

    # block summary = composed map of the whole block = last scan element
    summary = jnp.stack([c_scan[-1], b_scan[-1]])  # (2,)
    summaries = jax.lax.all_gather(summary, axis)  # (n_sp, 2)

    # exclusive prefix composition of the block maps → incoming value x_in.
    # x starts at +inf before block 0 (element 0's own chain link was folded
    # into c above), so x_in for block j = (C,B) prefix of blocks < j applied
    # to +inf = C_prefix.
    def prefix_step(carry, s_j):
        c_p, b_p = carry
        out = c_p  # x_in for this block
        c_n = jnp.minimum(s_j[0], c_p + s_j[1])
        b_n = b_p + s_j[1]
        return (c_n, b_n), out

    init = jax.lax.pcast(
        (jnp.asarray(_BIG, e.dtype), jnp.zeros((), e.dtype)), (axis,), to="varying"
    )
    (_, _), x_ins = jax.lax.scan(prefix_step, init, summaries)
    x_in = x_ins[sp_idx]

    e_new = jnp.minimum(e_loc, jnp.minimum(c_scan, x_in + b_scan))
    return e_new


@partial(jax.jit, static_argnames=("mesh", "closed", "sweeps", "axis"))
def solve_profile_sp(
    vehicle,
    s: jax.Array,
    k_abs: jax.Array,
    s_max,
    mesh: Mesh,
    closed: bool = True,
    sweeps: int = 16,
    axis: str = "sp",
):
    """Sample-axis-sharded profile solve over `mesh` axis `axis`.

    Single-controller convenience wrapper: pads N to the shard multiple with
    transparent elements (no local limit, zero chain gain), rolls to the
    global minimum like the sequential solver, runs the sharded sweeps for
    both directions, and unpads.
    """
    n = s.shape[0]
    n_sp = mesh.shape[axis]
    n_pad = -(-n // n_sp) * n_sp
    pad = n_pad - n

    v_local = local_limit(vehicle, k_abs)
    i0 = jnp.argmin(v_local)
    idx = jnp.arange(n)

    sr = jnp.roll(s, -i0)
    kr = jnp.roll(k_abs, -i0)
    vr = jnp.roll(v_local, -i0)

    def pad_arrays(v_loc, k_prev, ds):
        # transparent padding: huge local limit, zero gain → x passes through
        v_loc = jnp.concatenate([v_loc, jnp.full((pad,), jnp.sqrt(_BIG), v_loc.dtype)])
        k_prev = jnp.concatenate([k_prev, jnp.zeros((pad,), k_prev.dtype)])
        ds = jnp.concatenate([ds, jnp.zeros((pad,), ds.dtype)])
        return v_loc, k_prev, ds

    def run_pass(v_loc, k_prev, ds, chain_ok, valid0, accelerating):
        v_loc, k_prev, ds = pad_arrays(v_loc, k_prev, ds)
        # padded links are transparent pass-throughs: chain allowed, zero gain
        chain_ok = jnp.concatenate([chain_ok, jnp.ones((pad,), chain_ok.dtype)])
        e_loc = v_loc * v_loc

        def sharded(veh, v0, e_loc_l, k_l, ds_l, mask_l):
            e = e_loc_l

            def body(e, _):
                return (
                    _block_sweep(veh, e, e_loc_l, k_l, ds_l, mask_l, v0, accelerating, axis),
                    None,
                )

            e, _ = jax.lax.scan(body, e, None, length=sweeps)
            return e

        spec = P(axis)
        # vehicle params and the closure flag are replicated (P()) — shard_map
        # forbids closing over traced values
        fn = jax.shard_map(
            sharded,
            mesh=mesh,
            in_specs=(P(), P(), spec, spec, spec, spec),
            out_specs=spec,
        )
        e = fn(vehicle, valid0, e_loc, k_prev, ds, chain_ok)
        return jnp.sqrt(e[:n])

    dtype = s.dtype
    # forward pass; element 0 is the rolled global minimum so its incoming
    # link is irrelevant (exact — see ops.velocity.solve_profile_parallel)
    ds_raw = sr - jnp.roll(sr, 1)
    if closed:
        ds_f = jnp.mod(ds_raw, s_max)
        mask_f = jnp.ones((n,), dtype)
        valid0 = jnp.asarray(False)  # closure folded through the min element
    else:
        wrap = jnp.mod(-i0, n)
        ds_f = ds_raw
        mask_f = (idx != wrap).astype(dtype)
        valid0 = jnp.asarray(False)
    v_acc = run_pass(vr, jnp.roll(kr, 1), ds_f, mask_f, valid0, True)
    v_acc = jnp.roll(v_acc, i0)

    # backward pass
    sf, kf, vf = jnp.flip(sr), jnp.flip(kr), jnp.flip(vr)
    ds_raw_b = jnp.roll(sf, 1) - sf
    if closed:
        ds_b = jnp.mod(ds_raw_b, s_max)
        mask_b = jnp.ones((n,), dtype)
        valid0_b = jnp.asarray(True)
    else:
        ds_b = ds_raw_b
        mask_b = (idx != i0).astype(dtype)
        valid0_b = i0 != 0
    v_dec = run_pass(vf, jnp.roll(kf, 1), ds_b, mask_b, valid0_b, False)
    v_dec = jnp.roll(jnp.flip(v_dec), i0)

    return jnp.minimum(v_acc, v_dec)
