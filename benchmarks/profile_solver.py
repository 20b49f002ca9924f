"""Microbenchmark the AL-iLQR pieces on the current backend.

Usage: python benchmarks/profile_solver.py [--horizon 10]
Times (per call, steady state): full solve, backward pass, forward pass,
quadraticization alone, dynamics linearization alone.
"""

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, n=50):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--platform", type=str, default=None)
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import os

    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.models.bicycle import BicycleModel
    from lap_time_optimization.mpc import runner, solver as S
    from lap_time_optimization.mpc import track as mpc_track
    from lap_time_optimization.mpc.solver import N_CON, NU, NZ, OCPParams, SolverConfig

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=os.path.join(repo, "data"))
    model = BicycleModel(vehicle=load_vehicle("MX5"), track=track)
    dtype = track.s_grid.dtype
    p = OCPParams.reference(dtype)
    cfg = SolverConfig(horizon=args.horizon)
    N = cfg.horizon

    x0 = jnp.asarray(runner.X0_REFERENCE, dtype)
    z0 = jnp.concatenate([x0, jnp.zeros((NU,), dtype)])
    us = jnp.zeros((N, NU), dtype)
    lams = jnp.zeros((N + 1, N_CON), dtype)
    zs = S._rollout(model, cfg, z0, us)
    rho = jnp.asarray(cfg.rho_init, dtype)
    reg = jnp.asarray(cfg.reg_init, dtype)

    solve_j = jax.jit(lambda z0, us, lams: S.solve(model, p, cfg, z0, us, lams))
    bwd_j = jax.jit(lambda zs, us, lams: S._backward_pass(model, p, cfg, zs, us, lams, rho, reg))
    ks, Ks, _ = bwd_j(zs, us, lams)
    fwd_j = jax.jit(lambda zs, us, ks, Ks, lams: S._forward_pass(model, p, cfg, zs, us, ks, Ks, lams, rho))

    def quads_only(zs, us, lams):
        def quads(z, u, lam):
            c = lambda zz, uu: S.al_stage_cost(model, p, zz, uu, lam, rho)
            lz = jax.grad(c, argnums=0)(z, u)
            lu = jax.grad(c, argnums=1)(z, u)
            lzz = jax.hessian(c, argnums=0)(z, u)
            luu = jax.hessian(c, argnums=1)(z, u)
            luz = jax.jacfwd(jax.grad(c, argnums=1), argnums=0)(z, u)
            return lz, lu, lzz, luu, luz

        return jax.vmap(quads)(zs[:-1], us, lams[:-1])

    quads_j = jax.jit(quads_only)

    def lin_only(zs, us):
        A = jax.vmap(lambda z, u: jax.jacfwd(lambda zz: S.dynamics_step(model, cfg, zz, u))(z))(zs[:-1], us)
        B = jax.vmap(lambda z, u: jax.jacfwd(lambda uu: S.dynamics_step(model, cfg, z, uu))(u))(zs[:-1], us)
        return A, B

    lin_j = jax.jit(lin_only)

    t_solve = timeit(solve_j, z0, us, lams)
    t_bwd = timeit(bwd_j, zs, us, lams)
    t_fwd = timeit(fwd_j, zs, us, ks, Ks, lams)
    t_quad = timeit(quads_j, zs, us, lams)
    t_lin = timeit(lin_j, zs, us)
    n_rounds = cfg.al_iters * cfg.ilqr_iters
    print(f"backend={jax.devices()[0].platform} horizon={N} dtype={dtype}")
    print(f"full solve          {t_solve*1e3:8.3f} ms   ({1/t_solve:6.1f} Hz)")
    print(f"backward pass       {t_bwd*1e3:8.3f} ms x{n_rounds}/solve = {n_rounds*t_bwd*1e3:6.2f} ms")
    print(f"  quadraticization  {t_quad*1e3:8.3f} ms")
    print(f"  dyn linearization {t_lin*1e3:8.3f} ms")
    print(f"forward pass        {t_fwd*1e3:8.3f} ms x{n_rounds}/solve = {n_rounds*t_fwd*1e3:6.2f} ms")


if __name__ == "__main__":
    main()
