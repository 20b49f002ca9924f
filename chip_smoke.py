"""Smoke run of both pipelines on NVIDIA GPUs, through their normal entry points.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: the dp-sharded paths only

One GPU, in order:
  1. the device and the card's name and power limit (read by `nvidia-smi`
     in a child process that does not import JAX); fails unless JAX's first
     device is a GPU;
  2. the fused iLQR kernel compiled at its real widths (h10, ladder of 6,
     the 846-sample MX-5/buckmore table, batch 1 and 128), with
     `memory_analysis()` of each program;
  3. the kernel against the XLA path on the same card, both f32 at HIGHEST
     matmul precision: one iteration with 14 and 16 constraint rows, a full
     `solve`, and `solve_batch` at B = 128 against `vmap(solve)`;
  4. the single-car closed loop (MX-5, buckmore, h10, 500 steps) through
     `cli.mpc.main` on both backends: applied-state violation < 1e-2 and
     progress within 1 % of the XLA route's;
  5. two B = 128 fleets (100 steps) through `runner.closed_loop_batch` on
     both backends: one from the start line with speeds fanned over
     4-6 m/s, under the same gates; one from states spread over the first
     400 steps (~380 m) of the single car's XLA-route closed loop, where
     the kernel is held to the XLA route (see `_like_xla`);
  6. the racing line (tbr18 on buckmore, width 0.99) through `cli.race`
     with `--laptime` (must beat the published 40.892 s) and `--bayes`
     (within 1 % of the published 36.227 s); artifacts go under
     `chiprun_out/smoke/`.

Four GPUs (`--four-cards`): `runner.closed_loop_fleet` over a 4-device
'dp' mesh at 4 × 128 loops against `closed_loop_batch` on one card for the
same initial states, and one `parallel.mesh.search_step` over a (4, 1) mesh
against the unsharded step; each output's shard placement is printed.

Any failed phase raises, so the exit code is non-zero and the result line is
not printed.  The times printed are smoke timings on the named card, not
benchmark cells.  The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "data")
OUT = os.path.join(ROOT, "chiprun_out", "smoke")

# published laps (reference README.md tables, buckmore, width 0.99)
TBR18_LAPTIME_PUBLISHED = 40.892
TBR18_BAYES_PUBLISHED = 36.227


def _gate(ok: bool, message: str):
    """A failed check ends the run (an `assert` would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"[smoke] FAILED: {message}")


def card_description() -> str:
    """`name, power.limit` of the first card, read by nvidia-smi in a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def check_device(count: int = 1, platform: str = "gpu"):
    """Phase 1: print the devices; fail unless the first is a `platform`
    device and there are at least `count` of them."""
    import jax

    devs = jax.devices()
    print(f"[smoke] devices: {devs}")
    if devs[0].platform != platform:
        raise SystemExit(
            f"[smoke] no GPU: JAX's first device is {devs[0].platform!r}"
        )
    if len(devs) < count:
        raise SystemExit(f"[smoke] need {count} devices, JAX has {len(devs)}")
    return devs


def nmpc_stack(dtype=None):
    """MX-5 on buckmore tracking the shipped curvature line; the solver and
    OCP settings of the CLI's default (h10, dt 0.1 s, 5 cm margin)."""
    import jax.numpy as jnp

    from lap_time_optimization.models import load_vehicle
    from lap_time_optimization.models.bicycle import BicycleModel
    from lap_time_optimization.mpc import track as mpc_track
    from lap_time_optimization.mpc.solver import OCPParams

    dtype = dtype or jnp.float32
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=DATA)
    model = BicycleModel(vehicle=load_vehicle("MX5"), track=track)
    model = _cast(model, dtype)
    return model, OCPParams.reference(dtype, lateral_margin=0.05)


def _cast(tree, dtype):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree
    )


def fleet_x0(B: int, dtype, s_spread: float = 0.0):
    """B initial states: the reference start state with speeds fanned over
    4-6 m/s and, optionally, arc lengths spread over `s_spread` metres.
    The spread is for single solves only: with n = 0 kept, 60 of 128 starts
    over 600 m put the car's footprint outside the band at t = 0 (the line
    runs within half a car's width of the edge at apexes), so no closed loop
    from them can pass the band gate.  Closed-loop fleets spread over the
    lap start from `lap_states`."""
    import jax.numpy as jnp
    import numpy as np

    from lap_time_optimization.mpc import runner

    x0 = np.tile(runner.X0_REFERENCE, (B, 1))
    frac = np.arange(B) / max(B - 1, 1)
    x0[:, 3] = 4.0 + 2.0 * frac
    x0[:, 0] = s_spread * frac
    return jnp.asarray(x0, dtype)


def _iteration_inputs(model, cfg, x0_b):
    import jax
    import jax.numpy as jnp

    from lap_time_optimization.mpc import solver as S

    dtype = x0_b.dtype
    B = x0_b.shape[0]
    z0 = jnp.concatenate([x0_b, jnp.zeros((B, S.NU), dtype)], axis=1)
    us = jnp.full((B, cfg.horizon, S.NU), 0.05, dtype)
    lams = jnp.zeros((B, cfg.horizon + 1, S.n_con(model)), dtype)
    zs = jax.vmap(lambda z, u: S._rollout(model, cfg, z, u))(z0, us)
    return z0, zs, us, lams


def compile_kernel(model, p, cfg, B: int, backend: str = "pallas"):
    """Phase 2: compile one fused iteration at batch B and print its
    memory analysis."""
    import jax
    import jax.numpy as jnp

    from lap_time_optimization.mpc import solver as S

    dtype = model.track.s_grid.dtype
    _, zs, us, lams = _iteration_inputs(model, cfg, fleet_x0(B, dtype))
    rho = jnp.asarray(cfg.rho_init, dtype)
    interpret = backend == "interpret"
    fn = jax.jit(
        lambda zs, us, lams, reg: S._iterate_kernel(
            model, p, cfg, zs, us, lams, rho, reg, interpret
        )
    )
    t0 = time.perf_counter()
    compiled = fn.lower(zs, us, lams, jnp.full((B,), 1e-6, dtype)).compile()
    print(f"[smoke] kernel B={B} compiled in {time.perf_counter() - t0:.2f} s; "
          f"memory: {compiled.memory_analysis()}")
    return compiled


def kernel_parity(model, p, backend: str = "pallas", B: int = 128, ilqr_iters: int = 5):
    """Phase 3: the kernel against the XLA path on the same device."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from lap_time_optimization.mpc import solver as S
    from lap_time_optimization.mpc.solver import SolverConfig

    interpret = backend == "interpret"
    dtype = model.track.s_grid.dtype
    with jax.default_matmul_precision("highest"):
        for rows, m in ((14, model), (16, dataclasses.replace(model, enable_traction_ellipse=True))):
            cfg = SolverConfig(horizon=10)
            _, zs, us, lams = _iteration_inputs(m, cfg, fleet_x0(1, dtype))
            rho = jnp.asarray(cfg.rho_init, dtype)
            reg = jnp.asarray(1e-6, dtype)
            ks, Ks, _ = S._backward_pass(m, p, cfg, zs[0], us[0], lams[0], rho, reg)
            cost_x, zs_x, us_x = S._forward_pass(m, p, cfg, zs[0], us[0], ks, Ks, lams[0], rho)
            cost_k, zs_k, us_k, div = S._iterate_kernel(
                m, p, cfg, zs, us, lams, rho, reg[None], interpret
            )
            _gate(not bool(div[0]), f"kernel diverged ({rows} rows)")
            np.testing.assert_allclose(np.asarray(zs_k[0]), np.asarray(zs_x), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(np.asarray(us_k[0]), np.asarray(us_x), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(cost_k[0]), float(cost_x), rtol=1e-4)
            print(f"[smoke] parity: one iteration, {rows} rows: max |dz| "
                  f"{float(jnp.max(jnp.abs(zs_k[0] - zs_x))):.3e}")

        cfg_x = SolverConfig(horizon=10, ilqr_iters=ilqr_iters, backend="xla")
        cfg_k = dataclasses.replace(cfg_x, backend=backend)
        z0, _, us, lams = _iteration_inputs(model, cfg_x, fleet_x0(B, dtype, s_spread=600.0))
        r_x = S.solve(model, p, cfg_x, z0[0], us[0], lams[0])
        r_k = S.solve(model, p, cfg_k, z0[0], us[0], lams[0])
        np.testing.assert_allclose(np.asarray(r_k.us), np.asarray(r_x.us), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(r_k.cost), float(r_x.cost), rtol=1e-4)
        print(f"[smoke] parity: full solve, max |du| "
              f"{float(jnp.max(jnp.abs(r_k.us - r_x.us))):.3e}")

        rb_x = S.solve_batch(model, p, cfg_x, z0, us, lams)  # vmap(solve)
        rb_k = S.solve_batch(model, p, cfg_k, z0, us, lams)
        for name in ("us", "zs"):
            np.testing.assert_allclose(
                np.asarray(getattr(rb_k, name)), np.asarray(getattr(rb_x, name)),
                rtol=2e-4, atol=2e-4,
            )
        print(f"[smoke] parity: solve_batch B={B} vs vmap(solve), max |du| "
              f"{float(jnp.max(jnp.abs(rb_k.us - rb_x.us))):.3e}")


def single_car(steps: int = 500, backends=("pallas", "xla")) -> dict:
    """Phase 4: the CLI's closed loop on each backend.  Each route's entry
    keeps its applied states under "xs"."""
    from lap_time_optimization.cli import mpc as mpc_cli
    from lap_time_optimization.mpc import runner

    os.makedirs(OUT, exist_ok=True)
    runs = {}
    for backend in backends:
        run = mpc_cli.main([
            "--curvature", "--steps", str(steps), "--backend", backend,
            "--data-dir", DATA, "--output", os.path.join(OUT, f"sim_{backend}.json"),
        ])
        viol = runner.applied_violation(run.model, run.params, run.result)
        progress = float(run.result.xs[-1, 0])
        runs[backend] = dict(steady_s=run.wall_steady, first_s=run.wall_first,
                             violation=viol, progress=progress, xs=run.result.xs)
        print(f"[smoke] single car {backend}: {steps} steps, steady {run.wall_steady:.4f} s "
              f"({steps / run.wall_steady:.1f} steps/s), first {run.wall_first:.2f} s, "
              f"applied violation {viol:.2e}, progress {progress:.2f} m")
        _gate(viol < 1e-2, f"{backend}: applied-state violation {viol} >= 1e-2")
    _same_progress(runs)
    return runs


def _same_progress(runs):
    if "xla" in runs:
        ref = runs["xla"]["progress"]
        for name, r in runs.items():
            _gate(abs(r["progress"] - ref) <= 0.01 * abs(ref),
                  f"{name} progress {r['progress']} not within 1% of xla's {ref}")


def spread_x0(lap_states, B: int, dtype):
    """B states picked evenly from a closed loop's applied states: cars
    already under control at points spread along the lap."""
    import jax.numpy as jnp
    import numpy as np

    lap_states = np.asarray(lap_states)
    return jnp.asarray(lap_states[np.linspace(0, len(lap_states) - 1, B).astype(int)], dtype)


def loop_violations(model, p, sim):
    """Each loop's max applied-state violation against the true band
    (`runner.applied_violation`, one number per loop of a batch)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lap_time_optimization.mpc.solver import NU, constraints

    g = jax.vmap(jax.vmap(
        lambda x, u: constraints(model, p, jnp.concatenate([x, jnp.zeros(NU, x.dtype)]), u)
    ))(sim.xs[:, 1:], sim.us[:, 1:])
    return np.asarray(jnp.max(g, axis=(1, 2)))


def _like_xla(runs, bound: float, max_flips: int = 2):
    """From spread starts the controller itself does not hold the band in
    every loop: one marginal loop leaves it by ~1.4 cm or stays inside,
    depending on rounding, on the XLA route as on the kernel (PERF.md).
    So each route is held to XLA's: the same loops outside the band bar
    `max_flips`, and no loop beyond `bound` (the solver's tightening
    margin; a fault such as wrong dynamics or a lost line search sends
    loops out by metres)."""
    import numpy as np

    ref = runs["xla"]
    out_ref = ref["per_loop"] > 1e-2
    for name, r in runs.items():
        out = r["per_loop"] > 1e-2
        flips = int(np.sum(out != out_ref))
        print(f"[smoke] fleet spread {name} vs xla: loops outside the band "
              f"{np.flatnonzero(out).tolist()} vs {np.flatnonzero(out_ref).tolist()}, "
              f"{flips} differ; max violation {r['violation']:.2e} vs {ref['violation']:.2e}")
        _gate(flips <= max_flips, f"{name}: {flips} loops differ from xla's in/out of the band")
        _gate(r["violation"] < bound, f"{name}: spread violation {r['violation']} >= {bound}")


def fleet(model, p, B: int = 128, steps: int = 100, backends=("pallas", "xla"),
          lap_states=None) -> dict:
    """Phase 5: B independent closed loops in one program per backend, from
    the start line and, when `lap_states` is given, from states spread
    along the lap (`spread_x0`).  From the start line every loop must stay
    in the band; from spread starts the kernel is held to the XLA route
    (`_like_xla`).  Progress within 1 % of XLA's in both."""
    import dataclasses

    import jax
    import numpy as np

    from lap_time_optimization.mpc import runner
    from lap_time_optimization.mpc.solver import SolverConfig

    dtype = model.track.s_grid.dtype
    starts = {"start": fleet_x0(B, dtype)}
    if lap_states is not None:
        starts["spread"] = spread_x0(lap_states, B, dtype)
    out = {}
    for where, x0b in starts.items():
        runs = {}
        for backend in backends:
            cfg = dataclasses.replace(SolverConfig(horizon=10), backend=backend)
            t0 = time.perf_counter()
            jax.block_until_ready(runner.closed_loop_batch(model, p, cfg, x0b, steps))
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
            sim = jax.block_until_ready(runner.closed_loop_batch(model, p, cfg, x0b, steps))
            steady = time.perf_counter() - t0
            per_loop = loop_violations(model, p, sim)
            viol = float(per_loop.max())
            progress = float(np.mean(np.asarray(sim.xs[:, -1, 0] - sim.xs[:, 0, 0])))
            runs[backend] = dict(steady_s=steady, first_s=first, violation=viol,
                                 per_loop=per_loop, progress=progress)
            print(f"[smoke] fleet {where} {backend}: B={B} x {steps} steps, s0 "
                  f"{float(x0b[0, 0]):.1f}-{float(x0b[-1, 0]):.1f} m, steady {steady:.4f} s "
                  f"({B * steps / steady:.0f} solves/s), first {first:.2f} s, "
                  f"max applied violation {viol:.2e}, mean progress {progress:.2f} m")
            if where == "start":
                _gate(viol < 1e-2, f"{backend}: fleet applied-state violation {viol} >= 1e-2")
        _same_progress(runs)
        if where == "spread" and "xla" in runs:
            _like_xla(runs, bound=float(p.lateral_margin))
        out[where] = runs
    return out


def racing_line(width: float = 0.99, methods=("laptime", "bayes")) -> dict:
    """Phase 6: the racing-line CLI against the published laps."""
    from lap_time_optimization.cli import race

    bounds = {
        "laptime": TBR18_LAPTIME_PUBLISHED,
        "bayes": TBR18_BAYES_PUBLISHED * 1.01,
    }
    out = {}
    for method in methods:
        res = race.main([
            os.path.join(DATA, "tracks", "buckmore.json"),
            os.path.join(DATA, "vehicles", "tbr18.json"),
            str(width), f"--{method}", "--output-dir", OUT,
        ])
        out[method] = res["lap_time"]
        print(f"[smoke] race --{method}: lap {res['lap_time']:.3f} s "
              f"(bound {bounds[method]:.3f}), run {res['run_time']:.2f} s")
        _gate(res["lap_time"] <= bounds[method],
              f"--{method} lap {res['lap_time']} above its bound {bounds[method]}")
    return out


def _placement(name, arr):
    shards = sorted((str(s.device), str(s.index)) for s in arr.addressable_shards)
    print(f"[smoke] {name} placement: " + "; ".join(f"{d} {i}" for d, i in shards))
    return {d for d, _ in shards}


def four_cards(model, p, per_card: int = 128, steps: int = 100, n: int = 4):
    """The dp-sharded fleet and search over n devices against one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from lap_time_optimization.mpc import runner
    from lap_time_optimization.mpc.solver import SolverConfig
    from lap_time_optimization.parallel import mesh as pmesh
    from lap_time_optimization.track import Track
    from lap_time_optimization.models import load_vehicle

    devs = jax.devices()[:n]
    cfg = SolverConfig(horizon=10)
    x0b = fleet_x0(n * per_card, model.track.s_grid.dtype)
    mesh = Mesh(np.asarray(devs), axis_names=("dp",))
    t0 = time.perf_counter()
    sharded = jax.block_until_ready(runner.closed_loop_fleet(model, p, cfg, x0b, steps, mesh))
    print(f"[smoke] fleet over {n} cards ({n} x {per_card} loops, {steps} steps): "
          f"{time.perf_counter() - t0:.2f} s incl. compile")
    used = _placement("fleet xs", sharded.xs)
    _gate(len(used) == n, f"fleet ran on {len(used)} devices, not {n}")
    with jax.default_device(devs[0]):
        ref = [
            runner.closed_loop_batch(model, p, cfg, x0b[i * per_card:(i + 1) * per_card], steps)
            for i in range(n)
        ]
        ref_xs = np.concatenate([np.asarray(r.xs) for r in ref])
    # same per-device program shape; the two compilations may still order
    # float sums differently, which a closed loop can carry forward
    np.testing.assert_allclose(np.asarray(sharded.xs), ref_xs, rtol=1e-4, atol=1e-4)
    print(f"[smoke] fleet sharded vs one card: max |dx| "
          f"{float(np.max(np.abs(np.asarray(sharded.xs) - ref_xs))):.3e}")

    track = Track.load(os.path.join(DATA, "tracks", "buckmore.json"), track_width=0.99)
    vehicle = load_vehicle(os.path.join(DATA, "vehicles", "tbr18.json"))
    key = jax.random.PRNGKey(0)
    batch = 64 * n
    alphas = jax.random.uniform(key, (batch, track.size), jnp.float32)
    sigma = jnp.asarray(0.05, jnp.float32)
    with jax.default_device(devs[0]):
        nb_1, t_1, _ = pmesh.search_step(track, vehicle, jnp.array(alphas), key, sigma)
        nb_1, t_1 = np.asarray(nb_1), float(t_1)
    smesh = pmesh.make_mesh(n, sp=1)
    with jax.set_mesh(smesh):
        a_sh = pmesh.shard_batch(smesh, jnp.array(alphas))
        used = _placement("search batch", a_sh)
        nb_n, t_n, _ = pmesh.search_step(track, vehicle, a_sh, key, sigma)
        jax.block_until_ready(nb_n)
    _placement("search new batch", nb_n)
    _gate(len(used) == n, f"search batch on {len(used)} devices, not {n}")
    np.testing.assert_allclose(float(t_n), t_1, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(nb_n), nb_1, rtol=1e-5, atol=1e-6)
    print(f"[smoke] search_step over ({n}, 1) vs one card: best lap {float(t_n):.4f} "
          f"vs {t_1:.4f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the dp-sharded fleet and search over four GPUs")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    devs = check_device(count)
    card = card_description()
    print(f"[smoke] card: {card}")
    import jax.numpy as jnp

    model, p = nmpc_stack(jnp.float32)
    t_all = time.perf_counter()
    if args.four_cards:
        four_cards(model, p)
    else:
        from lap_time_optimization.mpc.solver import SolverConfig

        for B in (1, 128):
            compile_kernel(model, p, SolverConfig(horizon=10), B)
        kernel_parity(model, p)
        runs = single_car()
        fleet(model, p, lap_states=runs["xla"]["xs"][:400])
        racing_line()
    print(f"[smoke] all phases passed in {time.perf_counter() - t_all:.1f} s "
          f"(smoke timings on {card}; not benchmark cells)")
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
    }))


if __name__ == "__main__":
    main()
