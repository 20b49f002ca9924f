"""`chip_smoke.py` without a card: it must refuse to report when JAX has no
GPU, and its phases must run end to end at tiny sizes on the CPU (the
kernel in interpreter mode, the device check stubbed out)."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from lap_time_optimization.mpc import runner  # noqa: E402
from lap_time_optimization.mpc.solver import SolverConfig  # noqa: E402


@pytest.fixture(scope="module")
def stack():
    return cs.nmpc_stack(jnp.float32)


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory that holds nothing else of the repo,
    the script fails and prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.check_device(1)
    with pytest.raises(SystemExit, match="need 64 devices"):
        cs.check_device(64, platform="cpu")
    assert len(cs.check_device(2, platform="cpu")) >= 2


def test_compile_kernel_phase(stack):
    model, p = stack
    compiled = cs.compile_kernel(model, p, SolverConfig(horizon=10), 2, backend="interpret")
    assert compiled.memory_analysis() is not None


def test_parity_phase(stack):
    model, p = stack
    cs.kernel_parity(model, p, backend="interpret", B=2, ilqr_iters=1)


def test_single_car_phase(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "OUT", str(tmp_path))
    runs = cs.single_car(steps=3, backends=("xla",))
    assert runs["xla"]["violation"] < 1e-2 and runs["xla"]["progress"] > 0.0
    assert runs["xla"]["xs"].shape == (4, 8)
    assert os.path.isfile(tmp_path / "sim_xla.json")


def test_fleet_phase(stack):
    model, p = stack
    lap = np.tile(np.asarray(runner.X0_REFERENCE), (5, 1))
    lap[:, 0] = np.linspace(0.0, 2.0, 5)
    out = cs.fleet(model, p, B=2, steps=2, backends=("interpret", "xla"), lap_states=lap)
    assert set(out) == {"start", "spread"}
    for runs in out.values():
        assert set(runs) == {"interpret", "xla"}
        assert runs["interpret"]["violation"] < 1e-2


def test_loop_violations_match_applied_violation(stack):
    model, p = stack
    sim = runner.closed_loop_batch(model, p, SolverConfig(horizon=10, backend="xla"),
                                   cs.fleet_x0(3, jnp.float32, s_spread=300.0), 2)
    per = cs.loop_violations(model, p, sim)
    assert per.shape == (3,)
    assert float(per.max()) == runner.applied_violation(model, p, sim)


@pytest.mark.parametrize(
    "kernel,passes",
    [
        ([0.0, 0.02, 0.0, 0.0], True),    # the same loop out of the band
        ([0.02, 0.0, 0.0, 0.0], True),    # two flips
        ([0.02, 0.0, 0.02, 0.02], False),  # four flips
        ([0.0, 0.02, 0.0, 0.06], False),  # a loop beyond the margin
    ],
)
def test_spread_gate_holds_kernel_to_xla(kernel, passes):
    xla = np.array([0.0, 0.02, 0.0, 0.0])
    runs = {name: dict(per_loop=np.asarray(v), violation=float(np.max(v)))
            for name, v in (("pallas", kernel), ("xla", xla))}
    if passes:
        cs._like_xla(runs, bound=0.05)
    else:
        with pytest.raises(RuntimeError, match="FAILED"):
            cs._like_xla(runs, bound=0.05)


def test_spread_x0_picks_evenly():
    lap = np.arange(10 * 8, dtype=np.float64).reshape(10, 8)
    x0 = cs.spread_x0(lap, 4, jnp.float32)
    assert x0.shape == (4, 8) and x0.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(x0[:, 0]), lap[[0, 3, 6, 9], 0])


def test_result_line_shape(capsys, monkeypatch):
    """With every phase stubbed, the last stdout line is the JSON result
    object and the nvidia-smi card line comes just before it."""
    check = cs.check_device
    monkeypatch.setattr(cs, "check_device", lambda count: check(count, "cpu"))
    monkeypatch.setattr(cs, "card_description", lambda: "Fake Card, 700.00 W")
    for name in ("compile_kernel", "kernel_parity", "fleet", "racing_line"):
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    monkeypatch.setattr(cs, "single_car", lambda: {"xla": {"xs": np.zeros((1, 8))}})
    cs.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "Fake Card, 700.00 W"
    out = json.loads(lines[-1])
    assert out == {"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": out["device"]["count"]}}
