"""CLI smoke tests: the reference-parity surfaces end-to-end (SURVEY.md §4)."""

import json
import os

import numpy as np
import pytest


@pytest.fixture(scope="module")
def tiny_track_json(tmp_path_factory):
    """Small synthetic closed track so CLI runs stay fast."""
    th = np.linspace(0, 2 * np.pi, 25)
    r_mid = 30.0 + 6.0 * np.sin(3 * th)
    data = {
        "name": "tinyring",
        "left": {
            "x": ((r_mid - 2.5) * np.cos(th)).tolist(),
            "y": ((r_mid - 2.5) * np.sin(th)).tolist(),
        },
        "right": {
            "x": ((r_mid + 2.5) * np.cos(th)).tolist(),
            "y": ((r_mid + 2.5) * np.sin(th)).tolist(),
        },
    }
    for side in ("left", "right"):
        data[side]["x"][-1] = data[side]["x"][0]
        data[side]["y"][-1] = data[side]["y"][0]
    p = tmp_path_factory.mktemp("tracks") / "tinyring.json"
    p.write_text(json.dumps(data))
    return str(p)


REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


@pytest.fixture(scope="module")
def tbr18_path():
    return os.path.join(REPO_DATA, "vehicles", "tbr18.json")


class TestRaceCLI:
    def _run(self, tiny_track_json, tbr18_path, tmp_path, *flags):
        from lap_time_optimization.cli import race

        return race.main(
            [tiny_track_json, tbr18_path, "0.8", *flags, "--output-dir", str(tmp_path)]
        )

    def test_curvature_end_to_end(self, tiny_track_json, tbr18_path, tmp_path):
        out = self._run(tiny_track_json, tbr18_path, tmp_path, "--curvature", "--plot-all")
        assert out["lap_time"] > 0 and out["length"] > 0
        d = out["artifact_dir"]
        for name in ("path", "left", "right", "widths", "velocities"):
            assert os.path.isfile(os.path.join(d, f"{name}.json")), name
        for png in ("path", "corners", "trajectory"):
            assert os.path.isfile(os.path.join(d, f"{png}.png")), png
        # artifact schema round-trips through the NMPC-stage loader
        from lap_time_optimization.utils import io

        x, y = io.load_artifact(os.path.join(d, "path.json"))
        assert len(x) == len(y) > 50
        v = io.load_artifact(os.path.join(d, "velocities.json"))
        assert np.all(v > 0)

    def test_estimated(self, tiny_track_json, tbr18_path, tmp_path):
        out = self._run(tiny_track_json, tbr18_path, tmp_path, "--estimated")
        assert out["lap_time"] > 0

    @pytest.mark.slow
    def test_nonlinear(self, tiny_track_json, tbr18_path, tmp_path):
        out = self._run(tiny_track_json, tbr18_path, tmp_path, "--nonlinear")
        assert out["lap_time"] > 0

    def test_config_override_changes_run(self, tiny_track_json, tbr18_path, tmp_path):
        """--config must actually steer the run (VERDICT r1 missing #6): a
        narrowed epsilon range forces a different compromise optimum, and the
        effective config is dumped into the artifact dir."""
        import json as json_mod

        cfg_path = tmp_path / "override.json"
        cfg_path.write_text(json_mod.dumps(
            {"compromise": {"eps_min": 0.19, "eps_max": 0.2, "n_grid": 4, "n_refine": 0}}
        ))
        base = self._run(tiny_track_json, tbr18_path, tmp_path / "a", "--compromise")
        over = self._run(tiny_track_json, tbr18_path, tmp_path / "b", "--compromise",
                         "--config", str(cfg_path))
        # pinned-high epsilon weights length over curvature -> different path
        assert abs(over["length"] - base["length"]) > 1e-6
        dumped = json_mod.load(open(os.path.join(over["artifact_dir"], "config.json")))
        assert dumped["compromise"]["eps_min"] == 0.19

    def test_rejects_unknown_track(self, tbr18_path):
        from lap_time_optimization.cli import race

        with pytest.raises(FileNotFoundError):
            race.main(["nosuch.json", tbr18_path, "0.8", "--curvature"])

    def test_requires_method(self, tiny_track_json, tbr18_path):
        from lap_time_optimization.cli import race

        with pytest.raises(SystemExit):
            race.main([tiny_track_json, tbr18_path, "0.8"])


@pytest.fixture(scope="module")
def ref_artifacts():
    """Repo-shipped curvature artifact set for MX-5/buckmore (generated by
    our own racing-line CLI; the NMPC stage's standard input)."""
    d = os.path.join(REPO_DATA, "plots", "MX-5", "buckmore", "curvature")
    if not os.path.isdir(d):
        pytest.skip("shipped curvature artifacts not available")
    return d


class TestMPCCLI:
    def test_short_sim(self, tmp_path, ref_artifacts):
        from lap_time_optimization.cli import mpc as mpc_cli

        out_json = str(tmp_path / "sim.json")
        res = mpc_cli.main(["--curvature", "--steps", "5", "--output", out_json])
        data = json.load(open(out_json))
        assert set(data.keys()) == {"x", "y", "u", "Fy", "alpha"}
        assert np.asarray(data["x"]).shape == (6, 8, 1)
        s = np.asarray(res.result.xs)[:, 0]
        assert s[-1] > s[0]


    def test_vref_preview_flag_reaches_config(self, ref_artifacts):
        """--vref-preview flows through the config-merge layer (the closed
        loop itself is covered by tests/test_mpc.py::TestBrakePreview and the
        slow full-lap gates)."""
        from lap_time_optimization.cli import mpc as mpc_cli

        args = mpc_cli.build_parser().parse_args(
            ["--curvature", "--vref-preview", "1.0"]
        )
        conf = mpc_cli.effective_config(args)
        assert conf.mpc.vref_preview_decel == 1.0
        # default stays off (exact reference target)
        args = mpc_cli.build_parser().parse_args(["--curvature"])
        assert mpc_cli.effective_config(args).mpc.vref_preview_decel == 0.0


class TestShowResultsCLI:
    def test_plots_internals(self, tmp_path, ref_artifacts):
        from lap_time_optimization.cli import mpc as mpc_cli
        from lap_time_optimization.cli import show_results

        sim_json = str(tmp_path / "sim.json")
        mpc_cli.main(["--curvature", "--steps", "3", "--output", sim_json])
        out_png = str(tmp_path / "internals.png")
        show_results.main([sim_json, "--method", "curvature", "--out", out_png])
        assert os.path.isfile(out_png) and os.path.getsize(out_png) > 10_000
