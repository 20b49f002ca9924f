"""Platform handling without a card: the one place the iLQR backend is
chosen, where the compile cache goes, and the multi-device dryrun's refusal
to switch platforms."""

import dataclasses
import os

import jax
import pytest

import lap_time_optimization as lto
from lap_time_optimization.mpc import solver as S


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform
        self.device_kind = f"fake {platform}"


class TestResolvedBackend:
    @pytest.mark.parametrize(
        "platform,backend,expected",
        [
            ("cpu", "auto", "xla"),
            ("gpu", "auto", "pallas"),
            ("gpu", "pallas", "pallas"),
            ("gpu", "xla", "xla"),
            ("cpu", "xla", "xla"),
            ("cpu", "interpret", "interpret"),
            ("gpu", "interpret", "interpret"),
        ],
    )
    def test_resolution(self, monkeypatch, platform, backend, expected):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert S._resolved_backend(S.SolverConfig(backend=backend)) == expected

    @pytest.mark.parametrize(
        "platform,backend",
        [("cpu", "pallas"), ("metal", "auto"), ("cpu", "triton")],
    )
    def test_no_silent_fallback(self, monkeypatch, platform, backend):
        """The kernel off a GPU, an unknown platform under "auto" and an
        unknown backend all raise instead of quietly taking another route."""
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        with pytest.raises(ValueError):
            S._resolved_backend(S.SolverConfig(backend=backend))

    @pytest.mark.parametrize("platform", ["cpu", "gpu"])
    def test_non_gauss_newton(self, monkeypatch, platform):
        """The kernel is Gauss-Newton-only: "auto" takes XLA for another
        Hessian mode, and a kernel backend named with one raises."""
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert S._resolved_backend(S.SolverConfig(hessian_mode="exact")) == "xla"
        with pytest.raises(ValueError, match="gauss_newton"):
            S._resolved_backend(S.SolverConfig(hessian_mode="exact", backend="interpret"))

    def test_default_is_auto(self):
        assert S.SolverConfig().backend == "auto"
        assert "window" not in {f.name for f in dataclasses.fields(S.SolverConfig)}


class TestCompileCache:
    def test_unset_uses_fixed_checkout_path(self):
        before = jax.config.jax_compilation_cache_dir
        try:
            got = lto.configure_compile_cache({})
            assert got == lto.CACHE_DIR
            assert jax.config.jax_compilation_cache_dir == lto.CACHE_DIR
            assert os.path.basename(lto.CACHE_DIR) == ".jax_cache"
            root = os.path.dirname(lto.CACHE_DIR)
            assert os.path.isfile(os.path.join(root, "pyproject.toml"))
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_set_variable_wins(self):
        before = jax.config.jax_compilation_cache_dir
        jax.config.update("jax_compilation_cache_dir", "/somewhere/else")
        try:
            assert lto.configure_compile_cache({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None
            assert jax.config.jax_compilation_cache_dir == "/somewhere/else"
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


class TestDryrunDevices:
    def test_cpu_uses_forced_host_devices(self):
        import __graft_entry__ as ge

        devs = ge.mesh_devices(4)
        assert len(devs) == 4 and {d.platform for d in devs} == {"cpu"}

    def test_gpu_with_too_few_devices_fails(self, monkeypatch):
        import __graft_entry__ as ge

        platforms = jax.config.jax_platforms
        monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice("gpu")])
        with pytest.raises(RuntimeError, match="needs 4 devices"):
            ge.mesh_devices(4)
        assert jax.config.jax_platforms == platforms  # never switched
