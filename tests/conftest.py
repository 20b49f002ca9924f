"""Test harness setup: CPU backend, 8 virtual devices for mesh tests, x64.

Multi-chip sharding logic is CI-tested on a virtual 8-device CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), per SURVEY.md §4.
x64 is enabled so golden comparisons against scipy/reference numerics are
tight; GPU runs use f32 (see bench.py).
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# The suite runs on the CPU (virtual 8-device mesh, x64 oracles) through
# jax.config, which holds even when JAX was imported before this file;
# LTO_TEST_PLATFORM=gpu runs the f32 card tier (tests/test_gpu_smoke.py).
_platform = os.environ.get("LTO_TEST_PLATFORM", "cpu")
# "gpu" would also probe ROCm and fail where only CUDA is installed
jax.config.update("jax_platforms", "cuda" if _platform == "gpu" else _platform)
jax.config.update("jax_enable_x64", _platform == "cpu")
# CPU test processes keep no persistent compile cache (the package puts one
# in the checkout by default): xdist workers would race on it for no reuse.
if _platform == "cpu":
    jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Golden-artifact oracle path: the reference checkout's committed plot
# artifacts + recorded IPOPT trace. Tracks/vehicles themselves ship with THIS
# repo (data/) — the reference tree is only needed for oracle comparisons.
REFERENCE_DATA = os.environ.get("LTO_REF_DATA", "/root/reference/data")
REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def _require_ref_data():
    if not os.path.isdir(REFERENCE_DATA):
        pytest.skip("reference data directory not available")


@pytest.fixture(scope="session")
def buckmore():
    from lap_time_optimization.track import Track

    return Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), track_width=0.8)


@pytest.fixture(scope="session")
def buckmore99():
    """Width 0.99 — the configuration the reference README tables were
    actually produced with (verified empirically: curvature/nonlinear laps
    and path lengths match the published numbers only at this width)."""
    from lap_time_optimization.track import Track

    return Track.load(os.path.join(REPO_DATA, "tracks", "buckmore.json"), track_width=0.99)


@pytest.fixture(scope="session")
def tbr18():
    from lap_time_optimization.models import load_vehicle

    return load_vehicle(os.path.join(REPO_DATA, "vehicles", "tbr18.json"))


@pytest.fixture(scope="session")
def mx5():
    from lap_time_optimization.models import load_vehicle

    return load_vehicle(os.path.join(REPO_DATA, "vehicles", "MX5.json"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
