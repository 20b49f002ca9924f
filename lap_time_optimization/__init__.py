"""lap_time_optimization — lap-time & trajectory optimization in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
`bruno-maruszczak/lap-time-optimization` project (see SURVEY.md):

* racing-line optimization (curvature-min, compromise, estimated-compromise,
  sector-wise, direct lap-time, Bayesian-opt, nonlinear multi-start) over a
  differentiable spline/velocity-profile pipeline,
* a closed-loop NMPC stack (curvilinear bicycle + Pacejka tires) solved with a
  jitted augmented-Lagrangian iLQR instead of CasADi/IPOPT,
* batched/sharded candidate search across a `jax.sharding.Mesh`.

Everything in the compute path is functional JAX: traced once, compiled by XLA,
differentiable end-to-end, and vmappable over candidate batches.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

#: fixed compile-cache path inside the checkout (the path is part of the
#: cache key, so it must not depend on a temp dir, a pid or the time)
CACHE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache(environ=_os.environ):
    """Persistent XLA compilation cache.  Where JAX_COMPILATION_CACHE_DIR is
    set, JAX reads it itself and nothing is set here; otherwise the cache
    goes to `CACHE_DIR`.  Returns the directory this call set, or None."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


configure_compile_cache()

from lap_time_optimization.ops import spline  # noqa: F401
from lap_time_optimization.track import Track  # noqa: F401

__all__ = ["spline", "Track", "__version__"]
