"""Central configuration: every constant the reference hardcodes, in one place.

The reference scatters hyperparameters across modules (SURVEY.md §5): corner
detection K_MIN/PROXIMITY/LENGTH (src/__main__.py:109-112), epsilon bounds
(src/trajectory.py:99), BO convergence (tbn.py:195), MPC weights/horizon
(src/mpc/controller.py:9,29), n_samples=846 (src/mpc.py:88), x0
(src/mpc.py:107-110).  Here they are dataclasses with the reference values as
defaults, overridable per run and serializable for reproducibility.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class CornerConfig:
    """Corner detection (reference src/__main__.py:109-112)."""

    k_min: float = 0.03
    proximity: float = 40.0
    length: float = 10.0


@dataclasses.dataclass
class CompromiseConfig:
    """Epsilon search (reference src/trajectory.py:99)."""

    eps_min: float = 0.0
    eps_max: float = 0.2
    n_grid: int = 16
    n_refine: int = 1


@dataclasses.dataclass
class BayesConfig:
    """Bayesian search (reference tbn.py:120-205).

    Budgets are batch-scaled for quality parity with the published results
    (see optim/global_search.bayesian): the reference's 10 serial inits
    become one vmapped batch of 128, and its per-round COBYLA(10000)
    incumbent refinement becomes a 200-iteration exact-gradient polish."""

    n_init: int = 128  # tbn.py:136 does 10, serially
    n_local: int = 64
    n_uniform: int = 64
    max_rounds: int = 60
    sigma_window: int = 10  # tbn.py:195
    sigma_tol: float = 1e-3  # tbn.py:195
    min_samples: int = 25  # tbn.py:195 uses 20
    alpha_hi: float = 0.99  # tbn.py:142
    polish_every: int = 1  # tbn.py:117 refines the incumbent every round
    polish_iters: int = 200


@dataclasses.dataclass
class NonlinearConfig:
    """Multi-start search (reference tbn.py:230-269: 100 random, 10 refined)."""

    n_random: int = 1024
    n_refine: int = 10
    max_iter: int = 100


@dataclasses.dataclass
class MPCConfig:
    """NMPC loop (reference src/mpc/controller.py:9,29; src/mpc.py:107-126)."""

    horizon: int = 10
    dt: float = 0.1
    steps: int = 500
    q_n: float = 0.5
    q_mu: float = 3.0
    q_B: float = 1e-2
    r_controls: tuple = (1e-2, 1e-2)
    vref_scale: float = 0.6
    x0: tuple = (0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.1)
    # Divergence from the reference (which has no tightening): the solver
    # optimizes a band shrunk by this margin [m] so the fixed-iteration
    # real-time presets keep applied states strictly inside the true track.
    lateral_margin: float = 0.05
    # Braking-curve preview budget [m/s²] applied to the vref table at build
    # time (mpc/track.with_brake_preview); 0 = off = exact reference target.
    # Recommended ≈ the plant's real decel authority (C_m·T/m ≈ 1.0 for MX5)
    # when running short horizons (h ≤ 10) in f32.
    vref_preview_decel: float = 0.0


@dataclasses.dataclass
class Config:
    corners: CornerConfig = dataclasses.field(default_factory=CornerConfig)
    compromise: CompromiseConfig = dataclasses.field(default_factory=CompromiseConfig)
    bayes: BayesConfig = dataclasses.field(default_factory=BayesConfig)
    nonlinear: NonlinearConfig = dataclasses.field(default_factory=NonlinearConfig)
    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        mpc = dict(d.get("mpc", {}))
        for key in ("r_controls", "x0"):  # JSON arrays -> tuples (dataclass defaults)
            if key in mpc:
                mpc[key] = tuple(mpc[key])
        return cls(
            corners=CornerConfig(**d.get("corners", {})),
            compromise=CompromiseConfig(**d.get("compromise", {})),
            bayes=BayesConfig(**d.get("bayes", {})),
            nonlinear=NonlinearConfig(**d.get("nonlinear", {})),
            mpc=MPCConfig(**mpc),
        )

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))
