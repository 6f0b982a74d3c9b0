"""Serving as a first-class fleet workload (`repro_torch.fleet.serving`).

Token-level request streams over the fleet event loop: sessions arrive
as `events.SessionArrival`, each serving app drains a deterministic
FIFO token queue (`ServingWorkload`), and migrations pick — and the
cost model prices — one of three KV-cache-aware strategies
(``drain`` / ``replay`` / ``kv-ship``, `ServingElasticBackend`).
Opt-in via ``RuntimeConfig.serving = ServingConfig(...)``; fleets
without it are untouched (bit-identical fingerprints).
"""

from .backend import ServingElasticBackend
from .profile import (
    STRATEGIES,
    STRATEGY_DRAIN,
    STRATEGY_KV_SHIP,
    STRATEGY_REPLAY,
    ServingConfig,
    ServingProfile,
)
from .workload import ServingWorkload

__all__ = [
    "STRATEGIES",
    "STRATEGY_DRAIN",
    "STRATEGY_KV_SHIP",
    "STRATEGY_REPLAY",
    "ServingConfig",
    "ServingElasticBackend",
    "ServingProfile",
    "ServingWorkload",
]
