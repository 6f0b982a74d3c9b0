"""Serving-app profiles: what a token-serving workload is made of.

A *serving* app's state is not one opaque checkpoint blob: it is frozen
weights plus a **live KV cache** that grows with every decoded token.
The split matters exactly at migration time — weights can ship cold, but
the KV cache is either abandoned (and re-prefilled at the destination),
or serialized onto the wire as declared state.  The three resulting
migration strategies are first-class names here, priced by
`ServingElasticBackend.strategy_phases` and recorded end-to-end
(`SnapshotInfo.strategy` → `MigrationRecord.strategy` →
`MoveProvenance.strategy`):

``drain``
    Stop admitting tokens, finish the in-flight decode backlog at the
    source, then move the weights cold.  Cheap on the wire (weights
    only), expensive in pause time when the backlog is deep.
``replay``
    Move the weights, drop the KV cache, and re-prefill every live
    session at the destination — recompute priced at ``prefill_tps``,
    counted per app as ``tokens_recomputed``.
``kv-ship``
    Serialize the KV cache alongside the weights as declared state
    through the elastic bridge: pays ``kv_bytes_per_token`` per cached
    token in transfer bytes, near-zero recompute.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

STRATEGY_DRAIN = "drain"
STRATEGY_REPLAY = "replay"
STRATEGY_KV_SHIP = "kv-ship"

#: Deterministic pricing/tie-break order of the three strategies.
STRATEGIES: Tuple[str, ...] = (STRATEGY_DRAIN, STRATEGY_REPLAY,
                               STRATEGY_KV_SHIP)


@dataclasses.dataclass(frozen=True)
class ServingProfile:
    """Static shape of one serving app's state and token service.

    ``decode_tps`` is the per-session decode cadence (tokens submitted
    per second by one session, scaled by the app's live `RateBank`
    rate); ``service_tps`` is the app's *server* throughput draining the
    merged token queue.  ``prefill_tps`` prices replay recompute only —
    prompt tokens go through the same FIFO server as decodes."""

    weights_mb: float = 64.0            # frozen weights on the wire
    kv_bytes_per_token: float = 32768.0  # per-token KV-cache footprint
    decode_tps: float = 8.0             # per-session decode cadence
    prefill_tps: float = 400.0          # destination re-prefill rate (replay)
    service_tps: float = 120.0          # server token throughput
    slo_p99_s: float = 0.25             # per-token p99 latency objective


@dataclasses.dataclass
class ServingConfig:
    """Opt-in serving wiring carried on ``RuntimeConfig.serving``.

    Only apps listed in ``profiles`` are serving — everything else keeps
    the legacy opaque-blob semantics, which is what keeps non-serving
    scenario fingerprints bit-identical.  ``forced_strategy`` pins every
    serving migration to one strategy (benchmark sweeps and the
    conservation tests force each in turn); None lets the backend pick
    the cheapest per move.  ``slo_weight`` blends the token-SLO ratio
    into the final eq.-(1) summary (`core.satisfaction.blend_token_slo`).
    """

    profiles: Dict[int, ServingProfile] = dataclasses.field(
        default_factory=dict)
    forced_strategy: Optional[str] = None
    slo_weight: float = 0.5

    def __post_init__(self) -> None:
        if (self.forced_strategy is not None
                and self.forced_strategy not in STRATEGIES):
            raise ValueError(
                f"unknown serving strategy {self.forced_strategy!r}; "
                f"expected one of {STRATEGIES}")
