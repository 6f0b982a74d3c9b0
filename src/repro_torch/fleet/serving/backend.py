"""KV-cache-aware elastic backend: per-strategy migration phases.

`SimulatedElasticBackend` prices every app as one opaque checkpoint.  A
serving app's state is weights + a live KV cache, and the *strategy*
decides what the wire carries and what the host pays:

    drain     weights only; snapshot waits out the decode backlog
    replay    weights only; restore re-prefills the cached context
    kv-ship   weights + cached_tokens · kv_bytes_per_token on the wire

`strategy_phases` exposes all three as ``(mbits, snapshot_s,
restore_s)`` triples — the `MigrationCostModel` prices the cheapest into
the move penalty — and `choose_strategy` picks deterministically
(forced via `ServingConfig.forced_strategy`, else argmin of the
uncontended pipeline estimate, ties to the `STRATEGIES` order).  The
chosen strategy is stamped on the `SnapshotInfo` at transfer start and
threads from there onto the `MigrationRecord`, the migrate trace span,
and the move's provenance.

Non-serving apps fall straight through to the parent, so a fleet with
no serving profiles behaves — and fingerprints — exactly as before.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.core.apps import PlacementRequest
from repro_torch.core.migration import Move

from ..elastic_bridge import SimulatedElasticBackend, SnapshotInfo
from .profile import (
    STRATEGIES,
    STRATEGY_DRAIN,
    STRATEGY_KV_SHIP,
    STRATEGY_REPLAY,
)
from .workload import ServingWorkload


def _bottleneck_mbps(move: Optional[Move]) -> float:
    """Uncontended bottleneck bandwidth over the move's old∪new path."""
    if move is None:
        return 100.0
    links = {l.link_id: l.bandwidth_mbps for l in move.old.links}
    links.update({l.link_id: l.bandwidth_mbps for l in move.new.links})
    return max(min(links.values(), default=100.0), 1e-9)


class ServingElasticBackend(SimulatedElasticBackend):
    """Simulated backend that knows serving apps split into weights + KV."""

    name = "serving"

    def __init__(self, workload: Optional[ServingWorkload] = None,
                 default_state_mb: float = 64.0, host_gbps: float = 16.0,
                 per_shard_s: float = 0.01,
                 forced_strategy: Optional[str] = None):
        super().__init__(default_state_mb=default_state_mb,
                         host_gbps=host_gbps, per_shard_s=per_shard_s)
        self.workload = workload
        self.forced_strategy = forced_strategy

    def bind_workload(self, workload: ServingWorkload) -> None:
        self.workload = workload

    # ------------------------------------------------------------ strategies
    def strategy_phases(
        self, request: PlacementRequest, move: Optional[Move] = None,
    ) -> Optional[Dict[str, Tuple[float, float, float]]]:
        """``{strategy: (mbits, snapshot_s, restore_s)}`` for a serving
        app, from its *current* queue state (cached context and decode
        backlog); None for non-serving apps."""
        wl = self.workload
        prof = wl.profile(request.req_id) if wl is not None else None
        if prof is None:
            return None
        from repro_torch.ckpt import shard_count          # deferred: pulls in torch
        w_nb = int(prof.weights_mb * 1e6)
        w_mbits = w_nb * 8.0 / 1e6
        w_host = self._host_s(w_nb, shard_count(w_nb))
        cached = wl.cached_tokens(request.req_id)
        kv_nb = w_nb + int(cached * prof.kv_bytes_per_token)
        kv_host = self._host_s(kv_nb, shard_count(kv_nb))
        return {
            STRATEGY_DRAIN: (
                w_mbits,
                w_host + wl.drain_estimate_s(request.req_id),
                w_host),
            STRATEGY_REPLAY: (
                w_mbits,
                w_host,
                w_host + cached / prof.prefill_tps),
            STRATEGY_KV_SHIP: (
                kv_nb * 8.0 / 1e6,
                kv_host,
                kv_host),
        }

    def choose_strategy(self, request: PlacementRequest,
                        move: Optional[Move] = None) -> Optional[str]:
        """Deterministic strategy choice for one hypothetical (or about
        to start) migration: forced, else argmin of the uncontended
        pipeline time ``snapshot + mbits/bw + restore``."""
        phases = self.strategy_phases(request, move)
        if phases is None:
            return None
        if self.forced_strategy is not None:
            return self.forced_strategy
        bw = _bottleneck_mbps(move)
        best, best_cost = STRATEGIES[0], math.inf
        for st in STRATEGIES:
            mbits, snap_s, rest_s = phases[st]
            cost = snap_s + mbits / bw + rest_s
            if cost < best_cost - 1e-12:
                best, best_cost = st, cost
        return best

    # -------------------------------------------------------------- backend
    def transfer_mbits(self, request: PlacementRequest, move: Move) -> float:
        phases = self.strategy_phases(request, move)
        if phases is None:
            return super().transfer_mbits(request, move)
        return phases[self.choose_strategy(request, move)][0]

    def predict_phases(self, request: PlacementRequest,
                       move: Optional[Move] = None) -> Tuple[float, float, float]:
        phases = self.strategy_phases(request, move)
        if phases is None:
            return super().predict_phases(request, move)
        return phases[self.choose_strategy(request, move)]

    def snapshot(self, request: PlacementRequest, move: Move,
                 now: float) -> SnapshotInfo:
        if self.workload is not None:
            # Size the snapshot against the queue as of *now* — the last
            # event to touch this app's queue may be long past.
            self.workload.advance_app(request.req_id, now)
        phases = self.strategy_phases(request, move)
        if phases is None:
            return super().snapshot(request, move, now)
        st = self.choose_strategy(request, move)
        mbits, snap_s, rest_s = phases[st]
        self.workload.note_snapshot(
            request.req_id, self.workload.cached_tokens(request.req_id))
        nb = int(mbits * 1e6 / 8.0)
        from repro_torch.ckpt import shard_count          # deferred: pulls in torch
        plan = self.mesh_plans.get(request.req_id)
        snap = SnapshotInfo(
            req_id=request.req_id, nbytes=nb, mbits=mbits,
            n_shards=shard_count(nb), snapshot_s=snap_s, restore_s=rest_s,
            mesh_shape=plan.shape if plan is not None else None,
            strategy=st)
        self.snapshots[request.req_id] = snap
        return snap
