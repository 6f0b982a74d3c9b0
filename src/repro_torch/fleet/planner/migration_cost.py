"""Migration-aware move pricing from the executor's reservation ledger.

The ROADMAP gap: policies used to *skip* in-flight apps but price every
candidate move with one flat penalty, as if state copies were free and
instant.  This model closes it: each candidate move's penalty grows with
the **estimated transfer time** of the copy it would trigger — state size
over the slowest link of the move's old∪new path, slowed by the fair-share
contention the executor ledger currently bills on those links (an extra
active transfer on a link halves the share the new copy would get).

The penalty stays in eq. (1) satisfaction units so it composes with the
paper's objective:

    penalty(move) = base · (1 + time_coef · est_transfer_s(move))

With the defaults a ~50 s uncontended edge-uplink copy costs ~1.5× the
flat penalty and a copy across a congested backbone scales up with the
number of transfers already on it — the planner starts preferring cheap,
idle paths and *deferring* churn toward congested ones, instead of
pretending the ledger doesn't exist.

Since the calibration PR the *size* side of the estimate is no longer a
single flat ``state_mb`` guess for every app:

* when a ``request`` is threaded through (`penalty(..., request=...)`)
  and the bound executor carries an `ElasticBackend`, apps that declare
  state (``AppProfile.state_mb`` / an attached job) are priced at the
  backend's own byte count (`ElasticBackend.transfer_mbits`) — the same
  size model the executor snapshots with, so planner pricing and
  executor phases can no longer disagree by construction;
* with the opt-in feedback loop enabled (`enable_feedback`, driven by
  ``RuntimeConfig.cost_feedback``), measured per-app byte counts from
  the `CalibrationLedger` take precedence over even the backend's
  declared sizes — the model converges on what the wire actually
  carried.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.apps import Candidate


class MigrationCostModel:
    """Price a candidate move's transfer time into its move penalty.

    ``bind`` is called by `ReconfigPolicy.observe` with the runtime's
    `MigrationExecutor` before each plan, so contention reflects the
    ledger state *at the tick* — deterministic under the simulated clock.
    """

    def __init__(self, state_mb: float = 64.0, time_coef: float = 0.01,
                 executor=None):
        self.state_mb = state_mb
        self.time_coef = time_coef   # penalty growth per transfer-second
        self._shares: Dict[str, int] = {}
        self.backend = None          # ElasticBackend captured from bind()
        self.ledger = None           # CalibrationLedger (feedback mode)
        self.feedback = False
        self.bind(executor)

    def bind(self, executor) -> None:
        """Snapshot the ledger's per-link transfer counts.  The ledger is
        fixed for the duration of a plan (observe() rebinds every tick),
        and penalty() runs once per app-candidate pair — scanning the
        live ledger there would put an O(transfers) walk in the planning
        hot path.  Also captures the executor's elastic backend so sizes
        can come from the one size model the executor snapshots with."""
        self.executor = executor
        self._shares = executor.link_shares() if executor is not None else {}
        if executor is not None:
            self.backend = getattr(executor, "backend", self.backend)

    def enable_feedback(self, backend, ledger) -> None:
        """Opt in to measurement-driven sizing (``RuntimeConfig.
        cost_feedback``): the calibration ledger's learned per-app byte
        counts override the flat/declared belief once an app has
        completed a migration."""
        self.backend = backend
        self.ledger = ledger
        self.feedback = True

    def link_shares(self) -> Dict[str, int]:
        return dict(self._shares)

    def _mbits(self, request=None) -> float:
        """Wire size belief for one app: measured (feedback on, app has
        history) → backend-declared (app declares state) → flat."""
        if request is not None:
            if self.feedback and self.ledger is not None:
                learned = self.ledger.learned_mbits(request.req_id)
                if learned is not None:
                    return learned
            if self.backend is not None and (
                    request.app.state_mb is not None
                    or request.req_id in getattr(self.backend, "_job_bytes", ())):
                return self.backend.transfer_mbits(request, None)
        return self.state_mb * 8.0

    def est_transfer_s(self, old: Candidate, new: Candidate,
                       request=None) -> float:
        """Full state copy over the slowest fair-share link of the move's
        old∪new path (the links `MigrationExecutor` would occupy)."""
        links = {l.link_id: l.bandwidth_mbps for l in old.links}
        links.update({l.link_id: l.bandwidth_mbps for l in new.links})
        rate = min(
            (bw / (self._shares.get(lid, 0) + 1) for lid, bw in links.items()),
            default=100.0,
        )
        return self._mbits(request) / max(rate, 1e-9)

    def est_host_s(self, request=None) -> float:
        """Snapshot + restore host phases the backend would charge —
        measured values when the feedback loop has them, else the
        backend's pure prediction (`ElasticBackend.predict_phases`)."""
        if request is None:
            return 0.0
        if self.feedback and self.ledger is not None:
            learned = self.ledger.learned_host(request.req_id)
            if learned is not None:
                return learned[0] + learned[1]
        if self.backend is not None:
            _, snap_s, restore_s = self.backend.predict_phases(request, None)
            return snap_s + restore_s
        return 0.0

    def serving_pipeline_s(self, old: Candidate, new: Candidate,
                           request=None):
        """Serving apps: cheapest per-strategy pipeline time over the
        move's contended links — ``(seconds, strategy)``, or None for
        non-serving apps / backends without strategy phases.  Priced
        through `ServingElasticBackend.strategy_phases`, the same
        triples the executor will snapshot with, so planner pricing and
        executor phases agree per strategy by construction."""
        be = self.backend
        if request is None or be is None:
            return None
        phases_of = getattr(be, "strategy_phases", None)
        if phases_of is None:
            return None
        phases = phases_of(request, None)
        if phases is None:
            return None
        links = {l.link_id: l.bandwidth_mbps for l in old.links}
        links.update({l.link_id: l.bandwidth_mbps for l in new.links})
        rate = min(
            (bw / (self._shares.get(lid, 0) + 1) for lid, bw in links.items()),
            default=100.0,
        )
        rate = max(rate, 1e-9)
        forced = getattr(be, "forced_strategy", None)
        best = None
        for st in ([forced] if forced is not None else phases):
            mbits, snap_s, rest_s = phases[st]
            cost = snap_s + mbits / rate + rest_s
            if best is None or cost < best[0] - 1e-12:
                best = (cost, st)
        return best

    def penalty(self, old: Candidate, new: Candidate, base: float,
                request=None) -> float:
        if new.node.node_id == old.node.node_id:
            return 0.0
        serving = self.serving_pipeline_s(old, new, request)
        if serving is not None:
            pipeline_s = serving[0]
        else:
            pipeline_s = self.est_transfer_s(old, new, request) \
                + self.est_host_s(request)
        return base * (1.0 + self.time_coef * pipeline_s)
