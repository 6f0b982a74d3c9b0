"""Discrete-event continuous-operation runtime with load-bearing time.

Drives the paper's reconfigurator *over time*: a stream of arrival /
departure / rate-sample / failure events mutates the fleet, and every
``reconfig_every`` admissions (plus after failures and recoveries) the
configured `ReconfigPolicy` trial-solves the recent-apps window — skipping
apps that are mid-migration — weighting each app by its current request
rate.  Accepted plans do NOT complete inside the tick: the
`MigrationExecutor` ledger starts transfers that occupy fractional link
bandwidth over ``[t, t+dur)``, emits `MigrationStart` / `MigrationComplete`
events back into the queue, and holds source-side occupancy until the copy
finishes (the double-booking window).  Every transfer runs the elastic
checkpoint → reshard → resume pipeline through the `fleet.elastic_bridge`
backend seam (`RuntimeConfig.elastic_backend`), so transfer bytes and
snapshot/restore phase times come from checkpoint state, not a flat
constant.  Arrivals, departures, rate swings
and node failures therefore *interleave* with in-flight moves — a flash
crowd can land mid-reconfiguration, and a destination failure aborts and
rolls back the transfers headed there.

The runtime is fully deterministic given its event queue: all randomness
lives in the scenario generators (`fleet.scenarios`), and per-tick
telemetry fingerprints are reproducible (see `fleet.telemetry`) — except
under the `adaptive` policy, whose switching keys off wall-clock solver
latency by design.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core.apps import PlacementRequest
from repro_torch.core.placement import PlacementEngine
from repro_torch.core.topology import TIER_INPUT, Topology

from .events import (
    AppArrival,
    AppDeparture,
    DemandDrift,
    Event,
    EventQueue,
    LinkFailure,
    LinkRecovery,
    MigrationComplete,
    MigrationStart,
    NodeFailure,
    NodeRecovery,
    RateBank,
    RateCurve,
    ReconfigTick,
    RequestRateUpdate,
    SessionArrival,
)
from .executor import MigrationExecutor
from .obs.calibration import CalibrationLedger, MovePrediction
from .obs.metrics import (
    DEFAULT_FRACTION_BUCKETS,
    DEFAULT_LATENCY_BUCKETS_S,
    DEFAULT_RATIO_BUCKETS,
    MetricsRegistry,
)
from .obs.slo import SloConfig, SloMonitor
from .obs.trace import NULL_TRACER
from .policies import ReconfigPolicy
from .telemetry import Telemetry, TickRecord


@dataclasses.dataclass
class RuntimeConfig:
    reconfig_every: int = 100      # admissions between scheduled reconfigs
    window: int = 100              # most-recent-N re-placement window
    state_mb: float = 64.0         # migrated state per app
    reconfig_on_failure: bool = True
    check_invariants: bool = True  # occupancy audit after every tick
    rate_epsilon: float = 0.05     # min relative rate change worth re-admitting
    # Planning-window selection: "recent" = the most-recent-N stable apps
    # (the paper's periodic re-placement window); "churn" = only apps whose
    # rate or placement regressed since the last plan (admissions, rate
    # re-admissions, drift, failover) — quiet apps stay out of the window,
    # so the journal/region-reuse machinery bites on busy ticks too.
    window_policy: str = "recent"
    # Bandwidth each active migration debits against admission control on
    # every link it crosses (0 = legacy unreserved transfers).  Since the
    # fair-share ledger refactor this is an on/off knob: each transfer
    # reserves its *live fair-share rate*, re-computed on every contention
    # change, not this flat constant.
    migration_reserve_mbps: float = 2.0
    # Elastic bridge backend executing every migration's checkpoint →
    # reshard → resume pipeline (`fleet.elastic_bridge`).  None → a
    # `SimulatedElasticBackend` whose no-declared-state fallback is the
    # legacy flat `state_mb` model.
    elastic_backend: Optional[object] = None
    # SLO objectives/budgets for the burn-rate monitor (`fleet.obs.slo`).
    # None → the default `SloConfig` (calibrated to stay quiet on healthy
    # runs and burn on sustained degradation).
    slo: Optional[SloConfig] = None
    # Opt-in calibration feedback (`fleet.obs.calibration`): when True and
    # the policy carries a `MigrationCostModel`, the model prices moves
    # with backend-declared byte counts and ledger-measured per-app
    # corrections instead of the flat `state_mb` belief.  Off (default)
    # the cost model's behavior — and every scenario fingerprint — is
    # bit-identical to the pre-calibration code.
    cost_feedback: bool = False
    # Admission path: "vector" = the array-ledger template fast path,
    # "scalar" = the retained per-candidate reference loop.  Both decide
    # identically (property-tested; the benchmark smoke gate asserts
    # bit-identical scenario fingerprints), so this is a perf knob and a
    # parity harness, never a behavior switch.
    admission_mode: str = "vector"
    # Opt-in serving workload (`fleet.serving.ServingConfig`): apps with a
    # serving profile run token-level request streams and migrate with a
    # KV-cache-aware strategy.  None (default) leaves every scenario
    # fingerprint bit-identical to the pre-serving code.
    serving: Optional[object] = None


class FleetRuntime:
    """Event loop over a `PlacementEngine` + policy + migration ledger."""

    def __init__(
        self,
        topo: Topology,
        policy: ReconfigPolicy,
        config: Optional[RuntimeConfig] = None,
        all_sites: bool = False,
        tracer=None,
    ) -> None:
        self.policy = policy
        self.config = config or RuntimeConfig()
        self.engine = PlacementEngine(
            topo, all_sites=all_sites,
            admission_mode=self.config.admission_mode)
        # Serving workload (`fleet.serving`), opt-in: token queues per
        # serving app plus a KV-cache-aware backend (unless the caller
        # supplied one — a `ServingElasticBackend` gets the workload bound,
        # any other backend keeps opaque-blob semantics on purpose).
        self.serving = None
        backend = self.config.elastic_backend
        if self.config.serving is not None:
            from .serving import ServingElasticBackend, ServingWorkload
            self.serving = ServingWorkload(self.config.serving)
            if backend is None:
                backend = ServingElasticBackend(
                    self.serving,
                    default_state_mb=self.config.state_mb,
                    forced_strategy=self.config.serving.forced_strategy)
            elif hasattr(backend, "bind_workload"):
                backend.bind_workload(self.serving)
        self.executor = MigrationExecutor(
            state_mb=self.config.state_mb,
            reserve_mbps=self.config.migration_reserve_mbps,
            backend=backend,
        )
        self.now = 0.0
        self._since_reconfig = 0
        self._events = EventQueue()   # bound to the live queue by run()
        # Request-stream state: per-app curve and the rate its footprint is
        # currently admitted at (1.0 for apps without a curve).  The bank
        # mirrors (curve, admitted rate) in struct-of-arrays form so the
        # periodic resample is one fused numpy pass over the fleet.
        self._curves: Dict[int, RateCurve] = {}
        self._rates: Dict[int, float] = {}
        self._bank = RateBank()
        # Apps whose rate or placement regressed since the last plan —
        # the churn-aware planning window (config.window_policy="churn").
        self._churned: set = set()
        # Observability (`fleet.obs`): the span tracer is strictly additive
        # (behavior-neutral — fingerprints are bit-identical with it on or
        # off); metrics and the SLO monitor are always on and deterministic.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        bind = getattr(policy, "bind_tracer", None)
        if bind is not None:
            bind(self.tracer)
        self.metrics = MetricsRegistry()
        self.slo = SloMonitor(self.config.slo)
        if self.serving is not None:
            self.serving.attach(self.metrics, self.executor)
        # Calibration ledger (`fleet.obs.calibration`): joins plan-time
        # predictions against the executor's measured outcomes.  Always on
        # (deterministic, excluded from fingerprints); feedback into the
        # cost model is the opt-in part.
        self.calibration = CalibrationLedger(
            self.metrics, feedback=self.config.cost_feedback)
        if self.config.cost_feedback:
            cm = getattr(self.policy, "cost_model", None)
            if cm is not None and hasattr(cm, "enable_feedback"):
                cm.enable_feedback(self.executor.backend, self.calibration)
        # Cursor into the executor's append-only migration ledger: records
        # past it are new since the last drain (tracing the executor from
        # outside keeps the reservation ledger observability-free).
        self._rec_cursor = 0

    # ------------------------------------------------------------------ run
    def run(self, events: EventQueue, scenario: str = "", seed: int = 0) -> Telemetry:
        tel = Telemetry(scenario, self.policy.name, seed)
        self._events = events
        while events:
            self.now, ev = events.pop()
            if self.tracer.enabled:
                self.tracer.instant(_event_label(ev), self.now, cat="event")
            self._dispatch(ev, events, tel)
            self._drain_records(tel)
        self._drain_records(tel)
        if self.serving is not None:
            self.serving.finalize(
                self.now, tel,
                mean_ratio=(tel.ticks[-1].mean_satisfaction
                            if tel.ticks else 2.0))
        tel.counters["migrations_dropped"] = self.executor.moves_dropped
        tel.migrations = list(self.executor.records)
        tel.metrics = self.metrics.snapshot()
        tel.calibration = self.calibration.report()
        return tel

    def _dispatch(self, ev: Event, events: EventQueue, tel: Telemetry) -> None:
        c = tel.counters
        if isinstance(ev, AppArrival):
            self._on_arrival(ev, events, tel)
        elif isinstance(ev, AppDeparture):
            # The app may already be gone (failure eviction that found no
            # new home) — departures are idempotent.
            if ev.req_id in self.engine.placed:
                if self.engine.is_migrating(ev.req_id):
                    self.executor.cancel(self.engine, ev.req_id, self.now, events)
                    c["migrations_cancelled"] += 1
                self._forget(ev.req_id)
                self.engine.release(ev.req_id)
                c["departures"] += 1
                self.executor.on_capacity_freed(self.engine, self.now, events)
        elif isinstance(ev, DemandDrift):
            alive = [r for r in self.engine.placement_order
                     if not self.engine.is_migrating(r)]
            if not alive:
                return
            req_id = alive[ev.selector % len(alive)]
            c["drifts"] += 1
            if not self._readmit(req_id, scale=ev.scale):
                c["drift_evicted"] += 1
        elif isinstance(ev, RequestRateUpdate):
            self._on_rate_update(ev, events, tel)
        elif isinstance(ev, MigrationStart):
            c["migrations_started"] += 1
        elif isinstance(ev, MigrationComplete):
            rec = self.executor.on_complete(self.engine, ev.req_id, ev.gen,
                                            self.now, events)
            if rec is not None:
                c["migrations_completed"] += 1
        elif isinstance(ev, NodeFailure):
            self._on_failure(ev, events, tel)
        elif isinstance(ev, NodeRecovery):
            c["recoveries"] += 1
            self.engine.set_node_online(ev.node_id, True)
            self.executor.on_capacity_freed(self.engine, self.now, events)
            if self.config.reconfig_on_failure:
                self._tick("recovery", tel, events)
        elif isinstance(ev, LinkFailure):
            self._on_link_failure(ev, events, tel)
        elif isinstance(ev, LinkRecovery):
            c["link_recoveries"] += 1
            self.engine.set_link_online(ev.link_id, True)
            self.executor.on_capacity_freed(self.engine, self.now, events)
            if self.config.reconfig_on_failure:
                self._tick("recovery", tel, events)
        elif isinstance(ev, SessionArrival):
            if self.serving is None:
                raise TypeError(
                    "SessionArrival requires RuntimeConfig.serving")
            self.serving.on_session(ev.req_id, ev.session_id,
                                    ev.prompt_tokens, ev.decode_tokens,
                                    self.now, self._rates.get(ev.req_id, 1.0))
        elif isinstance(ev, ReconfigTick):
            self._tick("tick", tel, events)
        else:
            raise TypeError(f"unknown event {ev!r}")

    # --------------------------------------------------------------- events
    def _on_arrival(self, ev: AppArrival, events: EventQueue, tel: Telemetry) -> None:
        c = tel.counters
        c["arrivals"] += 1
        inflight = self.executor.n_inflight > 0
        if inflight:
            c["arrivals_inflight"] += 1
        req = ev.request
        rate0 = 1.0
        if ev.rate_curve is not None:
            rate0 = ev.rate_curve.rate(self.now)
            req = _scaled_request(req, rate0)
        t0 = time.perf_counter()
        placed = self.engine.place(req)
        # Wall-clock admission latency (excluded from fingerprints, like
        # every `admission/` metric — see telemetry.WALL_CLOCK_METRIC_PREFIXES).
        self.metrics.histogram("admission/place_s",
                               DEFAULT_LATENCY_BUCKETS_S).observe(
            time.perf_counter() - t0)
        if placed is None:
            c["rejected"] += 1
            if inflight:
                c["rejected_inflight"] += 1
            return
        c["admitted"] += 1
        if self.serving is not None:
            self.serving.register(req.req_id, self.now)
        if ev.rate_curve is not None:
            self._curves[req.req_id] = ev.rate_curve
            self._bank.add(req.req_id, ev.rate_curve, rate0)
        self._rates[req.req_id] = rate0
        self._churned.add(req.req_id)
        if ev.lifetime_s is not None:
            events.push(self.now + ev.lifetime_s, AppDeparture(req.req_id))
        self._since_reconfig += 1
        if self._since_reconfig >= self.config.reconfig_every:
            self._tick("arrivals", tel, events)

    def _on_rate_update(self, ev: RequestRateUpdate, events: EventQueue,
                        tel: Telemetry) -> None:
        c = tel.counters
        # One fused numpy pass over every curve (RateBank) replaces the
        # per-app Python loop; the re-admissions then run in the exact
        # placement order the loop used, preserving its semantics
        # (mid-migration apps skipped, rates confirmed only on success).
        changed = self._bank.sample(self.now, self.config.rate_epsilon)
        if changed:
            # Consume the batch: only the changed apps, in the exact
            # admission order the historical placement_order scan visited
            # them (engine.in_admission_order), instead of probing every
            # placed app per rate event.
            for req_id in self.engine.in_admission_order(changed):
                if self.engine.is_migrating(req_id):
                    continue
                target = changed[req_id]
                cur = self._rates.get(req_id, 1.0)
                c["rate_updates"] += 1
                if self._readmit(req_id, scale=target / cur):
                    self._rates[req_id] = target
                    self._bank.set_rate(req_id, target)
                else:
                    c["rate_evicted"] += 1
        if self.now + ev.every_s <= ev.horizon_s:
            events.push(self.now + ev.every_s, ev)

    def _on_failure(self, ev: NodeFailure, events: EventQueue, tel: Telemetry) -> None:
        c = tel.counters
        c["failures"] += 1
        self.engine.set_node_online(ev.node_id, False)
        # First let the ledger abort transfers touching the dead node …
        rolled_back, homeless = self.executor.on_node_failure(
            self.engine, ev.node_id, self.now, events)
        c["migrations_aborted"] += len(rolled_back) + len(homeless)
        c["migration_rollbacks"] += len(rolled_back)
        for req_id in homeless:
            # Suspended app whose destination died: its source slot is gone
            # too, so re-place it anywhere (or lose it).
            if self._readmit(req_id):
                c["failover_moved"] += 1
            else:
                c["migration_lost"] += 1
        # … then evict the apps whose live copy sat on the node.
        for req_id in self.engine.apps_on_node(ev.node_id):
            if self._readmit(req_id):
                c["failover_moved"] += 1
            else:
                c["failover_lost"] += 1
        if self.config.reconfig_on_failure:
            self._tick("failure", tel, events)

    def _on_link_failure(self, ev: LinkFailure, events: EventQueue,
                         tel: Telemetry) -> None:
        """Uplink/backbone cut: candidate paths through the link become
        infeasible, transfers crossing it are aborted with source rollback
        (`executor.on_link_failure`), then every app whose live path used
        the link is evicted and re-placed (or lost)."""
        c = tel.counters
        c["link_failures"] += 1
        self.engine.set_link_online(ev.link_id, False)
        rolled_back, homeless = self.executor.on_link_failure(
            self.engine, ev.link_id, self.now, events)
        c["migrations_aborted"] += len(rolled_back) + len(homeless)
        c["migration_rollbacks"] += len(rolled_back)
        for req_id in homeless:
            if self._readmit(req_id):
                c["linkfail_moved"] += 1
            else:
                c["migration_lost"] += 1
        for req_id in self.engine.apps_on_link(ev.link_id):
            if self._readmit(req_id):
                c["linkfail_moved"] += 1
            else:
                c["linkfail_lost"] += 1
        if self.config.reconfig_on_failure:
            self._tick("failure", tel, events)

    # -------------------------------------------------------------- helpers
    def _forget(self, req_id: int) -> None:
        self._curves.pop(req_id, None)
        self._rates.pop(req_id, None)
        self._bank.discard(req_id)
        self._churned.discard(req_id)
        if self.serving is not None:
            # Departure or lost to a failure: serve what completed by now,
            # cancel the rest (the conservation ledger's `cancelled` side).
            self.serving.on_departure(req_id, self.now)

    def _readmit(self, req_id: int, scale: float = 1.0) -> bool:
        """Release ``req_id`` and place it again (rescaling its bandwidth/
        data footprint).  Returns False if no home was found — the app is
        lost (recorded in ``engine.rejected``).  Never called on a
        mid-migration app: the runtime cancels/aborts its transfer first."""
        placed = self.engine.placed[req_id]
        req = placed.request
        if scale != 1.0:
            req = _scaled_request(req, scale)
        t0 = time.perf_counter()
        self.engine.release(req_id)
        ok = self.engine.place(req) is not None
        self.metrics.histogram("admission/readmit_s",
                               DEFAULT_LATENCY_BUCKETS_S).observe(
            time.perf_counter() - t0)
        if not ok:
            self._forget(req_id)
        else:
            # Every re-admission path (rate swing, drift, failover, link
            # cut) is a rate or placement regression — churn.  Migration
            # completions are planned improvements and do NOT mark.
            self._churned.add(req_id)
        self.executor.on_capacity_freed(self.engine, self.now, self._events)
        return ok

    def _utilization(self) -> tuple:
        """(aggregate, max) used/capacity over online nodes of the device
        kinds the current population actually consumes."""
        kinds = {a.request.app.device_kind for a in self.engine.placed.values()}
        used = cap = 0.0
        worst = 0.0
        for nid, node in self.engine.topo.nodes.items():
            if nid in self.engine.offline_nodes or node.kind not in kinds:
                continue
            if self.engine.topo.sites[node.site_id].tier == TIER_INPUT:
                continue
            used += self.engine.node_used[nid]
            cap += node.capacity
            worst = max(worst, self.engine.node_used[nid] / node.capacity)
        return (used / cap if cap else 0.0), worst

    def _mean_rate(self) -> float:
        if not self.engine.placed:
            return 0.0
        return sum(self._rates.get(r, 1.0) for r in self.engine.placed) / len(
            self.engine.placed)

    def _select_window(self) -> list:
        """The re-placement window for this tick.  ``recent``: the paper's
        most-recent-N stable apps.  ``churn``: only apps marked churned
        since the last plan (still capped at N, most recent first), so a
        busy tick re-plans exactly what regressed."""
        if self.config.window_policy == "churn":
            eng = self.engine
            churned = self._churned
            window = [r for r in eng.placement_order
                      if r in churned and not eng.is_migrating(r)]
            return window[-self.config.window:]
        return self.engine.recent_stable(self.config.window)

    def _tick(self, trigger: str, tel: Telemetry, events: EventQueue) -> None:
        self._since_reconfig = 0
        window = self._select_window()
        if not window:
            return
        with self.tracer.span("tick", cat="tick",
                              args={"trigger": trigger, "t_sim": self.now,
                                    "window": len(window)}):
            self._tick_body(trigger, tel, events, window)
        # Planned: these apps got their re-placement look; drop them from
        # the churn set so the next window is the next delta.
        if self.config.window_policy == "churn":
            self._churned.difference_update(window)

    def _tick_body(self, trigger: str, tel: Telemetry, events: EventQueue,
                   window) -> None:
        if self.serving is not None:
            # Bring every token queue current *before* planning so the
            # strategy pricing (cached context, decode backlog) sees the
            # fleet as of this tick, then flush the latency histograms.
            self.serving.observe_tick(self.now)
        weights = {r: self._rates.get(r, 1.0) for r in window}
        observe = getattr(self.policy, "observe", None)
        if observe is not None:
            # Context the planner subsystem consumes: the simulated clock
            # and rate curves (rolling-horizon forecasts) and the executor
            # ledger (migration-aware move pricing).
            observe(now=self.now, curves=self._curves, executor=self.executor)
        # The "plan" span wraps the whole policy call; the planner emits its
        # own child spans (journal_scan / region_solve / arbitration).
        with self.tracer.span("plan", cat="tick"):
            res = self.policy.plan(self.engine, window, weights=weights)
        stats = getattr(self.policy, "last_plan_stats", None)
        n_started = 0
        with self.tracer.span("commit", cat="tick",
                              args={"accepted": res.accepted,
                                    "moves": len(res.moves)}):
            if res.accepted and res.moves:
                n_started = self.executor.begin(self.engine, res, self.now,
                                                events)
                tel.counters["moves"] += res.n_moved
                self._record_predictions(res)
        util, util_max = self._utilization()
        # Post-tick fleet satisfaction (weighted mean X+Y over the window):
        # the planned value when the plan was accepted, else the do-nothing
        # baseline 2.0 — simulated, deterministic, and the SLO input.
        mean_sat = res.s_after / len(window) if res.accepted else 2.0
        rec = TickRecord(
            t=self.now,
            trigger=trigger,
            n_alive=len(self.engine.placed),
            window=len(window),
            n_moved=res.n_moved if res.accepted else 0,
            accepted=res.accepted,
            gain=res.gain if res.accepted else 0.0,
            mean_moved_ratio=res.mean_moved_ratio if res.accepted else None,
            mean_moved_ratio_weighted=(res.mean_moved_ratio_weighted
                                       if res.accepted else None),
            mean_rate=self._mean_rate(),
            solver_time_s=res.plan_time_s,
            n_started=n_started,
            n_inflight=self.executor.n_inflight,
            utilization=util,
            utilization_max=util_max,
            n_regions=stats.n_regions if stats else 0,
            boundary_crossings=stats.boundary_crossings if stats else 0,
            region_solve_max_s=stats.region_solve_max_s if stats else 0.0,
            forecast_error=stats.forecast_error if stats else None,
            regions_reused=stats.regions_reused if stats else 0,
            warm_start_hits=stats.warm_start_hits if stats else 0,
            n_feasible=stats.n_feasible if stats else 0,
            subtrees_skipped=stats.subtrees_skipped if stats else 0,
            mean_satisfaction=mean_sat,
            build_s=stats.build_s if stats else 0.0,
            lp_iterations=stats.lp_iterations if stats else 0,
            bnb_nodes=stats.bnb_nodes if stats else 0,
        )
        tel.ticks.append(rec)
        self._observe_tick_metrics(rec, stats)
        for breach in self.slo.observe_tick(self.now, mean_sat):
            self._on_breach(breach, tel)
        if self.config.check_invariants and not self.engine.occupancy_invariants_ok():
            raise AssertionError("occupancy invariants violated after tick")

    # -------------------------------------------------------- observability
    def _record_predictions(self, res) -> None:
        """Capture the plan's quantified beliefs about each committed move
        — wire size, phase times, fair-share rate, satisfaction gain — in
        the calibration ledger, to be joined against the executor's
        measured `MigrationRecord` when the transfer resolves.

        The prediction mirrors what the *planner* believed, not what the
        executor knows: with ``cost_feedback`` off that is the flat
        ``state_mb`` copy with zero host phases (the legacy pricing
        belief); with feedback on it is the backend's declared phases,
        overridden by ledger-measured per-app values once available."""
        shares = self.executor.link_shares()
        for mv in res.moves:
            placed = self.engine.placed.get(mv.req_id)
            if placed is None:
                continue
            links = {l.link_id: l.bandwidth_mbps for l in mv.old.links}
            links.update({l.link_id: l.bandwidth_mbps for l in mv.new.links})
            uncont = min(links.values(), default=100.0)
            rate = min((bw / max(shares.get(lid, 1), 1)
                        for lid, bw in links.items()), default=100.0)
            if self.config.cost_feedback:
                mbits, snap_s, rest_s = self.executor.backend.predict_phases(
                    placed.request, mv)
                learned = self.calibration.learned_mbits(mv.req_id)
                if learned is not None:
                    mbits = learned
                host = self.calibration.learned_host(mv.req_id)
                if host is not None:
                    snap_s, rest_s = host
            else:
                mbits = self.executor.state_mb * 8.0
                snap_s = rest_s = 0.0
            # Serving apps: the prediction carries the strategy the backend
            # would choose for this move *now*, and its per-strategy phases
            # (the executor re-chooses at transfer start — the record's
            # strategy is the measured truth the join scores against).
            strategy = None
            backend = self.executor.backend
            if self.serving is not None and hasattr(backend,
                                                    "strategy_phases"):
                phases = backend.strategy_phases(placed.request, mv)
                if phases is not None:
                    strategy = backend.choose_strategy(placed.request, mv)
                    mbits, snap_s, rest_s = phases[strategy]
            prov = (res.provenance or {}).get(mv.req_id)
            if strategy is not None and prov is not None:
                prov = dataclasses.replace(prov, strategy=strategy)
            self.calibration.record_move(MovePrediction(
                req_id=mv.req_id,
                t_plan=self.now,
                mbits=mbits,
                snapshot_s=snap_s,
                transfer_s=mbits / max(rate, 1e-9),
                restore_s=rest_s,
                rate_mbps=rate,
                uncontended_mbps=uncont,
                gain=2.0 - mv.ratio,
                r_before=mv.old.response_s,
                p_before=mv.old.price,
                feedback=self.config.cost_feedback,
                provenance=prov,
                strategy=strategy,
            ))

    def _observe_tick_metrics(self, rec: TickRecord, stats) -> None:
        m = self.metrics
        m.counter("tick/count").inc()
        m.counter("tick/accepted").inc(int(rec.accepted))
        m.histogram("tick/satisfaction",
                    DEFAULT_RATIO_BUCKETS).observe(rec.mean_satisfaction)
        m.histogram("tick/moved_ratio",
                    DEFAULT_FRACTION_BUCKETS).observe(rec.moved_ratio)
        m.histogram("node/utilization",
                    DEFAULT_FRACTION_BUCKETS).observe(rec.utilization)
        m.histogram("solver/latency_s",
                    DEFAULT_LATENCY_BUCKETS_S).observe(rec.solver_time_s)
        # Per-link utilization (reservations included) + contention: links
        # running above 90% of their bandwidth this tick.
        link_hist = m.histogram("link/utilization", DEFAULT_FRACTION_BUCKETS)
        contended = 0
        # One array pass over the link ledger (identical values to the
        # per-link `link_remaining` sweep: same IEEE op order); the
        # observe() loop stays sequential in topology link order so the
        # histogram stream — and thus the tick fingerprint — is unchanged.
        caps, rem = self.engine.link_capacity_remaining()
        with np.errstate(divide="ignore", invalid="ignore"):
            utils = 1.0 - rem / caps
        for cap, u in zip(caps.tolist(), utils.tolist()):
            if cap <= 0.0:
                continue
            link_hist.observe(u)
            if u > 0.9:
                contended += 1
        m.counter("link/contended").inc(contended)
        if stats is not None:
            m.counter("planner/regions_solved").inc(stats.n_regions)
            m.counter("planner/regions_reused").inc(stats.regions_reused)
            m.counter("planner/subtrees_skipped").inc(stats.subtrees_skipped)
            m.counter("planner/warm_start_hits").inc(stats.warm_start_hits)
            m.counter("planner/warm_start_misses").inc(stats.warm_start_misses)
            m.counter("solver/lp_iterations").inc(stats.lp_iterations)
            m.counter("solver/bnb_nodes").inc(stats.bnb_nodes)
            m.histogram("planner/build_s",
                        DEFAULT_LATENCY_BUCKETS_S).observe(stats.build_s)
        if rec.forecast_error is not None:
            fc = getattr(self.policy, "forecaster", None)
            self.calibration.observe_forecast(
                rec.t, rec.forecast_error,
                getattr(fc, "last_residuals", None) if fc is not None else None)

    def _drain_records(self, tel: Telemetry) -> None:
        """Consume executor ledger rows appended since the last drain:
        migration metrics + sim-time trace spans + the downtime SLO.  The
        phases of one transfer are sequential (snapshot → copy → restore),
        so their sim-time intervals reconstruct exactly from the record."""
        records = self.executor.records
        while self._rec_cursor < len(records):
            i = self._rec_cursor
            rec = records[i]
            self._rec_cursor += 1
            m = self.metrics
            m.counter(f"migration/{rec.outcome}").inc()
            m.histogram("migration/downtime_s",
                        DEFAULT_LATENCY_BUCKETS_S).observe(rec.downtime_s)
            if rec.outcome == "completed":
                m.histogram("migration/duration_s",
                            DEFAULT_LATENCY_BUCKETS_S).observe(rec.duration_s)
            # Predicted-vs-actual join: the executor's measurement
            # side-channel is index-aligned with its record ledger.
            meas = (self.executor.measurements[i]
                    if i < len(self.executor.measurements) else None)
            pred, _ = self.calibration.observe_record(rec, meas)
            if self.serving is not None:
                self.serving.on_record(rec)
            if pred is not None and rec.outcome == "completed":
                placed = self.engine.placed.get(rec.req_id)
                if placed is not None:
                    realized = 2.0 - (
                        placed.response_s / max(pred.r_before, 1e-9)
                        + placed.price / max(pred.p_before, 1e-9))
                    self.calibration.observe_gain(rec.t_end, pred.gain,
                                                  realized)
            if self.tracer.enabled:
                track = f"mig {i}: app {rec.req_id}"
                snap_end = min(rec.t_start + rec.snapshot_s, rec.t_end)
                restore_start = max(rec.t_end - rec.restore_s, snap_end)
                span_args = {"mode": rec.mode, "outcome": rec.outcome,
                             "downtime_s": rec.downtime_s}
                if rec.strategy is not None:
                    span_args["strategy"] = rec.strategy
                if pred is not None and pred.provenance is not None:
                    span_args["why"] = pred.provenance.to_dict()
                self.tracer.add_span(
                    f"migrate #{rec.req_id}", "migration", track,
                    rec.t_start, rec.t_end, args=span_args)
                self.tracer.add_span("snapshot", "migration", track,
                                     rec.t_start, snap_end)
                self.tracer.add_span("copy", "migration", track,
                                     snap_end, restore_start)
                self.tracer.add_span("restore", "migration", track,
                                     restore_start, rec.t_end)
            for breach in self.slo.observe_migration(rec.t_end,
                                                     rec.downtime_s):
                self._on_breach(breach, tel)

    def _on_breach(self, breach, tel: Telemetry) -> None:
        """Record an SLO breach and forward it to the policy's
        ``on_slo_breach`` hook (observe → act: `AdaptivePolicy` escalates
        one tier toward the exact solver)."""
        tel.slo_breaches.append(breach)
        tel.counters["slo_breaches"] += 1
        self.metrics.counter(f"slo/{breach.slo}_breaches").inc()
        if self.tracer.enabled:
            self.tracer.instant(f"SloBreach:{breach.slo}", breach.t,
                                cat="slo",
                                args={"burn_rate": round(breach.burn_rate, 3)})
        hook = getattr(self.policy, "on_slo_breach", None)
        if hook is not None and hook(breach):
            tel.counters["slo_escalations"] += 1
            self.metrics.counter("slo/escalations").inc()


def _event_label(ev: Event) -> str:
    """Trace-instant label for a fleet event (req/node/link id when the
    event carries one)."""
    name = type(ev).__name__
    for attr in ("req_id", "node_id", "link_id"):
        v = getattr(ev, attr, None)
        if v is not None:
            return f"{name} {v}"
    req = getattr(ev, "request", None)
    if req is not None:
        return f"{name} {req.req_id}"
    return name


def _scaled_request(req: PlacementRequest, scale: float) -> PlacementRequest:
    app = dataclasses.replace(
        req.app,
        bandwidth_mbps=req.app.bandwidth_mbps * scale,
        data_mb=req.app.data_mb * scale,
    )
    return PlacementRequest(req.req_id, app, req.input_site, req.requirement)
