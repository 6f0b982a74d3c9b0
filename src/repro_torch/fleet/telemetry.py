"""Per-tick + per-migration telemetry of a continuous-operation run.

A *tick* is one reconfiguration event.  Each tick snapshots the paper's
quantities (moved ratio, mean moved-app satisfaction X+Y — both raw and
traffic-weighted, solver latency) plus operational ones (alive population,
utilization, transfers started / in flight).  Migrations occupy simulated
time, so their cost shows up as `MigrationRecord` rows when they *finish*
(or abort), not on the tick that planned them.

On rejected ticks nothing moved, so there is no moved-app satisfaction to
report: those fields are ``None`` (JSON null) and every aggregate skips
them — no magic sentinel leaking into benchmark means.

`Telemetry.fingerprint()` hashes the canonical JSON minus everything
wall-clock or work-accounting — the exclusion list is *declared*, not
ad-hoc: every `TickRecord` field is classified into exactly one of
`FINGERPRINTED_TICK_FIELDS` / `WALL_CLOCK_TICK_FIELDS` /
`WORK_ACCOUNTING_TICK_FIELDS` (a regression test asserts the partition is
total), so a new observability field cannot silently break the
determinism contract.  The determinism tests assert fixed seed →
identical fingerprint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

from .obs.metrics import mean_or_none, weighted_mean_or_none


@dataclasses.dataclass
class PlanStats:
    """Planner-side detail for one tick, produced by the decomposed /
    rolling-horizon planners (`fleet.planner`) and surfaced on the tick
    record.  ``region_solve_s`` is wall-clock and therefore excluded from
    fingerprints (like ``solver_time_s``)."""

    n_regions: int = 0                 # regional subproblems actually solved
    boundary_crossings: int = 0        # apps assigned outside their home region
    region_solve_s: List[float] = dataclasses.field(default_factory=list)
    forecast_error: Optional[float] = None  # mean |predicted−realized|/realized
    # Incremental-planning detail (`incremental` policy mode): regions whose
    # cached plan was reused instead of re-solved, warm-start incumbent
    # hits/misses across the regional solves, and solves that returned a
    # deadline incumbent ("feasible") instead of a proven optimum.
    regions_reused: int = 0
    warm_start_hits: int = 0
    warm_start_misses: int = 0
    n_feasible: int = 0
    # Hierarchical planning: closed level-1 subtrees replayed wholesale
    # (journal-clean + matching subtree signature — see `planner.decomposed`).
    subtrees_skipped: int = 0
    # Hot-path profiling (wall clock / solver work — never fingerprinted):
    # CSR assembly time across the tick's `build_joint_milp` calls, simplex
    # pivots summed over every LP relaxation, and B&B nodes explored.
    build_s: float = 0.0
    lp_iterations: int = 0
    bnb_nodes: int = 0

    @property
    def region_solve_max_s(self) -> float:
        return max(self.region_solve_s, default=0.0)


@dataclasses.dataclass(frozen=True)
class MigrationRecord:
    """One finished/aborted/cancelled migration (executor ledger row).

    Since the elastic bridge, every migration is a checkpoint → reshard →
    resume pipeline and its phases are recorded: ``snapshot_s`` (host-side
    state serialize), ``transfer_s`` (checkpoint bytes on the wire at the
    fair-share link rate), ``restore_s`` (mesh rebuild + reshard-restore
    at the destination).  ``downtime_s`` is the user-visible subset:
    pre-copy pauses for one dirty-page round + the restore cutover;
    stop-and-copy pauses for the whole pipeline.  Apps with no declared
    state run the legacy flat model (zero host phases)."""

    req_id: int
    mode: str                      # "precopy" | "stop_and_copy"
    outcome: str                   # "completed" | "aborted" | "cancelled"
    t_start: float
    t_end: float
    downtime_s: float
    snapshot_s: float = 0.0        # elastic-bridge phase timings
    transfer_s: float = 0.0
    restore_s: float = 0.0
    # Serving-workload migrations record which state strategy the backend
    # chose ("drain" | "replay" | "kv-ship"); None for every other app, and
    # dropped from `to_dict` when None so non-serving runs serialize — and
    # fingerprint — exactly as before the serving workload existed.
    strategy: Optional[str] = None

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass(frozen=True)
class TransferMeasurement:
    """Executor-measured facts about one migration's transfer, recorded
    index-aligned with `MigrationRecord` (the executor appends one per
    retired record).  This is the *actual* side of the calibration join
    (`obs.calibration.CalibrationLedger`): what really went on the wire,
    over which links, and how fast the path would have been uncontended —
    so residuals can separate size-model error from fair-share
    contention."""

    req_id: int
    mbits: float                   # measured checkpoint size on the wire
    nbytes: Optional[int]          # backend byte count (None: flat model)
    n_shards: int                  # shard layout the bytes crossed in
    links: Tuple[str, ...]         # path link ids the transfer occupied
    uncontended_mbps: float        # path bottleneck bandwidth, no sharing


@dataclasses.dataclass
class TickRecord:
    t: float                       # sim time of the tick
    trigger: str                   # "arrivals" | "failure" | "recovery" | "tick"
    n_alive: int
    window: int
    n_moved: int
    accepted: bool
    gain: float
    mean_moved_ratio: Optional[float]           # fig. 5(b); None if no moves
    mean_moved_ratio_weighted: Optional[float]  # traffic-weighted variant
    mean_rate: float               # mean request rate over alive streams
    solver_time_s: float
    n_started: int                 # transfers started by this tick
    n_inflight: int                # active + waiting after the tick
    utilization: float             # Σ used / Σ capacity over online nodes
    utilization_max: float         # hottest online node
    # Planner-subsystem detail (zero / None under monolithic policies).
    n_regions: int = 0
    boundary_crossings: int = 0
    region_solve_max_s: float = 0.0         # wall clock; not fingerprinted
    forecast_error: Optional[float] = None  # rolling-horizon planner only
    # Incremental-planning detail (zero under non-incremental policies).
    regions_reused: int = 0
    warm_start_hits: int = 0
    n_feasible: int = 0                     # deadline incumbents; not fingerprinted
    subtrees_skipped: int = 0               # hierarchical wholesale skips
    # Post-tick fleet satisfaction: weighted mean X+Y over the window after
    # the tick (2.0 = do-nothing baseline; stays 2.0 on rejected ticks).
    # Simulated quantity → fingerprinted, and the SLO monitor's input.
    mean_satisfaction: Optional[float] = None
    # Planner hot-path profiling (wall clock / solver work; see PlanStats).
    build_s: float = 0.0
    lp_iterations: int = 0
    bnb_nodes: int = 0

    @property
    def moved_ratio(self) -> float:
        """fig. 5(a) quantity: fraction of the window that actually moved."""
        return self.n_moved / self.window if self.window else 0.0


# --------------------------------------------------------------- fingerprint
# The fingerprint partition, declared in ONE place.  Every TickRecord field
# is classified below (tests/test_observability.py asserts the partition is
# total and disjoint), so adding an observability field forces an explicit
# decision instead of silently entering — or leaking out of — the
# determinism contract.

#: Wall-clock durations: vary run-to-run on the same inputs.
WALL_CLOCK_TICK_FIELDS = frozenset({
    "solver_time_s", "region_solve_max_s", "build_s",
})

#: Planner work accounting: *how* the answer was obtained (regions solved
#: vs reused, warm starts, deadline incumbents, solver effort) — excluded
#: so incremental≡decomposed parity can hold despite different work.
WORK_ACCOUNTING_TICK_FIELDS = frozenset({
    "n_regions", "regions_reused", "warm_start_hits", "n_feasible",
    "lp_iterations", "bnb_nodes", "subtrees_skipped",
})

UNFINGERPRINTED_TICK_FIELDS = WALL_CLOCK_TICK_FIELDS | WORK_ACCOUNTING_TICK_FIELDS

#: Everything else on a TickRecord IS the behavior and is hashed.
FINGERPRINTED_TICK_FIELDS = frozenset(
    f.name for f in dataclasses.fields(TickRecord)
) - UNFINGERPRINTED_TICK_FIELDS

#: Summary keys dropped from the fingerprint (derived from wall clock).
UNFINGERPRINTED_SUMMARY_FIELDS = frozenset({"mean_solver_time_s"})

#: Metric namespaces (see `obs.metrics.MetricsRegistry`) whose snapshots
#: are wall-clock- or work-derived and therefore dropped wholesale.
#: ``admission/`` is the arrival-path latency family (`admission/place_s`,
#: `admission/readmit_s`): pure wall clock, so scalar- and vector-mode
#: runs keep bit-identical fingerprints.
WALL_CLOCK_METRIC_PREFIXES = ("solver/", "planner/", "admission/")

#: Calibration namespaces: deterministic (two identical runs report
#: identical residuals — tests assert it) but *about* the run rather
#: than *of* it, and present only when a prediction ledger is attached —
#: excluded so attaching calibration can never perturb the behavior
#: contract, mirroring how tracing is behavior-neutral.
CALIBRATION_METRIC_PREFIXES = ("calibration/", "forecast/")

UNFINGERPRINTED_METRIC_PREFIXES = (WALL_CLOCK_METRIC_PREFIXES
                                   + CALIBRATION_METRIC_PREFIXES)


@dataclasses.dataclass
class Telemetry:
    scenario: str
    policy: str
    seed: int
    ticks: List[TickRecord] = dataclasses.field(default_factory=list)
    migrations: List[MigrationRecord] = dataclasses.field(default_factory=list)
    # SLO burn-rate breaches (`obs.slo.SloBreach`) in emission order.
    # Deterministic — they derive from simulated quantities only — so they
    # are fingerprinted like any other behavior.
    slo_breaches: List = dataclasses.field(default_factory=list)
    # `obs.metrics.MetricsRegistry.snapshot()` attached by the runtime at
    # the end of the run (empty when run outside a FleetRuntime).
    metrics: Dict = dataclasses.field(default_factory=dict)
    # `obs.calibration.CalibrationLedger.report()` attached by the runtime
    # at the end of the run: predicted-vs-actual join counts, drift
    # records, and per-move provenance.  Deterministic, but excluded from
    # the fingerprint (like CALIBRATION_METRIC_PREFIXES) so the ledger is
    # observability *about* the behavior, never part of it.
    calibration: Dict = dataclasses.field(default_factory=dict)
    # Serving-workload summary (`fleet.serving.ServingWorkload.finalize`):
    # token conservation counts, throughput, p99 token latency, per-strategy
    # migration counts.  Empty — and absent from `to_dict` — for runs with
    # no serving apps, so non-serving fingerprints are untouched; when
    # present it is simulated behavior and IS fingerprinted.
    serving: Dict = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=lambda: {
        "arrivals": 0, "admitted": 0, "rejected": 0, "departures": 0,
        "drifts": 0, "drift_evicted": 0, "failures": 0, "recoveries": 0,
        "failover_moved": 0, "failover_lost": 0, "moves": 0,
        # time-extended migration accounting
        "migrations_started": 0, "migrations_completed": 0,
        "migrations_aborted": 0, "migrations_cancelled": 0,
        "migrations_dropped": 0, "migration_rollbacks": 0,
        "migration_lost": 0,
        # arrivals/rejections that interleaved with an in-flight migration
        "arrivals_inflight": 0, "rejected_inflight": 0,
        # request-stream sampling
        "rate_updates": 0, "rate_evicted": 0,
        # link-cut failures (backbone/uplink outages)
        "link_failures": 0, "link_recoveries": 0,
        "linkfail_moved": 0, "linkfail_lost": 0,
        # SLO monitoring (obs.slo): budget-exhaustion events and how many
        # of them the policy acted on (AdaptivePolicy tier escalations)
        "slo_breaches": 0, "slo_escalations": 0,
    })

    # ------------------------------------------------------------ summaries
    @property
    def mean_moved_ratio(self) -> Optional[float]:
        """Move-weighted mean X+Y over all ticks (the fig. 5(b) aggregate);
        None when the whole run never moved an app."""
        return weighted_mean_or_none(
            (t.n_moved, t.mean_moved_ratio) for t in self.ticks)

    @property
    def mean_moved_ratio_weighted(self) -> Optional[float]:
        return weighted_mean_or_none(
            (t.n_moved, t.mean_moved_ratio_weighted) for t in self.ticks)

    @property
    def mean_solver_time_s(self) -> float:
        if not self.ticks:
            return 0.0
        return sum(t.solver_time_s for t in self.ticks) / len(self.ticks)

    @property
    def total_gain(self) -> float:
        return sum(t.gain for t in self.ticks if t.accepted)

    @property
    def mean_migration_duration_s(self) -> Optional[float]:
        return mean_or_none(m.duration_s for m in self.migrations
                            if m.outcome == "completed")

    @property
    def total_downtime_s(self) -> float:
        return sum(m.downtime_s for m in self.migrations)

    # Elastic-bridge phase aggregates (zero when every app runs the flat
    # no-declared-state fallback).
    @property
    def total_snapshot_s(self) -> float:
        return sum(m.snapshot_s for m in self.migrations)

    @property
    def total_transfer_s(self) -> float:
        return sum(m.transfer_s for m in self.migrations)

    @property
    def total_restore_s(self) -> float:
        return sum(m.restore_s for m in self.migrations)

    def to_dict(self) -> Dict:
        rnd = lambda v: round(v, 9) if isinstance(v, float) else v
        d = {
            "scenario": self.scenario,
            "policy": self.policy,
            "seed": self.seed,
            "counters": dict(self.counters),
            "summary": {
                "ticks": len(self.ticks),
                "mean_moved_ratio": rnd(self.mean_moved_ratio),
                "mean_moved_ratio_weighted": rnd(self.mean_moved_ratio_weighted),
                "mean_solver_time_s": rnd(self.mean_solver_time_s),
                "total_gain": rnd(self.total_gain),
                "total_moves": self.counters["moves"],
                "mean_migration_duration_s": rnd(self.mean_migration_duration_s),
                "total_downtime_s": rnd(self.total_downtime_s),
                "total_snapshot_s": rnd(self.total_snapshot_s),
                "total_transfer_s": rnd(self.total_transfer_s),
                "total_restore_s": rnd(self.total_restore_s),
            },
            "ticks": [
                {k: rnd(v) for k, v in dataclasses.asdict(t).items()}
                for t in self.ticks
            ],
            "migrations": [
                {k: rnd(v) for k, v in dataclasses.asdict(m).items()
                 if not (k == "strategy" and v is None)}
                for m in self.migrations
            ],
            "slo_breaches": [b.to_dict() for b in self.slo_breaches],
            "metrics": dict(self.metrics),
            "calibration": dict(self.calibration),
        }
        if self.serving:
            d["serving"] = dict(self.serving)
        return d

    def fingerprint(self) -> str:
        """Stable digest of the run's *behavior*: what was placed, moved,
        and reported — excluding everything in the declared exclusion sets
        above: wall-clock durations, deadline incumbents
        (timeout-dependent), the planner's internal work accounting (how
        many regions were solved vs reused, warm-start hits, solver
        effort), and the wall-clock metric namespaces.  Excluding the
        policy label and the work accounting is what lets the incremental
        planner assert byte-identical behavior against the full decomposed
        planner."""
        d = self.to_dict()
        d.pop("policy", None)
        d.pop("calibration", None)
        for key in UNFINGERPRINTED_SUMMARY_FIELDS:
            d["summary"].pop(key, None)
        for t in d["ticks"]:
            for key in UNFINGERPRINTED_TICK_FIELDS:
                t.pop(key, None)
        d["metrics"] = {k: v for k, v in d["metrics"].items()
                        if not k.startswith(UNFINGERPRINTED_METRIC_PREFIXES)}
        return hashlib.sha256(
            json.dumps(d, sort_keys=True).encode()
        ).hexdigest()
