"""Continuous-operation fleet runtime (the paper's reconfigurator as a
service over a changing fleet, with load-bearing simulated time).

  events    — arrival/departure/rate/failure/migration event model,
              per-app `RateCurve` request streams, deterministic queue
  runtime   — discrete-event loop over a `PlacementEngine`; apps gain a
              MIGRATING state while their transfer is in flight
  policies  — one `ReconfigPolicy` interface over MILP / greedy /
              hillclimb / GA, the planner policies (decomposed /
              incremental / horizon) and the `adaptive`
              milp→incremental→greedy ladder, all traffic-weight aware
  executor  — link-capacity reservation ledger: transfers occupy fair-share
              link bandwidth over sim time, double-book source+destination,
              and roll back on destination failure
  elastic_bridge — backend seam mapping every transfer onto the elastic
              checkpoint → reshard → resume pipeline (`runtime.elastic`):
              simulated backend sizes copies from checkpoint byte counts,
              live backend executes them for real
  scenarios — paper-steady-state, diurnal-streams, flash-crowd(+during-
              reconfig), node-outage, site-outage, backbone-cut,
              flapping-node, hetero-expansion, serving-fleet — all
              scalable ×2/×4/×8
  serving   — serving as a first-class workload: token-level session
              streams (`SessionArrival` prefill + decode cadence),
              deterministic per-app FIFO token queues, and KV-cache-aware
              migration strategies (drain / replay / kv-ship) priced into
              move penalties and recorded end-to-end
  planner   — scalable planning subsystem: topology partitioner,
              decomposed per-region MILPs + boundary arbitration,
              rolling-horizon forecasting, migration-aware move pricing
  telemetry — per-tick + per-migration time series, deterministic
              fingerprints (one declared exclusion list), NaN-safe
              satisfaction aggregation
  obs       — observability subsystem: dual-clock span tracer (Perfetto
              export), deterministic metrics registry (fingerprint-safe
              percentiles), SLO burn-rate monitor feeding the policy
              ladder, calibration ledger joining plan-time predictions
              against measured migration outcomes (+ per-move decision
              provenance) — all behavior-neutral
"""

from .events import (  # noqa: F401
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
from .elastic_bridge import (  # noqa: F401
    ElasticBackend,
    FlatStateBackend,
    LiveElasticBackend,
    MigrationPhases,
    SimulatedElasticBackend,
    SnapshotInfo,
    auto_backend,
    execute_move,
)
from .executor import (  # noqa: F401
    InstantExecutor,
    MigrationExecutor,
    MigrationSchedule,
    ScheduledMigration,
    Transfer,
)
from .obs import (  # noqa: F401
    BurnRateDetector,
    CalibrationDrift,
    CalibrationLedger,
    DriftDetector,
    MetricsRegistry,
    MovePrediction,
    MoveProvenance,
    NullTracer,
    SloBreach,
    SloConfig,
    SloMonitor,
    SpanTracer,
    provenance_from_costs,
    validate_trace,
)
from .policies import (  # noqa: F401
    POLICIES,
    AdaptivePolicy,
    GaPolicy,
    GreedyPolicy,
    HillClimbPolicy,
    MilpPolicy,
    NoOpPolicy,
    ReconfigPolicy,
    get_policy,
)
from .planner import (  # noqa: F401  (registers decomposed/incremental/hierarchical/horizon)
    DecomposedPolicy,
    DemandForecaster,
    HierarchicalPolicy,
    HorizonPolicy,
    IncrementalPolicy,
    MigrationCostModel,
    Partition,
    PartitionTree,
    Region,
    partition_topology,
    partition_tree,
)
from .runtime import FleetRuntime, RuntimeConfig  # noqa: F401
from .scenarios import SCENARIOS, ScenarioSpec, build_scenario  # noqa: F401
from .serving import (  # noqa: F401
    STRATEGIES,
    STRATEGY_DRAIN,
    STRATEGY_KV_SHIP,
    STRATEGY_REPLAY,
    ServingConfig,
    ServingElasticBackend,
    ServingProfile,
    ServingWorkload,
)
from .telemetry import (  # noqa: F401
    MigrationRecord,
    PlanStats,
    Telemetry,
    TickRecord,
    TransferMeasurement,
)
