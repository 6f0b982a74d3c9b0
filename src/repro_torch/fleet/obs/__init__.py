"""Fleet observability subsystem: tracing, metrics, SLOs, calibration.

The paper's premise is reconfiguration *during operation*, and the
foundational environment-adaptation loop includes an explicit
operation-monitoring stage — this package is that stage for the fleet
stack.  Five parts, all behavior-neutral (a run with observability
attached is fingerprint-identical to one without, and the calibration
feedback path is opt-in via ``RuntimeConfig.cost_feedback``):

  trace   — dual-clock span tracer: simulated-time spans for fleet
            semantics (migration snapshot → copy → restore phases, fleet
            events), wall-clock spans for solver work (tick phases:
            journal scan → region solves → boundary arbitration →
            commit).  Exports Chrome/Perfetto ``trace_event`` JSON via
            ``benchmarks/run.py --trace out.json``.
  metrics — deterministic registry of counters / gauges / fixed-bucket
            histograms, so p50/p90/p99 are reproducible run-to-run and
            safe to fingerprint when their inputs are simulated (wall-
            clock metric names are excluded by the telemetry layer).
  slo     — rolling-window burn-rate detectors over the satisfaction and
            migration-downtime SLOs; breaches land in telemetry as
            `SloBreach` records and feed back into `AdaptivePolicy`'s
            milp → incremental → greedy ladder (observe → act).
  calibration — predicted-vs-actual ledger: plan-time `MovePrediction`s
            joined against executor-measured outcomes into residual
            histograms, EWMA `DriftDetector`s emitting
            `CalibrationDrift` records, and the opt-in learned-bytes
            feedback into `MigrationCostModel`.
  provenance — per-move "why" records (`MoveProvenance`): objective
            delta, runner-up + margin, whether a boundary budget or the
            migration price was binding.
"""

from .calibration import (  # noqa: F401
    CALIBRATION_RATIO_BUCKETS,
    RELATIVE_ERROR_BUCKETS,
    CalibrationDrift,
    CalibrationLedger,
    DriftDetector,
    MovePrediction,
)
from .metrics import (  # noqa: F401
    DEFAULT_FRACTION_BUCKETS,
    DEFAULT_LATENCY_BUCKETS_S,
    DEFAULT_RATIO_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    fmt_ratio,
    mean_or_none,
    weighted_mean_or_none,
)
from .provenance import (  # noqa: F401
    MoveProvenance,
    provenance_from_costs,
)
from .slo import (  # noqa: F401
    BurnRateDetector,
    SloBreach,
    SloConfig,
    SloMonitor,
)
from .trace import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    Span,
    SpanTracer,
    validate_trace,
)
