"""Calibration ledger: predicted-vs-actual accounting for the planner.

The reconfigurator is only as good as the estimates it plans against —
migration phase times, forecast rates, expected satisfaction gain.  The
executor *measures* all of these (the elastic bridge derives real phase
times from checkpoint bytes; the rate bank samples realized demand),
but until now nothing joined prediction to outcome.  This module is
that join:

* at commit time the runtime freezes a `MovePrediction` per scheduled
  move (predicted checkpoint mbits, snapshot/transfer/restore seconds,
  the link rate assumed, the expected satisfaction gain, and the move's
  `MoveProvenance`);
* when the executor retires the migration, `observe_record` joins the
  prediction against the `MigrationRecord` + `TransferMeasurement` pair
  and feeds per-family residual histograms in the shared
  `MetricsRegistry` (``calibration/`` and ``forecast/`` namespaces —
  excluded from fingerprints like the wall-clock families, so the
  ledger can never perturb the behavior contract);
* aborted / rolled-back / cancelled migrations are *excluded* from the
  residuals (their phase clocks stopped mid-pipeline — comparing them
  to a full-pipeline prediction would charge the model for a failure it
  never priced), counted under ``excluded`` instead;
* contention is attributed to the ledger, not the model: the measured
  bytes at the *uncontended* link rate is the model's domain
  (``calibration/transfer_err_s``); any transfer time beyond that ideal
  is fair-share contention (``calibration/contention_s``) — scheduling
  reality, not a size-model error;
* per-family EWMA `DriftDetector`s watch the predicted/actual ratio and
  emit `CalibrationDrift` records when it leaves the band — the signal
  that the cost model has gone stale for this fleet;
* measured per-app byte counts and host-phase times are *learned*
  unconditionally; with ``RuntimeConfig.cost_feedback`` on they replace
  the flat ``state_mb`` belief for the app's next prediction (and the
  `MigrationCostModel`'s pricing) — the self-correcting loop.  With it
  off the ledger only observes, and fingerprints are bit-identical.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    MetricsRegistry,
)
from .provenance import MoveProvenance

#: Predicted/actual ratio buckets, log-ish spaced around the ideal 1.0.
CALIBRATION_RATIO_BUCKETS: Tuple[float, ...] = (
    0.1, 0.2, 0.25, 0.5, 0.8, 0.9, 0.95, 1.0, 1.05, 1.1, 1.25,
    2.0, 4.0, 10.0,
)

#: Relative-error buckets (|pred − actual| / actual): fine near zero —
#: a converged model should land its mass under 5% — with a long tail
#: for the uncalibrated flat-belief regime.
RELATIVE_ERROR_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    0.75, 1.0, 2.0, 5.0,
)


@dataclasses.dataclass(frozen=True)
class MovePrediction:
    """Everything the planner quantified about one committed move, frozen
    at commit time (before any simulated transfer progress)."""

    req_id: int
    t_plan: float                  # sim time of the committing tick
    mbits: float                   # predicted checkpoint size on the wire
    snapshot_s: float              # predicted host-side serialize time
    transfer_s: float              # predicted wire time at ``rate_mbps``
    restore_s: float               # predicted mesh rebuild + restore time
    rate_mbps: float               # contended fair-share rate assumed
    uncontended_mbps: float        # path bottleneck with no sharing
    gain: float                    # expected satisfaction gain (2 − ratio)
    r_before: float                # response_s baseline the gain is against
    p_before: float                # price baseline the gain is against
    feedback: bool                 # was the learned-bytes path active?
    provenance: Optional[MoveProvenance] = None
    #: Serving apps: the migration state strategy the pricing selected
    #: ("drain" | "replay" | "kv-ship").  None — and absent from
    #: `to_dict` — for non-serving moves, keeping legacy records stable.
    strategy: Optional[str] = None

    def to_dict(self) -> dict:
        d = {
            "req_id": self.req_id,
            "t_plan": round(self.t_plan, 9),
            "mbits": round(self.mbits, 9),
            "snapshot_s": round(self.snapshot_s, 9),
            "transfer_s": round(self.transfer_s, 9),
            "restore_s": round(self.restore_s, 9),
            "rate_mbps": round(self.rate_mbps, 9),
            "uncontended_mbps": round(self.uncontended_mbps, 9),
            "gain": round(self.gain, 9),
            "feedback": self.feedback,
            "provenance": (self.provenance.to_dict()
                           if self.provenance is not None else None),
        }
        if self.strategy is not None:
            d["strategy"] = self.strategy
        return d


@dataclasses.dataclass(frozen=True)
class CalibrationDrift:
    """The EWMA predicted/actual ratio of one residual family left its
    band — the cost model's belief has systematically diverged from what
    the executor measures."""

    family: str          # "transfer_mbits" | "downtime" | "forecast_rate"
    t: float             # sim time of the triggering observation
    ewma_ratio: float    # smoothed predicted/actual at trigger time
    band: float          # fire outside [1/band, band]
    n_samples: int       # observations folded into the EWMA so far
    predicted: float     # the triggering pair, for forensics
    actual: float

    def to_dict(self) -> dict:
        return {
            "family": self.family,
            "t": round(self.t, 9),
            "ewma_ratio": round(self.ewma_ratio, 9),
            "band": round(self.band, 9),
            "n_samples": self.n_samples,
            "predicted": round(self.predicted, 9),
            "actual": round(self.actual, 9),
        }


class DriftDetector:
    """EWMA predicted/actual ratio watcher for one residual family.

    Deterministic: state is a pure function of the observation sequence
    (simulated quantities only).  A sample-count cooldown keeps one
    stale-model regime from emitting a drift per migration.
    """

    def __init__(self, family: str, band: float = 1.5, alpha: float = 0.3,
                 min_samples: int = 5, cooldown: int = 20) -> None:
        if band <= 1.0:
            raise ValueError(f"band must be > 1.0, got {band}")
        self.family = family
        self.band = float(band)
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.cooldown = int(cooldown)
        self.ewma: Optional[float] = None
        self.n = 0
        self._last_fire_n = -(10 ** 9)

    def observe(self, t: float, predicted: float,
                actual: float) -> Optional[CalibrationDrift]:
        ratio = (float(predicted) + 1e-9) / (float(actual) + 1e-9)
        self.ewma = (ratio if self.ewma is None
                     else self.alpha * ratio + (1.0 - self.alpha) * self.ewma)
        self.n += 1
        if self.n < self.min_samples:
            return None
        if 1.0 / self.band <= self.ewma <= self.band:
            return None
        if self.n - self._last_fire_n < self.cooldown:
            return None
        self._last_fire_n = self.n
        return CalibrationDrift(family=self.family, t=float(t),
                                ewma_ratio=self.ewma, band=self.band,
                                n_samples=self.n,
                                predicted=float(predicted),
                                actual=float(actual))


class CalibrationLedger:
    """Plan-time predictions joined against executor-measured outcomes.

    One ledger per `FleetRuntime`, writing into the runtime's shared
    `MetricsRegistry` under the ``calibration/`` and ``forecast/``
    namespaces.  Predictions queue FIFO per app: the executor retires
    migrations in start order per app (a new move for the same app
    cancels the in-flight one first), so the join is positional.
    Predictions whose move was dropped before the executor ever started
    it simply stay pending — reported, never joined.
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 feedback: bool = False, band: float = 1.5,
                 alpha: float = 0.3, min_samples: int = 5,
                 cooldown: int = 20) -> None:
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.feedback = bool(feedback)
        self._band = float(band)
        self._alpha = float(alpha)
        self._min_samples = int(min_samples)
        self._cooldown = int(cooldown)
        self._pending: Dict[int, Deque[MovePrediction]] = {}
        self._detectors: Dict[str, DriftDetector] = {}
        # Learned per-app measurements (always collected; only *used* for
        # prediction when ``feedback`` is on).
        self._learned_mbits: Dict[int, float] = {}
        self._learned_host: Dict[int, Tuple[float, float]] = {}
        self.samples = 0          # completed migrations joined
        self.excluded = 0         # aborted/cancelled — never residuals
        self.unmatched = 0        # records with no pending prediction
        self.contention_s_total = 0.0
        self.drifts: List[CalibrationDrift] = []
        self.provenance_records: List[MoveProvenance] = []
        self.prov_price_binding = 0
        self.prov_budget_binding = 0
        # Serving-strategy tally over predictions ("drain" / "replay" /
        # "kv-ship"); empty for fleets with no serving apps.
        self.strategy_counts: Dict[str, int] = {}

    # ------------------------------------------------------------- plan side
    def record_move(self, pred: MovePrediction) -> None:
        """Freeze one committed move's prediction (called at commit time,
        inside the tick that scheduled the transfer)."""
        self._pending.setdefault(pred.req_id, deque()).append(pred)
        self.metrics.counter("calibration/predicted").inc()
        if pred.strategy is not None:
            self.strategy_counts[pred.strategy] = \
                self.strategy_counts.get(pred.strategy, 0) + 1
        if pred.provenance is not None:
            self.provenance_records.append(pred.provenance)
            if pred.provenance.price_binding:
                self.prov_price_binding += 1
            if pred.provenance.budget_binding:
                self.prov_budget_binding += 1

    def learned_mbits(self, req_id: int) -> Optional[float]:
        """Backend-measured wire size of this app's last completed
        migration, if any (the feedback path's byte belief)."""
        return self._learned_mbits.get(req_id)

    def learned_host(self, req_id: int) -> Optional[Tuple[float, float]]:
        """Measured (snapshot_s, restore_s) host phases, if any."""
        return self._learned_host.get(req_id)

    # ---------------------------------------------------------- outcome side
    def observe_record(self, rec, meas=None):
        """Join one executor `MigrationRecord` (plus its
        `TransferMeasurement`, when the transfer got far enough to have
        one) against the app's oldest pending prediction.

        Returns ``(prediction, drifts)``; prediction is None when no
        prediction was pending (pre-runtime executor use, tests driving
        the executor directly).
        """
        q = self._pending.get(rec.req_id)
        if not q:
            self.unmatched += 1
            self.metrics.counter("calibration/unmatched").inc()
            return None, []
        pred = q.popleft()
        if not q:
            del self._pending[rec.req_id]
        if rec.outcome != "completed":
            # The pipeline stopped mid-phase (destination/link failure,
            # superseding plan): the measured clocks cover a *partial*
            # pipeline the model never priced.  Count, don't join.
            self.excluded += 1
            self.metrics.counter("calibration/excluded").inc()
            return pred, []
        self.samples += 1
        self.metrics.counter("calibration/samples").inc()
        drifts: List[CalibrationDrift] = []

        if meas is not None:
            # Learn the measured truth for this app — unconditionally, so
            # the feedback knob flips from flat to measured instantly.
            self._learned_mbits[rec.req_id] = meas.mbits
            self._learned_host[rec.req_id] = (rec.snapshot_s, rec.restore_s)
            self.metrics.histogram(
                "calibration/transfer_mbits_ratio",
                CALIBRATION_RATIO_BUCKETS,
            ).observe((pred.mbits + 1e-9) / (meas.mbits + 1e-9))
            d = self._drift("transfer_mbits", rec.t_end,
                            pred.mbits, meas.mbits)
            if d is not None:
                drifts.append(d)
            # Contention attribution: the measured bytes at the
            # *uncontended* path rate is what the size model owes; the
            # excess over that ideal is fair-share contention — the
            # ledger's to explain, not the model's.
            uncont = max(meas.uncontended_mbps, 1e-9)
            ideal_s = meas.mbits / uncont
            contention_s = max(rec.transfer_s - ideal_s, 0.0)
            self.contention_s_total += contention_s
            self.metrics.histogram(
                "calibration/contention_s", DEFAULT_LATENCY_BUCKETS_S,
            ).observe(contention_s)
            self.metrics.histogram(
                "calibration/transfer_err_s", DEFAULT_LATENCY_BUCKETS_S,
            ).observe(abs(pred.mbits / uncont - ideal_s))

        self.metrics.histogram(
            "calibration/snapshot_err_s", DEFAULT_LATENCY_BUCKETS_S,
        ).observe(abs(pred.snapshot_s - rec.snapshot_s))
        self.metrics.histogram(
            "calibration/restore_err_s", DEFAULT_LATENCY_BUCKETS_S,
        ).observe(abs(pred.restore_s - rec.restore_s))

        # Re-price the predicted downtime under the pipeline mode the
        # executor actually ran: precopy-vs-stop_and_copy selection is
        # scheduling policy, not a cost-model estimate to score.
        from ..elastic_bridge import pipeline_downtime
        pred_down = pipeline_downtime(rec.mode, pred.snapshot_s,
                                      pred.transfer_s, pred.restore_s)
        rel_err = abs(pred_down - rec.downtime_s) / max(rec.downtime_s, 1e-9)
        self.metrics.histogram(
            "calibration/downtime_rel_err", RELATIVE_ERROR_BUCKETS,
        ).observe(rel_err)
        d = self._drift("downtime", rec.t_end, pred_down, rec.downtime_s)
        if d is not None:
            drifts.append(d)
        return pred, drifts

    def observe_gain(self, t: float, predicted: float,
                     realized: float) -> None:
        """Join a move's expected satisfaction gain against the realized
        delta once the app is serving from its new node."""
        self.metrics.histogram(
            "calibration/gain_err", RELATIVE_ERROR_BUCKETS,
        ).observe(abs(predicted - realized))

    def observe_forecast(self, t: float, error: float,
                         residuals=None) -> List[CalibrationDrift]:
        """Record one tick's forecast quality: the planner's aggregate
        relative error, plus (optionally) the per-app (predicted,
        realized) rate pairs for ratio-drift detection."""
        self.metrics.histogram(
            "forecast/error", RELATIVE_ERROR_BUCKETS,
        ).observe(max(float(error), 0.0))
        drifts: List[CalibrationDrift] = []
        for pred_rate, real_rate in residuals or ():
            d = self._drift("forecast_rate", t, pred_rate, real_rate)
            if d is not None:
                drifts.append(d)
        return drifts

    # -------------------------------------------------------------- internal
    def _drift(self, family: str, t: float, predicted: float,
               actual: float) -> Optional[CalibrationDrift]:
        det = self._detectors.get(family)
        if det is None:
            det = self._detectors[family] = DriftDetector(
                family, band=self._band, alpha=self._alpha,
                min_samples=self._min_samples, cooldown=self._cooldown)
        d = det.observe(t, predicted, actual)
        if d is not None:
            self.drifts.append(d)
            self.metrics.counter("calibration/drifts").inc()
        return d

    # --------------------------------------------------------------- report
    @property
    def pending(self) -> int:
        """Predictions whose move never produced an executor record —
        dropped while waiting, or still in flight at end of run."""
        return sum(len(q) for q in self._pending.values())

    def report(self) -> Dict:
        """JSON-ready ledger summary, attached to `Telemetry.calibration`
        and dumped by ``benchmarks.run --report calibration``.
        Deterministic: two identical runs produce identical reports."""
        d = {
            "feedback": self.feedback,
            "samples": self.samples,
            "excluded": self.excluded,
            "unmatched": self.unmatched,
            "pending": self.pending,
            "learned_apps": len(self._learned_mbits),
            "contention_s_total": round(self.contention_s_total, 9),
            "drifts": [d.to_dict() for d in self.drifts],
            "provenance": {
                "moves": len(self.provenance_records),
                "price_binding": self.prov_price_binding,
                "budget_binding": self.prov_budget_binding,
                "records": [p.to_dict() for p in self.provenance_records],
            },
        }
        if self.strategy_counts:
            d["strategies"] = {k: self.strategy_counts[k]
                               for k in sorted(self.strategy_counts)}
        return d
