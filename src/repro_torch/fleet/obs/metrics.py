"""Deterministic metrics: counters, gauges, fixed-bucket histograms.

The fleet's benchmark rows need percentiles (per-tick satisfaction,
solver latency, migration downtime), and percentiles computed naively
from raw float streams are fragile — a re-ordered reduction or a dropped
sample shifts p99 and breaks run-to-run comparability.  Here every
histogram has a *fixed* bucket layout declared up front, observations
are binned by ``bisect`` against the upper edges, and percentiles are
interpolated inside the bucket from integer cumulative counts — a pure
function of the multiset of observations, independent of arrival order.
That makes simulated-quantity percentiles fingerprint-safe; wall-clock
histograms (solver latency) use the same machinery but are excluded from
fingerprints by name (`fleet.telemetry.WALL_CLOCK_METRIC_PREFIXES`).

This module also owns the small aggregation helpers (`mean_or_none`,
`weighted_mean_or_none`, `fmt_ratio`) that `fleet/telemetry.py` and
`benchmarks/bench_fleet.py` used to duplicate.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Satisfaction-ratio buckets (the X+Y quantity: 2.0 = do-nothing
#: baseline, lower is better).  Fine resolution around the paper's
#: steady-state band [1.8, 2.1].
DEFAULT_RATIO_BUCKETS: Tuple[float, ...] = (
    0.5, 1.0, 1.2, 1.4, 1.6, 1.7, 1.8, 1.85, 1.9, 1.925, 1.95, 1.975,
    2.0, 2.025, 2.05, 2.1, 2.2, 2.5, 3.0, 4.0,
)

#: Log-spaced 1-2-5 latency/duration buckets, 100 µs … 60 s.
DEFAULT_LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2,
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0,
)

#: Fractional buckets (utilization, hit rates): 0 … 1 in 5% steps.
DEFAULT_FRACTION_BUCKETS: Tuple[float, ...] = tuple(
    round(0.05 * i, 2) for i in range(1, 21))


# ------------------------------------------------------------ aggregation
def mean_or_none(values: Iterable[float]) -> Optional[float]:
    """Mean of ``values``; None (JSON null) when empty — no magic
    sentinel leaking into benchmark aggregates."""
    vals = list(values)
    return sum(vals) / len(vals) if vals else None


def weighted_mean_or_none(
    pairs: Iterable[Tuple[float, Optional[float]]],
) -> Optional[float]:
    """Weight-averaged mean over ``(weight, value)`` pairs, skipping
    None values and zero weights; None when nothing contributes."""
    acc = w_total = 0.0
    for w, v in pairs:
        if not w or v is None:
            continue
        acc += w * v
        w_total += w
    return acc / w_total if w_total else None


def fmt_ratio(v: Optional[float]) -> str:
    """Benchmark-row formatting of a possibly-missing ratio."""
    return f"{v:.4f}" if v is not None else "nan"


# --------------------------------------------------------------- metrics
@dataclasses.dataclass
class Counter:
    """Monotonic event counter."""

    value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> int:
        return self.value


@dataclasses.dataclass
class Gauge:
    """Last-write-wins instantaneous value."""

    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket histogram with deterministic percentiles.

    ``buckets`` are the upper edges of the finite buckets (ascending);
    one implicit overflow bucket catches everything beyond the last
    edge.  ``percentile(q)`` walks the integer cumulative counts to the
    bucket containing the q-quantile and interpolates linearly between
    the bucket's edges — overflow observations report the last finite
    edge (clamped, never invented), so every reported percentile is a
    function of the declared layout plus integer counts only.
    """

    def __init__(self, buckets: Sequence[float] = DEFAULT_RATIO_BUCKETS):
        uppers = tuple(float(b) for b in buckets)
        if list(uppers) != sorted(set(uppers)):
            raise ValueError("histogram buckets must be strictly ascending")
        if not uppers:
            raise ValueError("histogram needs at least one bucket edge")
        self.uppers = uppers
        self.counts = [0] * (len(uppers) + 1)   # + overflow
        self.count = 0
        self.total = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.uppers, v)] += 1
        self.count += 1
        self.total += v
        self._min = v if self._min is None else min(self._min, v)
        self._max = v if self._max is None else max(self._max, v)

    def observe_many(self, values) -> None:
        """Vectorized bulk ``observe``: bins a whole array in one
        searchsorted/bincount pass.  Identical end state to calling
        ``observe`` per element (same bisect_left edge semantics, and the
        running sum is accumulated in the same left-to-right order so the
        float total is bit-identical) — the serving workload feeds entire
        token-latency segments through here."""
        import numpy as np

        arr = np.asarray(values, dtype=np.float64)
        if arr.size == 0:
            return
        idx = np.searchsorted(self.uppers, arr, side="left")
        for i, n in enumerate(np.bincount(idx, minlength=len(self.counts))):
            self.counts[i] += int(n)
        self.count += arr.size
        # math.fsum-free left-to-right accumulation == repeated observe().
        total = self.total
        for v in arr.tolist():
            total += v
        self.total = total
        lo, hi = float(arr.min()), float(arr.max())
        self._min = lo if self._min is None else min(self._min, lo)
        self._max = hi if self._max is None else max(self._max, hi)

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Deterministic q-quantile (0 < q ≤ 1) from the bucket layout."""
        if not self.count:
            return None
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile out of range: {q}")
        rank = q * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if not n:
                continue
            prev_cum = cum
            cum += n
            if cum >= rank:
                if i >= len(self.uppers):      # overflow bucket: clamp
                    return self.uppers[-1]
                lo = self.uppers[i - 1] if i else min(
                    self.uppers[0], self._min if self._min is not None else 0.0)
                hi = self.uppers[i]
                return lo + (hi - lo) * (rank - prev_cum) / n
        return self.uppers[-1]   # unreachable; defensive

    def snapshot(self) -> Dict:
        rnd = lambda v: None if v is None else round(v, 9)
        return {
            "count": self.count,
            "sum": rnd(self.total),
            "min": rnd(self._min),
            "max": rnd(self._max),
            "mean": rnd(self.mean),
            "p50": rnd(self.percentile(0.50)),
            "p90": rnd(self.percentile(0.90)),
            "p99": rnd(self.percentile(0.99)),
        }


class MetricsRegistry:
    """Name → metric map with get-or-create accessors.

    Metric names are slash-namespaced (``tick/satisfaction``,
    ``solver/latency_s``, ``migration/downtime_s``, ``link/utilization``,
    ``planner/warm_start_hits`` …); the telemetry layer excludes whole
    namespaces from fingerprints by prefix, so a new wall-clock metric
    registered under ``solver/`` or ``planner/`` can never leak
    nondeterminism into the determinism contract.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_RATIO_BUCKETS) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(buckets)
        elif not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, not Histogram")
        return m

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, not {cls.__name__}")
        return m

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready view: counters/gauges as scalars, histograms as
        their summary dicts, keys sorted for stable serialization."""
        return {name: self._metrics[name].snapshot() for name in self.names()}
