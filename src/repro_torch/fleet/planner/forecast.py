"""Demand forecasting over `RateCurve` request streams.

The instantaneous tick snapshot is exactly what makes reconfiguration
reactive: by the time a diurnal peak or flash crowd shows up in the
weights, the migrations it should have triggered are already late (and now
compete with the crowd for link bandwidth).  The forecaster samples each
app's rate curve **ahead of the simulated clock** over a rolling horizon
and aggregates the samples into a per-app *forecast weight* — ``peak``
(anticipate the worst moment of the horizon, the flash-crowd setting) or
``mean`` (steady diurnal drift).

Forecast error telemetry: each forecast is kept until the next tick and
compared against the weights the runtime actually observed then —
``mean |predicted − realized| / realized`` over the apps present in both.
Under ``peak`` aggregation this measures the *anticipation gap* (how much
hotter the planner assumed the horizon than the present turned out), and
it is deterministic, so it participates in telemetry fingerprints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

AGG_PEAK = "peak"
AGG_MEAN = "mean"


@dataclasses.dataclass(frozen=True)
class Forecast:
    """One tick's prediction, kept for error scoring at the next tick."""

    t_made: float
    horizon_s: float
    predicted: Dict[int, float]


class DemandForecaster:
    """Samples rate curves over ``[now, now + horizon_s]``."""

    def __init__(self, horizon_s: float = 600.0, samples: int = 4,
                 agg: str = AGG_PEAK):
        if agg not in (AGG_PEAK, AGG_MEAN):
            raise ValueError(f"bad agg {agg!r}; want {AGG_PEAK!r}|{AGG_MEAN!r}")
        if samples < 1:
            raise ValueError("samples must be >= 1")
        self.horizon_s = horizon_s
        self.samples = samples
        self.agg = agg
        self.last: Optional[Forecast] = None
        self.last_error: Optional[float] = None
        # (predicted, realized) rate pairs behind ``last_error`` — the
        # calibration ledger's per-app forecast-drift input.
        self.last_residuals: List[Tuple[float, float]] = []

    def forecast(
        self,
        now: float,
        curves: Mapping,
        window: Sequence[int],
        weights: Optional[Mapping[int, float]] = None,
    ) -> Dict[int, float]:
        """Per-app forecast weights for ``window``.  Apps without a curve
        keep their instantaneous weight (or 1.0).  Also scores the
        previous forecast against ``weights`` (the realized rates)."""
        self.last_error = self._score(weights)
        out: Dict[int, float] = {}
        for req_id in window:
            curve = curves.get(req_id) if curves else None
            if curve is None:
                out[req_id] = float(weights.get(req_id, 1.0)) if weights else 1.0
                continue
            ts = [now + self.horizon_s * (k + 1) / self.samples
                  for k in range(self.samples)]
            vals = [curve.rate(t) for t in ts]
            out[req_id] = max(vals) if self.agg == AGG_PEAK else sum(vals) / len(vals)
        self.last = Forecast(now, self.horizon_s, dict(out))
        return out

    def _score(self, realized: Optional[Mapping[int, float]]) -> Optional[float]:
        self.last_residuals = []
        if self.last is None or not realized:
            return None
        pairs = [(pred, realized[r])
                 for r, pred in self.last.predicted.items() if r in realized]
        if not pairs:
            return None
        self.last_residuals = pairs
        errs = [abs(pred - real) / max(abs(real), 1e-9)
                for pred, real in pairs]
        return sum(errs) / len(errs)
