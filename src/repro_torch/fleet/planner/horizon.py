"""Rolling-horizon reconfiguration: plan against forecast demand.

Wraps any registered policy (default: the decomposed planner, so scale
and anticipation compose) and swaps the runtime's instantaneous traffic
weights for the forecaster's horizon aggregate before delegating.  A
diurnal swing or scheduled flash crowd inside the horizon inflates the
affected apps' weights *now*, so the planner starts the migrations before
the peak instead of discovering it mid-crowd — when the transfers would
compete with the very traffic they were meant to serve.

The runtime feeds the policy through `observe(now, curves, executor)`
before each plan; without it (plain `plan()` calls, e.g. the conformance
tests) there are no curves and the wrapper degrades to the inner policy
with pass-through weights.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from repro_torch.core.placement import PlacementEngine
from repro_torch.core.reconfig import ReconfigResult
from repro_torch.core.satisfaction import normalize_weights, weighted_window_sum

from ..policies import ReconfigPolicy
from ..telemetry import PlanStats
from .forecast import DemandForecaster


class HorizonPolicy(ReconfigPolicy):
    """Forecast-weighted wrapper around an inner reconfiguration policy."""

    name = "horizon"

    def __init__(self, move_penalty: float = 0.01, accept_threshold: float = 0.0,
                 cost_model=None, inner: str = "decomposed",
                 horizon_s: float = 600.0, samples: int = 4, agg: str = "peak",
                 **inner_kwargs):
        super().__init__(move_penalty, accept_threshold, cost_model)
        from ..policies import get_policy  # late: avoids import cycle
        self.inner = get_policy(inner, move_penalty=move_penalty,
                                accept_threshold=accept_threshold,
                                cost_model=cost_model, **inner_kwargs)
        self.forecaster = DemandForecaster(horizon_s=horizon_s,
                                           samples=samples, agg=agg)
        self._now = 0.0
        self._curves: dict = {}

    def observe(self, now: float = 0.0, curves: Optional[Mapping] = None,
                executor=None) -> None:
        super().observe(now=now, curves=curves, executor=executor)
        self._now = now
        self._curves = dict(curves) if curves else {}
        self.inner.observe(now=now, curves=curves, executor=executor)

    def bind_tracer(self, tracer) -> None:
        super().bind_tracer(tracer)
        self.inner.bind_tracer(tracer)

    def plan(self, engine: PlacementEngine, window: Sequence[int],
             weights: Optional[Mapping[int, float]] = None) -> ReconfigResult:
        realized = (dict(weights) if weights is not None
                    else {r: 1.0 for r in window})
        forecast = self.forecaster.forecast(self._now, self._curves,
                                            window, realized)
        res = self.inner.plan(engine, window, weights=forecast)
        # The forecast drives the *objective* (and the accept decision —
        # anticipatory acceptance is the point); reported quantities must
        # stay comparable with every other policy's rows, so re-express
        # the result — weights, s_after, and therefore gain — in realized
        # traffic units.
        res.weights = normalize_weights(window, realized)
        res.s_after = weighted_window_sum(res.satisfaction, res.weights)
        stats = getattr(self.inner, "last_plan_stats", None) or PlanStats()
        self.last_plan_stats = dataclasses.replace(
            stats, forecast_error=self.forecaster.last_error)
        return res
