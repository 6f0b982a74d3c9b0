"""SLO burn-rate monitoring over simulated-time telemetry.

The paper's loop is observe → decide → relocate; this module is the
*decide* trigger.  Two service-level objectives are watched:

* **satisfaction** — the weighted mean X+Y ratio per tick (2.0 is the
  do-nothing baseline, lower is better).  Error accrues whenever a tick
  lands above the objective.
* **migration downtime** — seconds of per-job unavailability spent in
  completed migrations.  Error is the downtime itself, budgeted as a
  fraction of the rolling window (a 0.5% budget over 2000 s allows 10 s
  of downtime before burning hot).

Each objective gets a `BurnRateDetector`: a rolling window of
``(t, error)`` samples in simulated time.  The *burn rate* is the
windowed error divided by the window's budget — burn 1.0 means "exactly
on budget"; sustained burn above 1.0 exhausts the error budget early,
and the detector emits an `SloBreach` (rate-limited by a cooldown so a
single bad stretch yields one actionable record, not one per tick).

Breaches are deterministic: they depend only on simulated quantities, so
they are recorded in `Telemetry` *inside* the fingerprint, and the
runtime forwards them to the policy's ``on_slo_breach`` hook —
`AdaptivePolicy` reacts by escalating one tier toward exact planning
(greedy → incremental → milp), closing the observe → act loop.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SloBreach:
    """One budget-exhaustion event, in simulated time."""

    slo: str            # "satisfaction" | "migration_downtime"
    t: float            # sim time of the breaching observation
    burn_rate: float    # windowed error / windowed budget (> 1.0)
    window_error: float  # error accumulated inside the window
    budget: float       # the window's error budget
    window_s: float     # rolling window length

    def to_dict(self) -> dict:
        return {
            "slo": self.slo,
            "t": round(self.t, 9),
            "burn_rate": round(self.burn_rate, 9),
            "window_error": round(self.window_error, 9),
            "budget": round(self.budget, 9),
            "window_s": round(self.window_s, 9),
        }


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Objectives and budgets.  Defaults are calibrated so healthy
    steady-state runs stay quiet while outage scenarios genuinely burn:
    satisfaction error accrues above 1.98 (within the paper's steady
    band), and 1% of the window may be migration downtime."""

    satisfaction_objective: float = 1.98
    satisfaction_window_s: float = 2000.0
    #: Budget: mean windowed excess-over-objective that is tolerable,
    #: expressed per sample (a window of N ticks gets N× this budget).
    satisfaction_budget_per_tick: float = 0.02
    downtime_window_s: float = 2000.0
    #: Fraction of the window allowed to be migration downtime.
    downtime_budget_frac: float = 0.01
    #: Minimum sim-seconds between breaches of the same SLO.
    cooldown_s: float = 600.0


class BurnRateDetector:
    """Rolling-window error-budget accountant for one SLO."""

    def __init__(self, slo: str, window_s: float, budget_per_sample: float,
                 cooldown_s: float = 0.0,
                 budget_fixed: Optional[float] = None) -> None:
        self.slo = slo
        self.window_s = float(window_s)
        self.budget_per_sample = float(budget_per_sample)
        self.budget_fixed = budget_fixed
        self.cooldown_s = float(cooldown_s)
        self._samples: Deque[Tuple[float, float]] = deque()
        self._window_error = 0.0
        self._last_breach_t: Optional[float] = None
        self.breaches = 0

    def _budget(self) -> float:
        if self.budget_fixed is not None:
            return self.budget_fixed
        return self.budget_per_sample * max(len(self._samples), 1)

    @property
    def burn_rate(self) -> float:
        budget = self._budget()
        return self._window_error / budget if budget > 0 else 0.0

    def observe(self, t: float, error: float) -> Optional[SloBreach]:
        """Record one error sample at sim time ``t``; returns a breach
        when the windowed burn rate exceeds 1.0 outside the cooldown."""
        t = float(t)
        error = max(float(error), 0.0)
        self._samples.append((t, error))
        self._window_error += error
        cutoff = t - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            _, old = self._samples.popleft()
            self._window_error -= old
        if self._window_error < 0.0:   # float-drift guard
            self._window_error = 0.0
        burn = self.burn_rate
        if burn <= 1.0:
            return None
        if (self._last_breach_t is not None
                and t - self._last_breach_t < self.cooldown_s):
            return None
        self._last_breach_t = t
        self.breaches += 1
        return SloBreach(slo=self.slo, t=t, burn_rate=burn,
                         window_error=self._window_error,
                         budget=self._budget(), window_s=self.window_s)


class SloMonitor:
    """Both fleet SLOs behind one observe interface.

    The runtime calls `observe_tick` after every planning tick with the
    tick's weighted mean satisfaction, and `observe_migration` for every
    migration the executor completes.  Returned breaches are appended to
    telemetry and forwarded to the policy.
    """

    def __init__(self, config: Optional[SloConfig] = None) -> None:
        self.config = config or SloConfig()
        c = self.config
        self.satisfaction = BurnRateDetector(
            "satisfaction", c.satisfaction_window_s,
            c.satisfaction_budget_per_tick, c.cooldown_s)
        self.downtime = BurnRateDetector(
            "migration_downtime", c.downtime_window_s, 0.0, c.cooldown_s,
            budget_fixed=c.downtime_window_s * c.downtime_budget_frac)

    def observe_tick(self, t: float,
                     mean_satisfaction: Optional[float]) -> List[SloBreach]:
        if mean_satisfaction is None:
            return []
        err = mean_satisfaction - self.config.satisfaction_objective
        breach = self.satisfaction.observe(t, err)
        return [breach] if breach else []

    def observe_migration(self, t: float, downtime_s: float) -> List[SloBreach]:
        breach = self.downtime.observe(t, downtime_s)
        return [breach] if breach else []
