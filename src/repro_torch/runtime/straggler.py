"""Straggler detection & mitigation.
(The port's own copy of `repro.runtime.straggler`, which imports no JAX:
the port imports nothing of `repro`.)

Synchronous data parallelism runs at the speed of the slowest host.  The
detector keeps per-host EWMA step times and flags hosts slower than
``threshold ×`` the fleet median.  Mitigations, in escalation order:

  1. **rebalance** — shift input shards away from the slow host (its
     per-step work shrinks; total global batch unchanged).  Undone if the
     host recovers.
  2. **exclude**  — treat the host as failed → elastic rescale; the LP
     scheduler sees the capacity change at the next reconfiguration window.

Pure logic + injectable timings: fully unit-testable without hardware.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

MITIGATE_NONE = "none"
MITIGATE_REBALANCE = "rebalance"
MITIGATE_EXCLUDE = "exclude"


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.3
    slow_threshold: float = 1.5      # × fleet median
    rebalance_after: int = 3         # consecutive slow polls
    exclude_after: int = 10
    min_share: float = 0.25          # floor on a host's batch share


class StragglerDetector:
    def __init__(self, hosts: List[str], cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self.hosts = list(hosts)
        self.ewma: Dict[str, float] = {}
        self.slow_streak: Dict[str, int] = {h: 0 for h in hosts}
        self.shares: Dict[str, float] = {h: 1.0 for h in hosts}

    def record(self, host: str, step_time_s: float) -> None:
        prev = self.ewma.get(host)
        a = self.cfg.ewma_alpha
        self.ewma[host] = step_time_s if prev is None else a * step_time_s + (1 - a) * prev

    def poll(self) -> Dict[str, str]:
        """Returns {host: mitigation} for hosts needing action this poll."""
        if len(self.ewma) < len(self.hosts):
            return {}
        med = float(np.median(list(self.ewma.values())))
        actions: Dict[str, str] = {}
        for h in self.hosts:
            if self.shares[h] == 0.0:
                continue  # already excluded
            slow = self.ewma[h] > self.cfg.slow_threshold * med
            self.slow_streak[h] = self.slow_streak[h] + 1 if slow else 0
            streak = self.slow_streak[h]
            if streak >= self.cfg.exclude_after:
                self.shares[h] = 0.0
                actions[h] = MITIGATE_EXCLUDE
            elif streak >= self.cfg.rebalance_after:
                # Shrink the slow host's share proportionally to its lag.
                factor = med / self.ewma[h]
                self.shares[h] = max(self.cfg.min_share, self.shares[h] * factor)
                actions[h] = MITIGATE_REBALANCE
            elif not slow and self.shares[h] < 1.0:
                self.shares[h] = min(1.0, self.shares[h] * 1.25)  # recover
        return actions

    def batch_split(self, global_batch: int) -> Dict[str, int]:
        """Integer per-host batch sizes ∝ shares (sums to global_batch)."""
        active = {h: s for h, s in self.shares.items() if s > 0}
        total = sum(active.values())
        raw = {h: global_batch * s / total for h, s in active.items()}
        out = {h: int(np.floor(r)) for h, r in raw.items()}
        rem = global_batch - sum(out.values())
        for h in sorted(active, key=lambda h: raw[h] - out[h], reverse=True)[:rem]:
            out[h] += 1
        return out
