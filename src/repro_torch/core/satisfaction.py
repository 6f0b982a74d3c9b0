"""User-satisfaction metric of paper eq. (1), plus traffic weighting.

Per app k the paper scores a reconfiguration by
``X + Y = R_after/R_before + P_after/P_before`` — 2.0 means "unchanged";
lower is better.  The reconfiguration objective minimizes the window sum.

The fleet runtime extends eq. (1) with *traffic weights*: each app's term
is scaled by its current request rate (normalized to mean 1 over the
window, so the do-nothing baseline stays ``2·|window|``), making
heavily-loaded apps dominate the objective.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True, slots=True)
class AppSatisfaction:
    req_id: int
    r_before: float
    r_after: float
    p_before: float
    p_after: float

    @property
    def ratio(self) -> float:
        """X + Y (eq. 1 summand).  < 2 means the user got happier."""
        return self.r_after / self.r_before + self.p_after / self.p_before

    @property
    def improved(self) -> bool:
        return self.ratio < 2.0 - 1e-12


class SatisfactionBatch(Sequence):
    """A window's satisfaction entries in struct-of-arrays form.

    Behaves exactly like the ``List[AppSatisfaction]`` it replaces (len /
    iteration / indexing lazily materialize `AppSatisfaction` rows), but
    keeps the before/after response and price vectors as numpy arrays so
    the aggregations below run as fused vector passes instead of per-app
    attribute walks — the per-tick hot path at 100k-app windows."""

    __slots__ = ("req_ids", "rb", "ra", "pb", "pa")

    def __init__(self, req_ids: Sequence[int], r_before, r_after,
                 p_before, p_after) -> None:
        self.req_ids: List[int] = list(req_ids)
        self.rb = np.asarray(r_before, dtype=np.float64)
        self.ra = np.asarray(r_after, dtype=np.float64)
        self.pb = np.asarray(p_before, dtype=np.float64)
        self.pa = np.asarray(p_after, dtype=np.float64)

    def __len__(self) -> int:
        return len(self.req_ids)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return AppSatisfaction(self.req_ids[i], float(self.rb[i]),
                               float(self.ra[i]), float(self.pb[i]),
                               float(self.pa[i]))

    def ratios(self) -> np.ndarray:
        """Vector of X+Y per app (eq. 1 summands)."""
        return self.ra / self.rb + self.pa / self.pb

    def moved_mask(self) -> np.ndarray:
        """Apps whose response or price actually changed."""
        return (self.ra != self.rb) | (self.pa != self.pb)

    def weight_vector(self, weights: Mapping[int, float]) -> np.ndarray:
        return np.fromiter((weights.get(r, 1.0) for r in self.req_ids),
                           np.float64, len(self.req_ids))


def window_sum(entries: Sequence[AppSatisfaction]) -> float:
    """S of eq. (1) over the window."""
    if isinstance(entries, SatisfactionBatch):
        return float(np.sum(entries.ratios()))
    return sum(e.ratio for e in entries)


def mean_moved_ratio(entries: Sequence[AppSatisfaction]) -> Optional[float]:
    """Paper fig. 5(b): mean X+Y over apps that actually moved.

    Returns None when nothing moved — aggregators must skip it, not fold a
    sentinel into their means."""
    if isinstance(entries, SatisfactionBatch):
        moved = entries.moved_mask()
        n = int(np.count_nonzero(moved))
        if not n:
            return None
        return float(np.sum(entries.ratios()[moved])) / n
    moved = [e for e in entries if (e.r_after, e.p_after) != (e.r_before, e.p_before)]
    if not moved:
        return None
    return sum(e.ratio for e in moved) / len(moved)


def normalize_weights(
    window: Sequence[int], weights: Optional[Mapping[int, float]]
) -> Dict[int, float]:
    """Per-app traffic weights scaled to mean 1 over ``window``.  Missing
    entries count as 1.0; non-positive weights are clamped to a tiny
    positive value (a zero-rate app still keeps a vanishing stake in the
    objective rather than a neutral one).  With the mean-1 convention
    ``Σ_k w_k·2 == 2·|window|``: the do-nothing baseline of the weighted
    objective equals the unweighted one."""
    raw = {r: max(float(weights.get(r, 1.0)), 1e-9) if weights else 1.0
           for r in window}
    total = sum(raw.values())
    if not window or total <= 0.0:
        return {r: 1.0 for r in window}
    scale = len(window) / total
    return {r: w * scale for r, w in raw.items()}


def weighted_window_sum(
    entries: Sequence[AppSatisfaction], weights: Mapping[int, float]
) -> float:
    """Traffic-weighted S of eq. (1): Σ_k w_k · (X_k + Y_k)."""
    if isinstance(entries, SatisfactionBatch):
        return float(np.dot(entries.weight_vector(weights), entries.ratios()))
    return sum(weights.get(e.req_id, 1.0) * e.ratio for e in entries)


# ------------------------------------------------------- token-level SLOs
def token_slo_ratio(p99_latency_s: float, slo_s: float) -> float:
    """Per-token latency SLO in eq.-(1) units: the response-side half of
    X+Y for a serving app, with the p99 token latency standing in for the
    response time and the SLO target for its baseline.  1.0 = exactly on
    SLO, < 1 = faster than the objective, clamped to [0, 2] so a blown SLO
    saturates at the do-nothing-was-better ceiling instead of growing
    without bound (one stuck token would otherwise dominate a window)."""
    if slo_s <= 0.0:
        return 2.0
    return min(p99_latency_s / slo_s, 2.0)


def blend_token_slo(mean_ratio: float, slo_ratio: float,
                    weight: float = 0.5) -> float:
    """Fold a serving app's token-SLO term into the window's mean-based
    X+Y aggregate: convex blend of the classic eq.-(1) ratio and the
    token-latency ratio doubled into X+Y scale (2.0 = on-SLO baseline,
    mirroring the do-nothing baseline of the mean aggregation)."""
    w = min(max(weight, 0.0), 1.0)
    return (1.0 - w) * mean_ratio + w * (2.0 * slo_ratio)


def weighted_mean_moved_ratio(
    entries: Sequence[AppSatisfaction], weights: Mapping[int, float]
) -> Optional[float]:
    """Traffic-weighted fig. 5(b): Σ w·ratio / Σ w over moved apps, or None
    when nothing moved."""
    if isinstance(entries, SatisfactionBatch):
        moved = entries.moved_mask()
        if not moved.any():
            return None
        w = entries.weight_vector(weights)[moved]
        wsum = float(np.sum(w))
        if wsum <= 0.0:
            return None
        return float(np.dot(w, entries.ratios()[moved])) / wsum
    moved = [e for e in entries if (e.r_after, e.p_after) != (e.r_before, e.p_before)]
    if not moved:
        return None
    wsum = sum(weights.get(e.req_id, 1.0) for e in moved)
    if wsum <= 0.0:
        return None
    return sum(weights.get(e.req_id, 1.0) * e.ratio for e in moved) / wsum
