"""Decision provenance: the compact "why" behind every committed move.

The planner's answer to "why did app 17 move to gpu-3?" is buried in a
cost vector that is gone by the time anyone asks.  This module freezes
the relevant slice of that vector at plan time into a `MoveProvenance`
record per committed move: how much cheaper the chosen candidate was
than staying put, who the runner-up was and by what margin, and whether
the decision was *shaped* by a constraint rather than by raw cost —
either a capacity/boundary budget (a strictly cheaper candidate existed
but was not chosen) or the migration price (the unpenalized optimum
lives on a different node than the penalized one).

Records ride on `ReconfigResult.provenance`, land in the calibration
ledger (`obs.calibration`), are exported as Perfetto span args on each
migration's ``migrate`` span, and are dumpable via
``benchmarks.run --report calibration``.

The compute helper is duck-typed over plain sequences/arrays so the
policies can call it without this module importing them back (no
import cycle).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoveProvenance:
    """Why one committed move was chosen, frozen at plan time."""

    req_id: int
    node_from: str
    node_to: str
    #: cost(stay) − cost(chosen) under the planner's penalized objective;
    #: positive whenever the move improves on doing nothing.
    objective_delta: float
    #: Best alternative candidate on a *different* node than the chosen
    #: one (None when the chosen node hosts every candidate).
    runner_up: Optional[str]
    #: runner-up cost − chosen cost (≥ 0 when the chosen was optimal;
    #: 0.0 when there is no runner-up).
    margin: float
    #: The migration price was decisive: without move penalties the
    #: optimum lands on a different node than the one chosen.
    price_binding: bool
    #: A budget/capacity constraint was decisive: a strictly cheaper
    #: candidate existed in the penalized cost vector but was not chosen
    #: (regional boundary budget, shadow-ledger fit, or MILP capacity).
    budget_binding: bool
    #: Serving apps: the migration state strategy the pricing selected
    #: ("drain" | "replay" | "kv-ship").  None — and absent from
    #: `to_dict` — for non-serving moves, keeping legacy records stable.
    strategy: Optional[str] = None

    def to_dict(self) -> dict:
        d = {
            "req_id": self.req_id,
            "node_from": self.node_from,
            "node_to": self.node_to,
            "objective_delta": round(self.objective_delta, 9),
            "runner_up": self.runner_up,
            "margin": round(self.margin, 9),
            "price_binding": self.price_binding,
            "budget_binding": self.budget_binding,
        }
        if self.strategy is not None:
            d["strategy"] = self.strategy
        return d


def provenance_from_costs(
    req_id: int,
    node_ids: Sequence[str],
    costs: Sequence[float],
    raw_costs: Sequence[float],
    chosen_idx: int,
    current_idx: int,
) -> MoveProvenance:
    """Freeze one move's provenance from the planner's cost vectors.

    ``costs`` is the penalized objective per candidate (satisfaction
    ratio + migration penalty — exactly what the policies minimize);
    ``raw_costs`` is the same vector without move penalties.  Ties and
    argmins are resolved toward the lowest candidate index so the record
    is deterministic for a given plan.
    """
    chosen = int(chosen_idx)
    cur = int(current_idx)
    node_to = str(node_ids[chosen])
    c_chosen = float(costs[chosen])

    runner_up: Optional[str] = None
    margin = 0.0
    best_alt = None
    raw_best = 0
    cheaper_exists = False
    for j in range(len(node_ids)):
        cj = float(costs[j])
        if float(raw_costs[j]) < float(raw_costs[raw_best]) - 1e-12:
            raw_best = j
        if j != chosen and cj < c_chosen - 1e-12:
            cheaper_exists = True
        if str(node_ids[j]) != node_to and (best_alt is None
                                            or cj < best_alt[0] - 1e-12):
            best_alt = (cj, j)
    if best_alt is not None:
        runner_up = str(node_ids[best_alt[1]])
        margin = best_alt[0] - c_chosen

    budget_binding = cheaper_exists
    price_binding = (not budget_binding
                     and str(node_ids[raw_best]) != node_to)
    return MoveProvenance(
        req_id=req_id,
        node_from=str(node_ids[cur]),
        node_to=node_to,
        objective_delta=float(costs[cur]) - c_chosen,
        runner_up=runner_up,
        margin=margin,
        price_binding=price_binding,
        budget_binding=budget_binding,
    )
