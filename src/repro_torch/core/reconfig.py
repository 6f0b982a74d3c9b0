"""Reconfiguration during operation — the paper's contribution (§3.3).

Every fixed number of new placements, take a window of already-running apps
(e.g. the most recent 100/200/400) and *trial-solve* their joint placement:

    minimize   S = Σ_k ( R_k^after / R_k^before + P_k^after / P_k^before )   (1)
    subject to each app's original upper bounds (2)(3)
               device & link capacities (4)(5), with non-window apps pinned.

The trial result is applied only when the satisfaction gain exceeds a
threshold (再構成の効果が高い場合のみ); accepted moves are executed through
the live-migration planner.  A per-move penalty models migration cost and
suppresses near-zero-gain moves; without it, symmetric instances have many
equal optima that churn apps between identical nodes.  The default 0.01
(1 % of one satisfaction point) reproduces the paper's "≈10 % of the window
actually moves" (fig. 5a) — see EXPERIMENTS.md §Repro for the sweep.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

from typing import Dict, Mapping

from .lp import AppVars, build_joint_milp
from .migration import MigrationStep, Move, plan_and_apply
from .placement import PlacementEngine
from .satisfaction import (
    AppSatisfaction,
    mean_moved_ratio,
    normalize_weights,
    weighted_mean_moved_ratio,
    weighted_window_sum,
    window_sum,
)
from .solver import MilpResult, solve_milp


@dataclasses.dataclass
class ReconfigResult:
    window: List[int]
    moves: List[Move]
    satisfaction: List[AppSatisfaction]  # for ALL window apps under the plan
    s_before: float                      # traffic-weighted when weights set
    s_after: float
    accepted: bool
    solver: Optional[MilpResult]
    plan_time_s: float
    migration_steps: List[MigrationStep] = dataclasses.field(default_factory=list)
    weights: Optional[Dict[int, float]] = None  # normalized (mean 1) or None
    # req_id → `fleet.obs.provenance.MoveProvenance`, one per committed
    # move: the decision's "why" (objective delta, runner-up + margin,
    # binding constraints), attached by the policy layer when available.
    provenance: Optional[Dict] = None

    @property
    def n_moved(self) -> int:
        return len(self.moves)

    @property
    def gain(self) -> float:
        return self.s_before - self.s_after

    @property
    def mean_moved_ratio(self) -> Optional[float]:
        return mean_moved_ratio(self.satisfaction)

    @property
    def mean_moved_ratio_weighted(self) -> Optional[float]:
        if self.weights is None:
            return self.mean_moved_ratio
        return weighted_mean_moved_ratio(self.satisfaction, self.weights)


class Reconfigurator:
    """Windowed joint re-placement on top of a `PlacementEngine`."""

    def __init__(
        self,
        engine: PlacementEngine,
        move_penalty: float = 0.01,
        accept_threshold: float = 0.0,
        backend: str = "auto",
        time_limit_s: float = 60.0,
        cost_model=None,
    ) -> None:
        self.engine = engine
        self.move_penalty = move_penalty
        self.accept_threshold = accept_threshold
        self.backend = backend
        self.time_limit_s = time_limit_s
        # Optional migration-aware cost model (duck-typed: must expose
        # ``penalty(old_cand, new_cand, base, request=None)``) pricing each
        # candidate move's transfer time into its MILP coefficient; the
        # request lets per-app state sizes replace the flat default.
        self.cost_model = cost_model

    # -------------------------------------------------------------- window
    def _window_app_vars(
        self, window: Sequence[int], weights: Optional[Dict[int, float]] = None
    ) -> List[AppVars]:
        out: List[AppVars] = []
        for req_id in window:
            placed = self.engine.placed[req_id]
            # Traffic weighting folds into the MILP coefficients by scaling
            # the baselines: w·(R_a/R_b + P_a/P_b) == R_a/(R_b/w) + P_a/(P_b/w).
            w = weights.get(req_id, 1.0) if weights else 1.0
            # The current placement is always a candidate (it satisfied the
            # bounds at admission and its node is online), so the MILP can
            # never be infeasible.
            #
            # `candidate_set` shares the engine's cached list + metric
            # arrays (consumers never mutate AppVars.candidates), so the
            # MILP builder skips the per-candidate attribute extraction.
            cs = self.engine.candidate_set(placed.request)
            cands = cs.cands
            pens = None
            if self.cost_model is not None:
                pens = [self.cost_model.penalty(placed.candidate, c,
                                                self.move_penalty,
                                                request=placed.request)
                        for c in cands]
            out.append(
                AppVars(
                    request=placed.request,
                    candidates=cands,
                    current_node_id=placed.candidate.node.node_id,
                    r_before=placed.response_s / w,
                    p_before=placed.price / w,
                    move_penalties=pens,
                    response_arr=cs.response_arr,
                    price_arr=cs.price_arr,
                    node_id_arr=cs.node_id_arr,
                )
            )
        return out

    def _free_capacity_excluding(self, window: Sequence[int]) -> tuple:
        """Remaining capacity with window apps lifted out (they re-place)."""
        return self.engine.free_capacity_excluding(window)

    # ---------------------------------------------------------------- plan
    def plan(
        self,
        window: Sequence[int],
        weights: Optional[Mapping[int, float]] = None,
    ) -> ReconfigResult:
        """Trial calculation (試行計算): solve eq. (1)–(5) over the window
        without touching the fleet.  ``weights`` (per-app traffic weights,
        normalized internally to mean 1) bias the objective toward
        heavily-loaded apps."""
        t0 = time.perf_counter()
        window = list(window)
        norm = normalize_weights(window, weights) if weights is not None else None
        app_vars = self._window_app_vars(window, norm)
        node_cap, link_cap = self._free_capacity_excluding(window)
        problem, index = build_joint_milp(
            app_vars, node_cap, link_cap, move_penalty=self.move_penalty
        )
        res = solve_milp(problem, backend=self.backend, time_limit_s=self.time_limit_s)
        if not res.ok:
            # Keep everything in place (current placements are feasible, so
            # this only happens on solver timeout).
            sat = [
                AppSatisfaction(r, self.engine.placed[r].response_s,
                                self.engine.placed[r].response_s,
                                self.engine.placed[r].price, self.engine.placed[r].price)
                for r in window
            ]
            return ReconfigResult(window, [], sat, 2.0 * len(window), 2.0 * len(window),
                                  False, res, time.perf_counter() - t0,
                                  weights=norm)

        choices = index.decode(res.x)
        moves: List[Move] = []
        sat: List[AppSatisfaction] = []
        for av, choice in zip(app_vars, choices):
            placed = self.engine.placed[av.request.req_id]
            cand = av.candidates[choice]
            sat.append(
                AppSatisfaction(
                    av.request.req_id,
                    r_before=placed.response_s, r_after=cand.response_s,
                    p_before=placed.price, p_after=cand.price,
                )
            )
            if cand.node.node_id != placed.candidate.node.node_id:
                ratio = cand.response_s / placed.response_s + cand.price / placed.price
                moves.append(Move(av.request.req_id, placed.candidate, cand, ratio))
        s_before = 2.0 * len(window)         # ratio of the do-nothing plan
        s_after = weighted_window_sum(sat, norm) if norm else window_sum(sat)
        accepted = (s_before - s_after) > self.accept_threshold
        return ReconfigResult(
            window, moves, sat, s_before, s_after, accepted, res,
            time.perf_counter() - t0, weights=norm,
        )

    # --------------------------------------------------------------- apply
    def apply(self, result: ReconfigResult, state_mb: float = 64.0) -> ReconfigResult:
        """Execute an accepted plan through the live-migration planner."""
        if not result.accepted or not result.moves:
            return result
        steps = plan_and_apply(self.engine, result.moves, state_mb=state_mb)
        result.migration_steps.extend(steps)
        return result

    def run(self, window: Sequence[int]) -> ReconfigResult:
        return self.apply(self.plan(window))
