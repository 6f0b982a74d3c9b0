"""Live-migration planning (paper §3.3: ライブマイグレーション等の手法を用いて
ユーザ影響を抑えて行う).

A reconfiguration solution is a set of moves.  Executing them naively can
transiently violate capacity (destination must hold the app while the source
still does, for pre-copy live migration).  The planner orders moves greedily
so every step fits, falling back to stop-and-copy (release-then-place, i.e.
brief downtime) for cyclic dependencies (e.g. two apps swapping nodes).

The same planner sequences training-job migrations in `runtime.elastic`, where a
"move" is checkpoint → re-shard → resume and the downtime estimate is the
checkpoint transfer time over the inter-pod link.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from .apps import Candidate
from .placement import CapacityError, PlacementEngine


@dataclasses.dataclass(frozen=True)
class Move:
    """One app's planned relocation: ``old`` → ``new`` candidate.

    Lifecycle under the fleet runtime (`fleet.executor.MigrationExecutor`):
    an accepted move enters the ledger **waiting**; once its destination
    fits it becomes a pre-copy `Transfer` (or stop-and-copy if the app was
    suspended to break a capacity cycle) running the elastic snapshot →
    transfer → restore pipeline; it ends **committed** at the destination,
    **aborted** with source rollback (destination/link failure), or
    **dropped** (app departed / went stale while waiting).  Under the
    synchronous `FleetScheduler` path the same move is applied instantly
    by `plan_and_apply` below."""

    req_id: int
    old: Candidate
    new: Candidate
    ratio: float  # eq. (1) summand for this app under the move


@dataclasses.dataclass(frozen=True)
class MigrationStep:
    move: Move
    mode: str               # "live" (pre-copy) | "stop_and_copy"
    est_downtime_s: float   # user-visible pause


def estimate_downtime(move: Move, state_mb: float, mode: str) -> float:
    """Crude downtime model: live migration pauses for one dirty-page round
    (~5 % of state) over the slowest link on the new path; stop-and-copy
    pauses for the full state transfer."""
    links = move.new.links or move.old.links
    bw = min((l.bandwidth_mbps for l in links), default=100.0)
    full = state_mb * 8.0 / bw
    return 0.05 * full if mode == "live" else full


def plan_and_apply(
    engine: PlacementEngine,
    moves: Sequence[Move],
    state_mb: float = 64.0,
    state_mb_by_req: Optional[Dict[int, float]] = None,
) -> List[MigrationStep]:
    """Order and execute ``moves`` on ``engine``; returns the executed plan.

    Greedy: repeatedly apply any move whose destination currently fits
    (live, pre-copy).  If none fits but moves remain, a cycle exists — break
    it by *suspending* the best pending move's app (stop-and-copy releases
    its resources, incurring downtime) and re-placing it once the cycle has
    unwound.  Raises if the solver's plan is genuinely unschedulable, which
    would indicate a capacity-accounting bug.

    ``state_mb_by_req`` overrides the flat ``state_mb`` per app for the
    downtime estimates — `fleet.executor.InstantExecutor` passes the
    elastic backend's per-app checkpoint sizes through here so downtime
    and duration are priced from the same size model.
    """
    def _mb(mv: Move) -> float:
        if state_mb_by_req is not None:
            return state_mb_by_req.get(mv.req_id, state_mb)
        return state_mb

    pending = sorted(moves, key=lambda m: m.ratio)  # best improvement first
    suspended: List[Move] = []                      # released, awaiting re-place
    steps: List[MigrationStep] = []
    while pending or suspended:
        progressed = False
        # Re-place suspended apps as capacity appears.
        for mv in list(suspended):
            app = engine.placed[mv.req_id]
            if engine.fits(app.request, mv.new):
                engine._occupy(app.request, mv.new, +1.0)
                app.candidate = mv.new
                app.response_s = mv.new.response_s
                app.price = mv.new.price
                suspended.remove(mv)
                steps.append(MigrationStep(
                    mv, "stop_and_copy",
                    estimate_downtime(mv, _mb(mv), "stop_and_copy")))
                progressed = True
        # Live-migrate whatever fits directly.
        for mv in list(pending):
            try:
                engine.apply_move(mv.req_id, mv.new)
            except CapacityError:
                continue
            pending.remove(mv)
            steps.append(MigrationStep(mv, "live",
                                       estimate_downtime(mv, _mb(mv), "live")))
            progressed = True
        if progressed:
            continue
        if pending:
            # Cycle: suspend the best pending move's app (brief downtime).
            mv = pending.pop(0)
            app = engine.placed[mv.req_id]
            engine._occupy(app.request, app.candidate, -1.0)
            suspended.append(mv)
        else:
            # Suspended apps that can never be re-placed: roll them back.
            for mv in suspended:
                app = engine.placed[mv.req_id]
                engine._occupy(app.request, app.candidate, +1.0)
            raise CapacityError(
                f"unschedulable migration plan: {[m.req_id for m in suspended]}"
            )
    return steps
