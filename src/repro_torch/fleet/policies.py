"""Pluggable reconfiguration policies behind one interface.

The paper solves the window re-placement exactly (MILP, eqs. 1–5).  To
benchmark that choice head-to-head, every optimizer in the repo is exposed
through the same contract:

    policy.plan(engine, window, weights=None) -> ReconfigResult  # trial only

* ``milp``       — the paper's joint MILP (`core.reconfig.Reconfigurator`)
* ``greedy``     — one pass, each app takes its best feasible candidate
* ``hillclimb``  — steepest-descent single-app moves until a local optimum
* ``ga``         — `core.ga.GeneticSearch` over per-app candidate genes
* ``decomposed`` — partition → per-region MILPs → boundary arbitration →
                   merge (`fleet.planner.decomposed`; scales to big fleets)
* ``incremental``— decomposed + change-journal dirty-region tracking: clean
                   regions reuse their cached plan, dirty ones re-solve with
                   the previous assignment as a warm start
* ``horizon``    — rolling-horizon wrapper: plans against forecast demand
                   sampled from each app's `RateCurve` (`fleet.planner.horizon`)
* ``adaptive``   — solver governor over a MILP → incremental → greedy ladder,
                   escalating when the rolling solver latency blows a budget
* ``noop``       — never moves anything (control baseline)

``weights`` are per-app traffic weights (requests/s multipliers from the
request-stream model); they are normalized to mean 1 over the window so
heavily-loaded apps dominate the objective while the do-nothing baseline
stays ``2·|window|``.

Contract (checked by the conformance tests): ``plan`` must NOT mutate the
engine; the result's moves must start from the app's live candidate, must
jointly fit the capacity pool `engine.free_capacity_excluding(window)`,
``satisfaction`` covers every window app, and ``s_before == 2·|window|``.
Executing an accepted plan is the migration executor's job
(`fleet.executor`), not the policy's.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence, Type

import numpy as np

from repro_torch.core.apps import AppProfile, Candidate
from repro_torch.core.ga import GaConfig, GeneticSearch
from repro_torch.core.migration import Move
from repro_torch.core.placement import PlacedApp, PlacementEngine
from repro_torch.core.reconfig import ReconfigResult, Reconfigurator
from repro_torch.core.satisfaction import (
    AppSatisfaction,
    SatisfactionBatch,
    normalize_weights,
)

from .obs.trace import NULL_TRACER


# ------------------------------------------------------------------ helpers
@dataclasses.dataclass(slots=True)
class _WindowApp:
    placed: PlacedApp
    candidates: List[Candidate]
    current_idx: int
    # Pre-extracted per-candidate metric arrays (engine `CandidateSet`);
    # None only on the defensive re-enumeration path.
    response_arr: Optional[np.ndarray] = None
    price_arr: Optional[np.ndarray] = None
    node_id_arr: Optional[np.ndarray] = None
    cset: Optional[object] = None   # the engine CandidateSet (mask cache)

    def metric_arrays(self):
        """(response, price, node_id) arrays, built lazily when the fast
        path could not supply them."""
        if self.response_arr is None:
            k = len(self.candidates)
            self.response_arr = np.fromiter(
                (c.response_s for c in self.candidates), np.float64, k)
            self.price_arr = np.fromiter(
                (c.price for c in self.candidates), np.float64, k)
            self.node_id_arr = np.array(
                [c.node.node_id for c in self.candidates])
        return self.response_arr, self.price_arr, self.node_id_arr


class _Shadow:
    """Scratch capacity pool for trial moves (never touches the engine)."""

    def __init__(self, node_cap: Dict[str, float], link_cap: Dict[str, float]):
        self.node = dict(node_cap)
        self.link = dict(link_cap)

    def occupy(self, app: AppProfile, cand: Candidate, sign: float) -> None:
        self.node[cand.node.node_id] -= sign * app.device_usage
        for l in cand.links:
            self.link[l.link_id] -= sign * app.bandwidth_mbps

    def fits(self, app: AppProfile, cand: Candidate) -> bool:
        if self.node[cand.node.node_id] < app.device_usage - 1e-9:
            return False
        return all(self.link[l.link_id] >= app.bandwidth_mbps - 1e-9
                   for l in cand.links)


@dataclasses.dataclass(slots=True)
class _WindowBatch:
    """Fused per-window context: the `_WindowApp` list plus concatenated
    candidate-metric arrays (cost vectors are views into ``costs_all``-style
    storage).  The optional arrays are None under a cost model (per-app
    fallback path) — `_result_from_batch` then degrades to the loop form."""

    ctx: List[_WindowApp]
    costv: List[np.ndarray]
    movers: List[bool]
    offs: Optional[np.ndarray] = None       # block offsets into *_all
    resp_all: Optional[np.ndarray] = None
    price_all: Optional[np.ndarray] = None
    rb: Optional[np.ndarray] = None         # per-app response/price baselines
    pb: Optional[np.ndarray] = None
    w: Optional[np.ndarray] = None          # normalized traffic weights
    cur_idx: Optional[np.ndarray] = None


def _result_from_batch(
    window: Sequence[int],
    batch: _WindowBatch,
    assignment: Sequence[int],
    accept_threshold: float,
    t0: float,
    weights: Optional[Dict[int, float]] = None,
) -> ReconfigResult:
    """Vectorized `_result_from_assignment` over the fused window arrays."""
    ctx = batch.ctx
    if batch.offs is None or not ctx:
        return _result_from_assignment(window, ctx, assignment,
                                       accept_threshold, t0, weights)
    choice = np.asarray(assignment, dtype=np.int64)
    flat = batch.offs + choice
    ra = batch.resp_all[flat]
    pa = batch.price_all[flat]
    ratio = ra / batch.rb + pa / batch.pb
    s_after = float((batch.w * ratio).sum()) if weights is not None \
        else float(ratio.sum())
    sat = SatisfactionBatch(window, batch.rb, ra, batch.pb, pa)
    moves: List[Move] = []
    for i in np.nonzero(choice != batch.cur_idx)[0]:
        wa = ctx[i]
        cand = wa.candidates[assignment[i]]
        if cand.node.node_id != wa.placed.candidate.node.node_id:
            moves.append(Move(wa.placed.request.req_id, wa.placed.candidate,
                              cand, float(ratio[i])))
    s_before = 2.0 * len(ctx)   # normalized weights keep the baseline here
    accepted = bool(moves) and (s_before - s_after) > accept_threshold
    return ReconfigResult(list(window), moves, sat, s_before, s_after,
                          accepted, None, time.perf_counter() - t0,
                          weights=weights)


def _resolve_window_app(engine: PlacementEngine, placed: PlacedApp) -> _WindowApp:
    """One window app's context: the engine's cached candidate set with the
    live candidate located in it — or, defensively, prepended to a fresh
    copy when it no longer re-enumerates (then ``current_idx == 0`` and the
    metric arrays rebuild lazily)."""
    cs = engine.candidate_set(placed.request)
    cur = cs.index_of.get(placed.candidate.node.node_id, -1)
    if cur >= 0 and (cs.cands[cur] is placed.candidate
                     or cs.cands[cur] == placed.candidate):
        return _WindowApp(placed, cs.cands, cur, cs.response_arr,
                          cs.price_arr, cs.node_id_arr, cs)
    return _WindowApp(placed, [placed.candidate] + list(cs.cands), 0)


def _window_context(engine: PlacementEngine, window: Sequence[int]) -> List[_WindowApp]:
    return [_resolve_window_app(engine, engine.placed[r]) for r in window]


def _ratio(placed: PlacedApp, cand: Candidate) -> float:
    return cand.response_s / placed.response_s + cand.price / placed.price


def _result_from_assignment(
    window: Sequence[int],
    ctx: List[_WindowApp],
    assignment: Sequence[int],
    accept_threshold: float,
    t0: float,
    weights: Optional[Dict[int, float]] = None,
) -> ReconfigResult:
    moves: List[Move] = []
    sat: List[AppSatisfaction] = []
    s_after = 0.0
    for wa, choice in zip(ctx, assignment):
        cand = wa.candidates[choice]
        placed = wa.placed
        rb, pb = placed.response_s, placed.price
        ra, pa = cand.response_s, cand.price
        ratio = ra / rb + pa / pb
        req_id = placed.request.req_id
        sat.append(AppSatisfaction(req_id, rb, ra, pb, pa))
        s_after += weights[req_id] * ratio if weights else ratio
        if choice != wa.current_idx \
                and cand.node.node_id != placed.candidate.node.node_id:
            moves.append(Move(req_id, placed.candidate, cand, ratio))
    s_before = 2.0 * len(ctx)   # normalized weights keep the baseline here
    accepted = bool(moves) and (s_before - s_after) > accept_threshold
    return ReconfigResult(list(window), moves, sat, s_before, s_after,
                          accepted, None, time.perf_counter() - t0,
                          weights=weights)


# ------------------------------------------------------------------- policies
class ReconfigPolicy:
    """Interface: trial-solve the joint re-placement of ``window``."""

    name: str = "base"

    def __init__(self, move_penalty: float = 0.01, accept_threshold: float = 0.0,
                 cost_model=None):
        self.move_penalty = move_penalty
        self.accept_threshold = accept_threshold
        # Optional migration-aware cost model (`fleet.planner.migration_cost`)
        # pricing each candidate move's transfer time — ledger contention
        # included — into the per-move penalty.
        self.cost_model = cost_model
        # Planner-side tick detail (`telemetry.PlanStats`), set by the
        # decomposed / horizon planners; the runtime copies it onto the tick.
        self.last_plan_stats = None
        # Span tracer (`obs.trace`); the runtime binds its own via
        # `bind_tracer`.  Strictly observational — never gates a branch.
        self.tracer = NULL_TRACER

    def bind_tracer(self, tracer) -> None:
        """Attach a span tracer.  Wrapper policies forward to their inner
        policies so planner-internal phases land on the same timeline."""
        self.tracer = tracer

    def observe(self, now: float = 0.0, curves: Optional[Mapping] = None,
                executor=None) -> None:
        """Runtime context hook, called before each `plan`: the simulated
        clock, the live `RateCurve` registry, and the migration executor's
        reservation ledger.  Policies that don't care ignore it."""
        if self.cost_model is not None and executor is not None:
            self.cost_model.bind(executor)

    def plan(
        self,
        engine: PlacementEngine,
        window: Sequence[int],
        weights: Optional[Mapping[int, float]] = None,
    ) -> ReconfigResult:
        raise NotImplementedError

    def _move_penalty(self, wa: _WindowApp, cand: Candidate) -> float:
        """Penalty for assigning ``cand`` (0 when it is the live node)."""
        if cand.node.node_id == wa.placed.candidate.node.node_id:
            return 0.0
        if self.cost_model is None:
            return self.move_penalty
        return self.cost_model.penalty(wa.placed.candidate, cand,
                                       self.move_penalty,
                                       request=wa.placed.request)

    def _cost(self, wa: _WindowApp, choice: int, w: float = 1.0) -> float:
        """Traffic-weighted eq. (1) summand + migration penalty relative to
        the LIVE node (the penalty is per *move*, so it stays unweighted —
        matching the MILP encoding)."""
        cand = wa.candidates[choice]
        return w * _ratio(wa.placed, cand) + self._move_penalty(wa, cand)

    def _moved_mask(self, wa: _WindowApp) -> np.ndarray:
        """Candidates NOT on the live node (cache-backed when possible)."""
        cur = wa.placed.candidate.node.node_id
        if wa.cset is not None:
            return wa.cset.moved_mask(cur)
        _, _, nodes = wa.metric_arrays()
        return nodes != cur

    def _cost_vector(self, wa: _WindowApp, w: float = 1.0) -> np.ndarray:
        """`_cost` over every candidate at once (hot-path form of the mover
        scan and the coordination sweep)."""
        resp, price, _ = wa.metric_arrays()
        ratios = resp / wa.placed.response_s + price / wa.placed.price
        if self.cost_model is None:
            pens = self._moved_mask(wa) * self.move_penalty
        else:
            pens = np.fromiter((self._move_penalty(wa, c) for c in wa.candidates),
                               np.float64, len(wa.candidates))
        return w * ratios + pens

    def _attach_provenance(self, res: ReconfigResult, ctx: List[_WindowApp],
                           assignment: Sequence[int],
                           norm: Optional[Dict[int, float]] = None,
                           costv: Optional[List[np.ndarray]] = None) -> None:
        """Attach a `MoveProvenance` record per committed move (the "why":
        objective delta, runner-up + margin, binding constraints — see
        `obs.provenance`).  O(moves), not O(window): cost vectors are
        rebuilt only for apps that actually move (or reused from
        ``costv`` when the planner already has them)."""
        if not res.accepted or not res.moves:
            return
        from .obs.provenance import provenance_from_costs
        by_req = {wa.placed.req_id: i for i, wa in enumerate(ctx)}
        prov: Dict[int, object] = {}
        for mv in res.moves:
            i = by_req.get(mv.req_id)
            if i is None:
                continue
            wa = ctx[i]
            w = norm[mv.req_id] if norm else 1.0
            resp, price, nodes = wa.metric_arrays()
            raw = w * (resp / wa.placed.response_s
                       + price / wa.placed.price)
            costs = costv[i] if costv is not None else self._cost_vector(wa, w)
            prov[mv.req_id] = provenance_from_costs(
                mv.req_id, nodes, costs, raw,
                assignment[i], wa.current_idx)
        res.provenance = prov

    def _provenance_from_moves(self, engine: PlacementEngine,
                               window: Sequence[int], res: ReconfigResult,
                               weights: Optional[Mapping[int, float]]) -> None:
        """`_attach_provenance` for planners that return moves without an
        explicit assignment vector (the MILP path): reconstruct each moved
        app's chosen candidate index from the move's destination node."""
        if not res.accepted or not res.moves:
            return
        norm = normalize_weights(window, weights) if weights is not None else None
        ctx = _window_context(engine, window)
        by_req = {wa.placed.req_id: i for i, wa in enumerate(ctx)}
        assignment = [wa.current_idx for wa in ctx]
        for mv in res.moves:
            i = by_req.get(mv.req_id)
            if i is None:
                continue
            wa = ctx[i]
            nid = mv.new.node.node_id
            if wa.cset is not None:
                j = wa.cset.index_of.get(nid, -1)
            else:
                j = next((k for k, c in enumerate(wa.candidates)
                          if c.node.node_id == nid), -1)
            if j >= 0:
                assignment[i] = j
        self._attach_provenance(res, ctx, assignment, norm)

    def _batch_cost_vectors(self, ctx: List[_WindowApp],
                            norm: Optional[Dict[int, float]]):
        """(cost vectors, mover flags) built per app — the cost-model
        fallback behind `_window_costs` (model penalties are inherently
        per-candidate Python; the no-model case takes `_window_costs`'s
        fused numpy pass instead)."""
        costv = []
        movers = []
        for wa in ctx:
            w = norm[wa.placed.req_id] if norm else 1.0
            costs = self._cost_vector(wa, w)
            costv.append(costs)
            movers.append(bool((costs < costs[wa.current_idx] - 1e-12).any()))
        return costv, movers

    def _window_costs(self, engine: PlacementEngine, window: Sequence[int],
                      norm: Optional[Dict[int, float]]):
        """`_window_context` + `_batch_cost_vectors` fused into one pass
        over the window (the two separate 10k-app loops were a measurable
        share of fleet-scale tick latency).  Returns a `_WindowBatch` whose
        concatenated metric arrays also feed `_result_from_batch`."""
        if self.cost_model is not None:   # per-candidate Python penalties
            ctx = _window_context(engine, window)
            costv, movers = self._batch_cost_vectors(ctx, norm)
            return _WindowBatch(ctx, costv, movers)
        ctx: List[_WindowApp] = []
        k = len(window)
        sizes = np.empty(k, dtype=np.int64)
        rb_arr = np.empty(k)
        pb_arr = np.empty(k)
        w_arr = np.empty(k)
        cur_idx = np.empty(k, dtype=np.int64)
        resp_parts: List[np.ndarray] = []
        price_parts: List[np.ndarray] = []
        mask_parts: List[np.ndarray] = []
        placed_map = engine.placed
        for i, req_id in enumerate(window):
            placed = placed_map[req_id]
            wa = _resolve_window_app(engine, placed)
            mask = self._moved_mask(wa)
            cur = wa.current_idx
            resp, price, _ = wa.metric_arrays()
            ctx.append(wa)
            sizes[i] = resp.size
            rb_arr[i] = placed.response_s
            pb_arr[i] = placed.price
            w_arr[i] = norm[req_id] if norm else 1.0
            cur_idx[i] = cur
            resp_parts.append(resp)
            price_parts.append(price)
            mask_parts.append(mask)
        if not ctx:
            return _WindowBatch(ctx, [], [])
        offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        resp_all = np.concatenate(resp_parts)
        price_all = np.concatenate(price_parts)
        costs_all = (resp_all * np.repeat(w_arr / rb_arr, sizes)
                     + price_all * np.repeat(w_arr / pb_arr, sizes)
                     + np.concatenate(mask_parts) * self.move_penalty)
        block_min = np.minimum.reduceat(costs_all, offs)
        mover_flags = block_min < costs_all[offs + cur_idx] - 1e-12
        costv = [costs_all[offs[i]:offs[i] + sizes[i]] for i in range(k)]
        return _WindowBatch(ctx, costv, [bool(b) for b in mover_flags],
                            offs=offs, resp_all=resp_all, price_all=price_all,
                            rb=rb_arr, pb=pb_arr, w=w_arr, cur_idx=cur_idx)


class NoOpPolicy(ReconfigPolicy):
    """Control: measures what continuous operation looks like without the
    paper's contribution."""

    name = "noop"

    def plan(self, engine: PlacementEngine, window: Sequence[int],
             weights: Optional[Mapping[int, float]] = None) -> ReconfigResult:
        t0 = time.perf_counter()
        ctx = _window_context(engine, window)
        norm = normalize_weights(window, weights) if weights is not None else None
        return _result_from_assignment(window, ctx, [wa.current_idx for wa in ctx],
                                       self.accept_threshold, t0, norm)


class MilpPolicy(ReconfigPolicy):
    """The paper's exact joint MILP."""

    name = "milp"

    def __init__(self, move_penalty: float = 0.01, accept_threshold: float = 0.0,
                 backend: str = "auto", time_limit_s: float = 60.0,
                 cost_model=None):
        super().__init__(move_penalty, accept_threshold, cost_model)
        self.backend = backend
        self.time_limit_s = time_limit_s

    def plan(self, engine: PlacementEngine, window: Sequence[int],
             weights: Optional[Mapping[int, float]] = None) -> ReconfigResult:
        recon = Reconfigurator(
            engine, move_penalty=self.move_penalty,
            accept_threshold=self.accept_threshold,
            backend=self.backend, time_limit_s=self.time_limit_s,
            cost_model=self.cost_model,
        )
        res = recon.plan(window, weights=weights)
        # Surface proven-vs-incumbent solver quality (a "feasible" status
        # means the deadline expired before optimality was proven) plus the
        # solver's work counters.
        from .telemetry import PlanStats  # late: avoids an import cycle
        sol = res.solver
        self.last_plan_stats = PlanStats(
            n_feasible=int(sol is not None and sol.status == "feasible"),
            lp_iterations=sol.lp_iterations if sol is not None else 0,
            bnb_nodes=sol.nodes_explored if sol is not None else 0)
        self._provenance_from_moves(engine, window, res, weights)
        return res


class GreedyPolicy(ReconfigPolicy):
    """One pass in window order: each app takes its cheapest feasible
    candidate given what earlier apps already grabbed.  O(window · cands)."""

    name = "greedy"

    def plan(self, engine: PlacementEngine, window: Sequence[int],
             weights: Optional[Mapping[int, float]] = None) -> ReconfigResult:
        t0 = time.perf_counter()
        ctx = _window_context(engine, window)
        norm = normalize_weights(window, weights) if weights is not None else None
        shadow = _Shadow(*engine.free_capacity_excluding(window))
        for wa in ctx:  # charge the live assignment; apps are lifted out 1-by-1
            shadow.occupy(wa.placed.request.app, wa.candidates[wa.current_idx], +1.0)
        assignment: List[int] = []
        for wa in ctx:
            app = wa.placed.request.app
            w = norm[wa.placed.req_id] if norm else 1.0
            shadow.occupy(app, wa.candidates[wa.current_idx], -1.0)
            best, best_cost = wa.current_idx, self._cost(wa, wa.current_idx, w)
            for j in range(len(wa.candidates)):
                if j == wa.current_idx:
                    continue
                cost = self._cost(wa, j, w)
                if cost < best_cost - 1e-12 and shadow.fits(app, wa.candidates[j]):
                    best, best_cost = j, cost
            shadow.occupy(app, wa.candidates[best], +1.0)
            assignment.append(best)
        res = _result_from_assignment(window, ctx, assignment,
                                      self.accept_threshold, t0, norm)
        self._attach_provenance(res, ctx, assignment, norm)
        return res


class HillClimbPolicy(ReconfigPolicy):
    """Steepest descent on the joint objective: repeatedly apply the single
    app-to-candidate reassignment with the largest decrease until a local
    optimum (or ``max_iters``)."""

    name = "hillclimb"

    def __init__(self, move_penalty: float = 0.01, accept_threshold: float = 0.0,
                 max_iters: int = 400, cost_model=None):
        super().__init__(move_penalty, accept_threshold, cost_model)
        self.max_iters = max_iters

    def plan(self, engine: PlacementEngine, window: Sequence[int],
             weights: Optional[Mapping[int, float]] = None) -> ReconfigResult:
        t0 = time.perf_counter()
        ctx = _window_context(engine, window)
        norm = normalize_weights(window, weights) if weights is not None else None
        shadow = _Shadow(*engine.free_capacity_excluding(window))
        assignment = [wa.current_idx for wa in ctx]
        for wa in ctx:  # charge the starting assignment
            shadow.occupy(wa.placed.request.app, wa.candidates[wa.current_idx], +1.0)
        for _ in range(self.max_iters):
            best_delta, best_i, best_j = 1e-12, -1, -1
            for i, wa in enumerate(ctx):
                app = wa.placed.request.app
                w = norm[wa.placed.req_id] if norm else 1.0
                cur_cost = self._cost(wa, assignment[i], w)
                shadow.occupy(app, wa.candidates[assignment[i]], -1.0)
                for j in range(len(wa.candidates)):
                    if j == assignment[i]:
                        continue
                    delta = cur_cost - self._cost(wa, j, w)
                    if delta > best_delta and shadow.fits(app, wa.candidates[j]):
                        best_delta, best_i, best_j = delta, i, j
                shadow.occupy(app, wa.candidates[assignment[i]], +1.0)
            if best_i < 0:
                break
            wa = ctx[best_i]
            shadow.occupy(wa.placed.request.app, wa.candidates[assignment[best_i]], -1.0)
            shadow.occupy(wa.placed.request.app, wa.candidates[best_j], +1.0)
            assignment[best_i] = best_j
        res = _result_from_assignment(window, ctx, assignment,
                                      self.accept_threshold, t0, norm)
        self._attach_provenance(res, ctx, assignment, norm)
        return res


class GaPolicy(ReconfigPolicy):
    """`core.ga.GeneticSearch` over the assignment space: one locus per
    window app, alphabet = its top-``k_candidates`` options (current always
    included); capacity violations are penalized, and an infeasible winner
    falls back to the do-nothing assignment."""

    name = "ga"

    def __init__(self, move_penalty: float = 0.01, accept_threshold: float = 0.0,
                 k_candidates: int = 5, seed: int = 0,
                 config: Optional[GaConfig] = None, cost_model=None):
        super().__init__(move_penalty, accept_threshold, cost_model)
        self.k_candidates = k_candidates
        self.seed = seed
        self.config = config or GaConfig(population=24, generations=16)
        self._calls = 0

    def plan(self, engine: PlacementEngine, window: Sequence[int],
             weights: Optional[Mapping[int, float]] = None) -> ReconfigResult:
        t0 = time.perf_counter()
        ctx = _window_context(engine, window)
        norm = normalize_weights(window, weights) if weights is not None else None
        wts = [norm[wa.placed.req_id] if norm else 1.0 for wa in ctx]
        # Prune each app's choices to its k best (by penalized cost), with
        # the live candidate always at locus value 0.
        for wa, w in zip(ctx, wts):
            order = sorted(range(len(wa.candidates)),
                           key=lambda j: (self._cost(wa, j, w),
                                          wa.candidates[j].node.node_id))
            keep = [wa.current_idx] + [j for j in order
                                       if j != wa.current_idx][: self.k_candidates - 1]
            wa.candidates = [wa.candidates[j] for j in keep]
            wa.current_idx = 0
            # Metric arrays and the CandidateSet mask cache are indexed by
            # candidate position — drop both so any later consumer rebuilds
            # against the pruned list.
            wa.response_arr = wa.price_arr = wa.node_id_arr = None
            wa.cset = None
        node_cap, link_cap = engine.free_capacity_excluding(window)

        def fitness(gene) -> float:
            shadow = _Shadow(node_cap, link_cap)
            total = 0.0
            for wa, w, g in zip(ctx, wts, gene):
                total += self._cost(wa, g, w)
                shadow.occupy(wa.placed.request.app, wa.candidates[g], +1.0)
            overflow = sum(-v for v in shadow.node.values() if v < -1e-9)
            overflow += sum(-v for v in shadow.link.values() if v < -1e-9)
            return -(total + 100.0 * overflow)

        rng = np.random.default_rng((self.seed, self._calls))
        self._calls += 1
        search = GeneticSearch([len(wa.candidates) for wa in ctx], fitness,
                               config=self.config, rng=rng)
        res = search.run(seed_genes=[tuple(0 for _ in ctx)])
        assignment = list(res.best_gene)
        shadow = _Shadow(node_cap, link_cap)
        for wa, g in zip(ctx, assignment):
            shadow.occupy(wa.placed.request.app, wa.candidates[g], +1.0)
        if any(v < -1e-9 for v in shadow.node.values()) or any(
                v < -1e-9 for v in shadow.link.values()):
            assignment = [0] * len(ctx)  # infeasible winner → do nothing
        res = _result_from_assignment(window, ctx, assignment,
                                      self.accept_threshold, t0, norm)
        self._attach_provenance(res, ctx, assignment, norm)
        return res


class AdaptivePolicy(ReconfigPolicy):
    """Online solver governor over a *ladder* of policies — by default
    MILP → incremental → greedy (exact, then regionally-exact with
    journal-driven reuse, then heuristic).  Escalate one tier when the rolling mean ``plan_time_s``
    over the last ``k`` plans exceeds ``budget_s``; de-escalate one tier
    once the rolling mean recovers below ``budget_s × recover_frac``.

    While a cheaper tier runs, its plan times flow into the same rolling
    window, so the mean decays and the controller climbs back toward the
    exact solver — the classic hysteresis loop; a mean that stays hot
    cascades all the way down to greedy.
    NOTE: switching depends on wall-clock solver latency, so adaptive runs
    are NOT covered by the telemetry-fingerprint determinism contract."""

    name = "adaptive"

    def __init__(self, move_penalty: float = 0.01, accept_threshold: float = 0.0,
                 budget_s: float = 0.25, k: int = 5, recover_frac: float = 0.5,
                 tiers: Sequence[str] = ("milp", "incremental", "greedy"),
                 cost_model=None, **milp_kwargs):
        super().__init__(move_penalty, accept_threshold, cost_model)
        self.budget_s = budget_s
        self.recover_frac = recover_frac
        self.tiers: List[ReconfigPolicy] = []
        for tier in tiers:
            kwargs = dict(milp_kwargs) if tier == "milp" else {}
            self.tiers.append(get_policy(
                tier, move_penalty=move_penalty,
                accept_threshold=accept_threshold,
                cost_model=cost_model, **kwargs))
        if not self.tiers:
            raise ValueError("adaptive needs at least one tier")
        self.level = 0
        self.switches = 0
        self._times: deque = deque(maxlen=max(int(k), 1))

    @property
    def active(self) -> ReconfigPolicy:
        return self.tiers[self.level]

    @property
    def active_name(self) -> str:
        return self.active.name

    @property
    def using_fast(self) -> bool:
        """True once the governor sits on the last (cheapest) tier."""
        return self.level == len(self.tiers) - 1

    def observe(self, now: float = 0.0, curves: Optional[Mapping] = None,
                executor=None) -> None:
        for tier in self.tiers:
            tier.observe(now=now, curves=curves, executor=executor)

    def bind_tracer(self, tracer) -> None:
        super().bind_tracer(tracer)
        for tier in self.tiers:
            tier.bind_tracer(tracer)

    def on_slo_breach(self, breach) -> bool:
        """Observe → act: an SLO burn-rate breach (`obs.slo.SloBreach`)
        pulls the governor one tier back toward the exact solver — the
        fleet is hurting, so plan *better*, even if slower.  The rolling
        latency window is cleared so stale cheap-tier timings don't
        immediately re-escalate.  Returns True when a switch happened."""
        if self.level == 0:
            return False
        self.level -= 1
        self.switches += 1
        self._times.clear()
        return True

    def plan(self, engine: PlacementEngine, window: Sequence[int],
             weights: Optional[Mapping[int, float]] = None) -> ReconfigResult:
        pol = self.active
        res = pol.plan(engine, window, weights)
        self.last_plan_stats = getattr(pol, "last_plan_stats", None)
        self._times.append(res.plan_time_s)
        mean = sum(self._times) / len(self._times)
        if mean > self.budget_s and self.level < len(self.tiers) - 1:
            self.level += 1
            self.switches += 1
        elif mean <= self.budget_s * self.recover_frac and self.level > 0:
            self.level -= 1
            self.switches += 1
        return res


POLICIES: Dict[str, Type[ReconfigPolicy]] = {
    p.name: p for p in (MilpPolicy, GreedyPolicy, HillClimbPolicy, GaPolicy,
                        AdaptivePolicy, NoOpPolicy)
}


def _ensure_planner_registered() -> None:
    """Late-bind the planner subsystem's policies (decomposed / horizon)
    into the registry.  `fleet.planner` imports this module, so the
    registration has to happen lazily to avoid a cycle; importing
    `repro_torch.fleet` performs it eagerly."""
    if "decomposed" not in POLICIES:
        from . import planner  # noqa: F401  (registers on import)


def get_policy(name: str, **kwargs) -> ReconfigPolicy:
    _ensure_planner_registered()
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; have {sorted(POLICIES)}") from None
    return cls(**kwargs)
