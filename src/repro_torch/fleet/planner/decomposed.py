"""Decomposed reconfiguration: partition → solve → coordinate → merge.

The monolithic MILP re-optimizes the whole window jointly; its constraint
matrix grows with window × topology and falls off a latency cliff right
where the north-star begins.  The decomposed planner exploits the tree
structure instead:

1. **partition** the site tree into regions (`planner.partition`) — on the
   paper topology one region per cloud subtree, which block-diagonalizes
   the MILP *exactly* (an app's whole uplink chain lives in one subtree);
2. **solve** one small MILP per region over the window apps currently
   homed there, against the *live residual* capacity pool (regions are
   processed in deterministic order against one shared shadow ledger, so
   later regions see earlier regions' tentative claims — Gauss–Seidel
   block descent).  Only apps with at least one strictly-improving
   candidate enter the MILP (*movers*); the rest stay pinned, which keeps
   the regional problems proportional to the churn, not the window.
   Boundary links get only ``boundary_budget_frac`` of their residual per
   regional solve so the first region cannot hog a shared uplink;
3. **coordinate**: one cheap greedy arbitration sweep over the full
   candidate lists lets apps cross region boundaries (and pick up any
   in-region improvement the budgets blocked) wherever the shared shadow
   still fits — this is where cross-region moves are admitted one by one
   instead of through a joint model;
4. **merge** the per-region assignments into a single `ReconfigResult`.
   Every occupy/fit went through the one shadow ledger, so the merged
   plan can never double-book a node or link (the property tests assert
   exactly this against `free_capacity_excluding`).

**Incremental mode** (``incremental=True``, registered as the
``incremental`` policy) makes the per-tick cost proportional to the
*delta* since the last plan:

* the engine's change journal (`PlacementEngine.journal`) is mapped onto
  partition regions — an arrival/departure/drift/failure/recovery only
  dirties the regions whose nodes or links it touched (a boundary-link
  event dirties BOTH adjacent regions);
* a clean region whose exact MILP inputs (apps, weights, candidate sets,
  shadow residuals — boundary budgets included) match the cached
  signature **reuses its cached assignment** instead of re-solving.  The
  signature guard is what keeps reuse sound under Gauss–Seidel coupling:
  if an earlier region's claims shifted this region's visible residuals,
  the signature differs and the region re-solves;
* dirty regions re-solve with the previous assignment (cached plan
  re-projected onto the current candidate set, else the live do-nothing
  assignment) as a **warm start** — the B&B backend prunes against it and
  branches toward it, and either backend falls back to it on deadline.

The merged result is byte-identical to the full decomposed planner's (the
telemetry fingerprint asserts this end-to-end): reuse only ever replays a
solve whose inputs were proven unchanged.  The byte-parity contract is
scoped to the default HiGHS backend (which ignores the incumbent except
as a deadline fallback); under the scipy-free B&B fallback a warm start
can return a *different representative of tied optima* — the objective,
gain and satisfaction are identical, but the chosen nodes (and hence
fingerprints) may differ on symmetric topologies.

**Hierarchical mode** plans over a `planner.partition.PartitionTree`
instead of a flat partition.  The regional MILPs still run against the
tree's *leaf* cut — so with default parameters (a degenerate
``[leaf, global]`` tree) every code path is byte-identical to the
single-level planner — but two things recurse:

* the **arbitration sweep** runs bottom-up, level by level: each app is
  swept exactly once, at the lowest level whose enclosing region is
  *closed* (no boundary links at that level).  A closed region provably
  contains every candidate of every app homed in it — any escaping path
  would need a crossing link — so sweeping it in isolation admits exactly
  the moves the flat global sweep would, while upper levels only arbitrate
  the apps whose regions still have budgeted cross-level boundary links;
* the **change journal drives dirtiness at every level**: a closed
  level-1 region whose leaf regions are all journal-clean and whose app
  roster/weights/placements match the cached *subtree signature* is
  skipped wholesale — its leaf plans replay without assembling MILP
  inputs or per-region signatures (``PlanStats.subtrees_skipped``).
  Candidate containment is what makes the cheap signature sufficient:
  everything a closed subtree's solve can see lives inside the subtree,
  and every engine mutation inside it is journaled.

`HierarchicalPolicy` (policy name ``hierarchical``) enables tree
coarsening only above ``hierarchy_min_nodes`` devices, so paper-scale
topologies keep the exact single-level behavior and fingerprints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.lp import AppVars, build_joint_milp
from repro_torch.core.placement import PlacementEngine
from repro_torch.core.reconfig import ReconfigResult
from repro_torch.core.satisfaction import normalize_weights
from repro_torch.core.solver import solve_milp
from repro_torch.core.topology import Topology

from ..policies import (
    ReconfigPolicy,
    _result_from_batch,
    _Shadow,
    _WindowApp,
)
from ..telemetry import PlanStats
from .partition import Partition, PartitionTree, partition_tree


@dataclasses.dataclass
class _RegionPlan:
    """Cached outcome of one region's MILP: the exact input signature it
    was solved under and the chosen candidate per app (global candidate
    index + node id, for cross-checking after candidate-set rebuilds)."""

    sig: Tuple
    choices: Dict[int, Tuple[int, str]]    # req_id -> (cand idx, node_id)


@dataclasses.dataclass
class _RegionInputs:
    """Everything one regional MILP consumes, assembled without solving."""

    app_vars: List[AppVars]
    keeps: List[np.ndarray]        # kept candidate indices, sorted ascending
    node_cap: Dict[str, float]
    link_cap: Dict[str, float]


class DecomposedPolicy(ReconfigPolicy):
    """Per-region MILPs + boundary arbitration behind the policy interface."""

    name = "decomposed"

    def __init__(self, move_penalty: float = 0.01, accept_threshold: float = 0.0,
                 cost_model=None, max_region_nodes: Optional[int] = None,
                 k_regions: Optional[int] = None,
                 boundary_budget_frac: float = 0.5,
                 coordinate: bool = True,
                 backend: str = "auto", time_limit_s: float = 10.0,
                 incremental: bool = False,
                 group_size: Optional[int] = None):
        super().__init__(move_penalty, accept_threshold, cost_model)
        self.max_region_nodes = max_region_nodes
        self.k_regions = k_regions
        self.group_size = group_size
        self.boundary_budget_frac = boundary_budget_frac
        self.coordinate = coordinate
        self.backend = backend
        self.time_limit_s = time_limit_s
        self.incremental = incremental
        # Last (topo, tree) pair — topologies are immutable, and a policy
        # plans against one fleet at a time, so one slot suffices (a dict
        # keyed by id() would pin every topology ever seen).
        self._tree: Optional[PartitionTree] = None
        # Incremental state: per-region cached plans, the journal cursor
        # they are valid from, and the engine they were observed on.
        self._region_cache: Dict[str, _RegionPlan] = {}
        # Level-1 subtree signatures for the wholesale skip (deep trees).
        self._subtree_cache: Dict[str, Tuple] = {}
        self._cursor = 0
        self._engine: Optional[PlacementEngine] = None
        self.last_dirty_regions: Optional[Set[str]] = None
        # Whole-tick replay cache: (window, norm weights, result pieces,
        # plan stats).  Valid only while the journal stays empty.
        self._tick_cache: Optional[Tuple] = None
        # Wall-clock spent assembling MILPs (CSR) in the current plan call.
        self._build_s = 0.0

    # -------------------------------------------------------------- partition
    def _tree_params(self, topo: Topology) -> Tuple[Optional[int],
                                                    Optional[int],
                                                    Optional[int]]:
        """(max_region_nodes, k_regions, group_size) used to build the
        tree for ``topo`` — the subclass hook that lets `hierarchical`
        gate coarsening on fleet size."""
        return (self.max_region_nodes, self.k_regions, self.group_size)

    def tree_for(self, topo: Topology) -> PartitionTree:
        if self._tree is None or self._tree.topo is not topo:
            mrn, k, gs = self._tree_params(topo)
            self._tree = partition_tree(topo, mrn, k, gs)
            self._region_cache.clear()
            self._subtree_cache.clear()
        return self._tree

    def partition_for(self, topo: Topology) -> Partition:
        """The leaf cut the regional MILPs are solved against."""
        return self.tree_for(topo).leaf

    # ---------------------------------------------------------------- journal
    def _dirty_since(self, engine: PlacementEngine,
                     part: Partition) -> Optional[Set[str]]:
        """Regions touched by engine mutations since the last plan; None
        means "unknown — treat everything dirty" (first plan against this
        engine, or the journal ring already dropped entries)."""
        if self._engine is not engine:
            self._engine = engine
            self._region_cache.clear()
            self._subtree_cache.clear()
            self._cursor = engine.journal.total
            return None
        entries = engine.journal.since(self._cursor)
        self._cursor = engine.journal.total
        if entries is None:
            self._region_cache.clear()
            self._subtree_cache.clear()
            return None
        dirty: Set[str] = set()
        for e in entries:
            for nid in e.nodes:
                rid = part.region_of_node.get(nid)
                if rid is not None:
                    dirty.add(rid)
            for lid in e.links:
                dirty.update(part.regions_of_link(lid))
        return dirty

    # ------------------------------------------------------------------- plan
    def plan(self, engine: PlacementEngine, window: Sequence[int],
             weights: Optional[Mapping[int, float]] = None) -> ReconfigResult:
        t0 = time.perf_counter()
        norm = normalize_weights(window, weights) if weights is not None else None
        # Whole-tick replay: with an empty journal and identical window +
        # weights, the entire plan — not just each region's — is determined
        # by the cached result.  This is the paper's quiet-period periodic
        # re-calculation collapsing to O(1): nothing changed, nothing paid.
        # (Gated off under a cost model: its penalties also depend on the
        # executor ledger, which is not fully journaled at reserve=0.)
        if (self.incremental and self.cost_model is None
                and self._tick_cache is not None
                and self._engine is engine
                and engine.journal.total == self._cursor):
            (c_window, c_norm, c_moves, c_sat, c_s_after, c_accepted,
             c_stats, c_prov) = self._tick_cache
            if c_window == tuple(window) and c_norm == norm:
                self.last_dirty_regions = set()
                self.last_plan_stats = dataclasses.replace(
                    c_stats, n_regions=0, region_solve_s=[],
                    warm_start_hits=0, warm_start_misses=0, n_feasible=0,
                    build_s=0.0, lp_iterations=0, bnb_nodes=0,
                    regions_reused=c_stats.regions_reused + c_stats.n_regions)
                return ReconfigResult(
                    list(window), list(c_moves), c_sat,
                    2.0 * len(c_sat), c_s_after, c_accepted, None,
                    time.perf_counter() - t0, weights=norm,
                    provenance=c_prov)
        batch_ctx = self._window_costs(engine, window, norm)
        ctx, costv, movers = batch_ctx.ctx, batch_ctx.costv, batch_ctx.movers
        tree = self.tree_for(engine.topo)
        part = tree.leaf
        if self.incremental:
            with self.tracer.span("journal_scan", cat="tick"):
                dirty = self._dirty_since(engine, part)
        else:
            dirty = None
        self.last_dirty_regions = dirty
        self._build_s = 0.0   # accumulated by _solve_region/_solve_batch
        lp_iters = bnb_nodes = 0

        # One shared shadow ledger = live residual capacity (window apps
        # charged at their current homes — i.e. the engine's remaining
        # capacity as-is; `free_capacity_excluding` + re-charging every
        # window app would reproduce exactly this, minus a float roundtrip).
        # Every tentative claim below goes through it, which is what makes
        # the merge conflict-free.
        shadow = _Shadow(
            {nid: engine.node_remaining(nid) for nid in engine.topo.nodes},
            {lid: engine.link_remaining(lid) for lid in engine.topo.links})
        assignment = [wa.current_idx for wa in ctx]

        # Movers (apps with ≥1 strictly-improving candidate) came from the
        # fused window pass above: only they enter the regional MILPs — the
        # rest stay pinned, so the solve size tracks churn rather than
        # window size.  The per-app cost vectors feed the coordination
        # sweep and the improving-candidate pruning.
        groups: Dict[str, List[int]] = {}
        for i, wa in enumerate(ctx):
            rid = part.region_of_node[wa.placed.candidate.node.node_id]
            groups.setdefault(rid, []).append(i)

        # Quiet-subtree wholesale skip (deep trees only — the degenerate
        # [leaf, global] tree never reaches this, protecting single-level
        # byte-parity).  A *closed* level-1 region contains every candidate
        # of every app homed under it, so if its leaves are journal-clean
        # and its app roster (ids, live indices/nodes, weights, baselines)
        # matches last tick's subtree signature, the leaf MILP inputs are
        # provably unchanged — replay each leaf's cached plan without even
        # assembling inputs or per-region signatures.
        use_subtree = (self.incremental and self.cost_model is None
                       and tree.n_levels >= 3 and dirty is not None)
        skip_leaves: Dict[str, str] = {}   # leaf rid -> level-1 ancestor
        subtree_sigs: Dict[str, Tuple] = {}
        failed_l1: Set[str] = set()
        if use_subtree:
            dirty1 = tree.dirty_at(1, dirty)
            for region1 in tree.levels[1].regions:
                rid1 = region1.region_id
                if region1.boundary_links:
                    continue
                if rid1 in dirty1:
                    self._subtree_cache.pop(rid1, None)
                    continue
                leaves = tree.leaves_under(1, rid1)
                w_of = (lambda r: norm[r]) if norm else (lambda r: 1.0)
                sig1 = tuple(
                    (ctx[i].placed.req_id, ctx[i].current_idx,
                     ctx[i].placed.candidate.node.node_id,
                     w_of(ctx[i].placed.req_id),
                     ctx[i].placed.response_s, ctx[i].placed.price)
                    for rid in leaves for i in groups.get(rid, ()))
                subtree_sigs[rid1] = (sig1, tuple(leaves))
                if self._subtree_cache.get(rid1) != sig1:
                    continue
                mover_leaves = [rid for rid in leaves
                                if any(movers[i]
                                       for i in groups.get(rid, ()))]
                if all(rid in self._region_cache for rid in mover_leaves):
                    for rid in leaves:
                        skip_leaves[rid] = rid1

        # Per-region triage: lift each mover set out of the shared pool,
        # assemble the exact MILP inputs, and either replay the cached plan
        # (incremental, clean region, identical inputs) or queue a solve.
        # With boundary links the queued solves run sequentially against the
        # evolving shadow (Gauss–Seidel); on boundary-free partitions the
        # regional problems share no resource rows, so they are solved as
        # ONE block-diagonal MILP — one solver call per tick instead of one
        # per region, with bit-identical per-region optima.
        region_solve_s: List[float] = []
        n_solved = reused = hits = misses = n_feasible = 0
        batch: List[Tuple[object, List[int], _RegionInputs, Optional[Tuple]]] = []
        sequential = bool(part.boundary_links)
        for region in part.regions:
            rid = region.region_id
            idxs = [i for i in groups.get(rid, ()) if movers[i]]
            if not idxs:
                self._region_cache.pop(rid, None)
                continue
            rt0 = time.perf_counter()
            for i in idxs:
                shadow.occupy(ctx[i].placed.request.app,
                              ctx[i].candidates[assignment[i]], -1.0)
            if rid in skip_leaves:
                cached = self._region_cache.get(rid)
                if cached is not None \
                        and self._replay(cached, ctx, idxs, assignment):
                    reused += 1
                    for i in idxs:
                        shadow.occupy(ctx[i].placed.request.app,
                                      ctx[i].candidates[assignment[i]], +1.0)
                    continue
                # Anomalous (the signature argument says this cannot
                # happen): fall through to the full inputs+signature path
                # and stop trusting the subtree this tick.
                failed_l1.add(skip_leaves[rid])
                self._subtree_cache.pop(skip_leaves[rid], None)
            inputs = self._region_inputs(ctx, idxs, region, part, shadow,
                                         norm, assignment, costv)
            sig = self._signature(ctx, idxs, norm, inputs) \
                if self.incremental else None
            cached = self._region_cache.get(rid)
            if (cached is not None and dirty is not None and rid not in dirty
                    and cached.sig == sig
                    and self._replay(cached, ctx, idxs, assignment)):
                reused += 1
            elif sequential:
                with self.tracer.span("region_solve", cat="tick",
                                      args={"region": rid, "apps": len(idxs)}):
                    res = self._solve_region(ctx, idxs, inputs, cached,
                                             assignment)
                region_solve_s.append(time.perf_counter() - rt0)
                n_solved += 1
                lp_iters += res.lp_iterations
                bnb_nodes += res.nodes_explored
                if res.warm_start == "hit":
                    hits += 1
                elif res.warm_start == "miss":
                    misses += 1
                if res.status == "feasible":
                    n_feasible += 1
                self._cache_region(rid, sig, ctx, idxs, assignment,
                                   res.status == "optimal")
            else:
                batch.append((region, idxs, inputs, sig))
            for i in idxs:   # re-occupy the (possibly new) choices
                shadow.occupy(ctx[i].placed.request.app,
                              ctx[i].candidates[assignment[i]], +1.0)

        if batch:
            bt0 = time.perf_counter()
            with self.tracer.span("region_solve", cat="tick",
                                  args={"regions": len(batch)}):
                res = self._solve_batch(ctx, batch, assignment, shadow)
            region_solve_s.append(time.perf_counter() - bt0)
            n_solved += len(batch)
            lp_iters += res.lp_iterations
            bnb_nodes += res.nodes_explored
            if res.warm_start == "hit":
                hits += len(batch)
            elif res.warm_start == "miss":
                misses += len(batch)
            if res.status == "feasible":
                n_feasible += 1
            for region, idxs, _, sig in batch:
                self._cache_region(region.region_id, sig, ctx, idxs,
                                   assignment, res.status == "optimal")

        # Remember each clean closed subtree's roster signature for the
        # next tick.  Planning never mutates the engine, so the pre-plan
        # signatures are still the live state; a subtree is replayable
        # only once every mover leaf under it holds a proven plan.
        if use_subtree:
            for rid1, (sig1, leaves) in subtree_sigs.items():
                if rid1 not in failed_l1 and all(
                        rid in self._region_cache for rid in leaves
                        if any(movers[i] for i in groups.get(rid, ()))):
                    self._subtree_cache[rid1] = sig1
                else:
                    self._subtree_cache.pop(rid1, None)
        subtrees_skipped = len(set(skip_leaves.values()) - failed_l1)

        # Without boundary links every candidate lives in its app's home
        # region (a crossing path would need a crossing link), so the
        # arbitration sweep is provably a no-op on top of the region-MILP
        # optima — skip it.
        crossings = 0
        if self.coordinate and part.boundary_links:
            with self.tracer.span("arbitration", cat="tick"):
                crossings = self._coordinate_tree(ctx, tree, shadow,
                                                  assignment, costv)

        self.last_plan_stats = PlanStats(
            n_regions=n_solved,
            boundary_crossings=crossings,
            region_solve_s=region_solve_s,
            regions_reused=reused,
            warm_start_hits=hits,
            warm_start_misses=misses,
            n_feasible=n_feasible,
            build_s=self._build_s,
            lp_iterations=lp_iters,
            bnb_nodes=bnb_nodes,
            subtrees_skipped=subtrees_skipped,
        )
        result = _result_from_batch(window, batch_ctx, assignment,
                                    self.accept_threshold, t0, norm)
        self._attach_provenance(result, ctx, assignment, norm, costv=costv)
        if self.incremental and n_feasible == 0:
            # Deadline incumbents are wall-clock artifacts — never replay.
            self._tick_cache = (tuple(window), norm, tuple(result.moves),
                                result.satisfaction, result.s_after,
                                result.accepted, self.last_plan_stats,
                                result.provenance)
        else:
            self._tick_cache = None
        return result

    # ------------------------------------------------------------ region MILP
    def _region_inputs(
        self,
        ctx: List[_WindowApp],
        idxs: List[int],
        region,
        part: Partition,
        shadow: _Shadow,
        norm: Optional[Dict[int, float]],
        assignment: List[int],
        costv: List[np.ndarray],
    ) -> _RegionInputs:
        """Assemble the regional MILP: candidates restricted to in-region
        nodes AND strictly improving on the app's live cost (the live
        candidate always in play — the same pinning approximation the
        mover filter already makes, applied per candidate), against the
        shared shadow residual with boundary links budgeted."""
        app_vars: List[AppVars] = []
        keeps: List[np.ndarray] = []
        # On a boundary-free partition every candidate path stays inside
        # its app's home region (a crossing path would need a crossing
        # link), so the per-candidate region lookup is skipped wholesale.
        check_region = bool(part.boundary_links)
        vector_pens = self.cost_model is None
        for i in idxs:
            wa = ctx[i]
            resp, price, nodes = wa.metric_arrays()
            keep_mask = costv[i] < costv[i][assignment[i]] - 1e-12
            if check_region:
                keep_mask &= np.fromiter(
                    (part.region_of_node[nid] == region.region_id
                     for nid in nodes),
                    bool, len(wa.candidates))
            keep_mask[assignment[i]] = True   # live candidate always in play
            keep = np.nonzero(keep_mask)[0]
            cands = [wa.candidates[j] for j in keep]
            w = norm[wa.placed.req_id] if norm else 1.0
            pens = (self._moved_mask(wa)[keep] * self.move_penalty
                    if vector_pens
                    else [self._move_penalty(wa, c) for c in cands])
            app_vars.append(AppVars(
                request=wa.placed.request,
                candidates=cands,
                current_node_id=wa.placed.candidate.node.node_id,
                r_before=wa.placed.response_s / w,
                p_before=wa.placed.price / w,
                move_penalties=pens,
                response_arr=resp[keep],
                price_arr=price[keep],
                node_id_arr=nodes[keep],
            ))
            keeps.append(keep)

        node_cap: Dict[str, float] = {}
        link_cap: Dict[str, float] = {}
        if not check_region:
            # Disjoint regions: offer the region's whole resource pool (the
            # builder only emits rows for candidate-touched resources, so
            # extra keys are free — and far fewer dict ops than walking
            # every candidate's path).
            for nid in region.nodes:
                node_cap[nid] = shadow.node[nid]
            for lid in region.interior_links:
                link_cap[lid] = shadow.link[lid]
            return _RegionInputs(app_vars, keeps, node_cap, link_cap)

        # Boundary links offer only a budgeted share of their residual —
        # but never less than what the region's *live* assignment needs,
        # so the do-nothing solution stays feasible (a budget can defer
        # new cross-boundary traffic, not evict existing traffic).
        live_need: Dict[str, float] = {}
        for i in idxs:
            wa = ctx[i]
            for l in wa.candidates[assignment[i]].links:
                live_need[l.link_id] = (live_need.get(l.link_id, 0.0)
                                        + wa.placed.request.app.bandwidth_mbps)
        for av in app_vars:
            for cand in av.candidates:
                node_cap[cand.node.node_id] = shadow.node[cand.node.node_id]
                for l in cand.links:
                    cap = shadow.link[l.link_id]
                    if l.link_id not in region.interior_links:
                        cap = max(cap * self.boundary_budget_frac,
                                  live_need.get(l.link_id, 0.0))
                    link_cap[l.link_id] = cap
        return _RegionInputs(app_vars, keeps, node_cap, link_cap)

    def _signature(self, ctx: List[_WindowApp], idxs: List[int],
                   norm: Optional[Dict[int, float]],
                   inputs: _RegionInputs) -> Tuple:
        """Exact identity of one regional MILP.  Two ticks with equal
        signatures would hand the solver byte-identical problems, so the
        cached assignment can be replayed without solving.  Floats are
        compared exactly: a spurious mismatch merely re-solves."""
        apps_sig = []
        for pos, i in enumerate(idxs):
            wa = ctx[i]
            av = inputs.app_vars[pos]
            _, _, nodes = wa.metric_arrays()
            apps_sig.append((
                wa.placed.req_id,
                wa.current_idx,
                nodes.tobytes(),                # full candidate-set identity
                inputs.keeps[pos].tobytes(),
                av.r_before, av.p_before,       # weight-scaled baselines
                np.asarray(av.move_penalties).tobytes(),
            ))
        # Caps are assembled in deterministic (app, candidate) order, so
        # insertion order is itself part of the identity — no sort needed.
        return (tuple(apps_sig),
                tuple(inputs.node_cap.items()),
                tuple(inputs.link_cap.items()))

    def _replay(self, cached: _RegionPlan, ctx: List[_WindowApp],
                idxs: List[int], assignment: List[int]) -> bool:
        """Apply a cached region plan.  Cross-checks every choice against
        the live candidate set; any mismatch rejects the replay (the caller
        then re-solves)."""
        staged: List[Tuple[int, int]] = []
        for i in idxs:
            wa = ctx[i]
            got = cached.choices.get(wa.placed.req_id)
            if got is None:
                return False
            j, node_id = got
            if j >= len(wa.candidates) \
                    or wa.candidates[j].node.node_id != node_id:
                return False
            staged.append((i, j))
        for i, j in staged:
            assignment[i] = j
        return True

    def _cache_region(self, rid: str, sig: Optional[Tuple],
                      ctx: List[_WindowApp], idxs: List[int],
                      assignment: List[int], proven: bool) -> None:
        """Remember a region's solved assignment for replay/warm starts.
        Only proven-optimal solves are replayable: a deadline incumbent
        depends on wall clock, not on the inputs."""
        if not self.incremental:
            return
        if proven:
            self._region_cache[rid] = _RegionPlan(sig, {
                ctx[i].placed.req_id:
                    (assignment[i],
                     ctx[i].candidates[assignment[i]].node.node_id)
                for i in idxs})
        else:
            self._region_cache.pop(rid, None)

    def _solve_batch(self, ctx: List[_WindowApp],
                     batch: List[Tuple[object, List[int], _RegionInputs,
                                       Optional[Tuple]]],
                     assignment: List[int], shadow: _Shadow):
        """One block-diagonal MILP over every queued region (boundary-free
        partitions only: the regional problems share no capacity row, so
        the joint solve IS the per-region solves — minus the per-call
        solver overhead that dominates small regional MILPs)."""
        app_vars: List[AppVars] = []
        keeps: List[List[int]] = []
        flat_idxs: List[int] = []
        node_cap: Dict[str, float] = {}
        link_cap: Dict[str, float] = {}
        for _, idxs, inputs, _sig in batch:
            app_vars.extend(inputs.app_vars)
            keeps.extend(inputs.keeps)
            flat_idxs.extend(idxs)
            node_cap.update(inputs.node_cap)
            link_cap.update(inputs.link_cap)
        bt = time.perf_counter()
        problem, index = build_joint_milp(app_vars, node_cap, link_cap)
        self._build_s += time.perf_counter() - bt
        x0 = None
        if self.incremental:
            x0 = np.zeros(problem.n())
            off = 0
            for region, idxs, inputs, _sig in batch:
                off = self._scatter_incumbent(
                    x0, off, ctx, idxs, inputs,
                    self._region_cache.get(region.region_id), assignment)
        res = solve_milp(problem, backend=self.backend,
                         time_limit_s=self.time_limit_s, x0=x0)
        if res.ok:
            for pos, choice in enumerate(index.decode(res.x)):
                i = flat_idxs[pos]
                new_j = int(keeps[pos][choice])
                if new_j != assignment[i]:
                    shadow.occupy(ctx[i].placed.request.app,
                                  ctx[i].candidates[assignment[i]], -1.0)
                    shadow.occupy(ctx[i].placed.request.app,
                                  ctx[i].candidates[new_j], +1.0)
                    assignment[i] = new_j
        return res

    def _solve_region(self, ctx: List[_WindowApp], idxs: List[int],
                      inputs: _RegionInputs, cached: Optional[_RegionPlan],
                      assignment: List[int]):
        """Solve one regional MILP (warm-started in incremental mode) and
        write the decoded choices into ``assignment``.  On solver failure
        the current assignment stands."""
        bt = time.perf_counter()
        problem, index = build_joint_milp(inputs.app_vars, inputs.node_cap,
                                          inputs.link_cap)
        self._build_s += time.perf_counter() - bt
        x0 = None
        if self.incremental:
            x0 = self._warm_start(problem.n(), ctx, idxs, inputs, cached,
                                  assignment)
        res = solve_milp(problem, backend=self.backend,
                         time_limit_s=self.time_limit_s, x0=x0)
        if res.ok:
            for pos, choice in enumerate(index.decode(res.x)):
                assignment[idxs[pos]] = int(inputs.keeps[pos][choice])
        return res

    def _incumbent_choice(self, wa: _WindowApp, keep: np.ndarray,
                          current_j: int,
                          cached: Optional[_RegionPlan]) -> int:
        """Warm-start choice for one app: the cached plan's candidate
        re-projected onto the current keep-list, else the live
        (do-nothing) candidate — which is always feasible, so the solver
        starts with a true upper bound."""
        if cached is not None:
            got = cached.choices.get(wa.placed.req_id)
            if got is not None:
                jc, node_id = got
                if jc < len(wa.candidates) \
                        and wa.candidates[jc].node.node_id == node_id \
                        and jc in keep:
                    return jc
        return current_j

    def _scatter_incumbent(self, x0: np.ndarray, off: int,
                           ctx: List[_WindowApp], idxs: List[int],
                           inputs: _RegionInputs,
                           cached: Optional[_RegionPlan],
                           assignment: List[int]) -> int:
        """One-hot the incumbent choice of each app into ``x0`` starting at
        ``off``; returns the offset past the region's variables."""
        for pos, i in enumerate(idxs):
            keep = inputs.keeps[pos]
            j = self._incumbent_choice(ctx[i], keep, assignment[i], cached)
            x0[off + int(np.searchsorted(keep, j))] = 1.0
            off += len(keep)
        return off

    def _warm_start(self, n: int, ctx: List[_WindowApp], idxs: List[int],
                    inputs: _RegionInputs, cached: Optional[_RegionPlan],
                    assignment: List[int]) -> np.ndarray:
        x0 = np.zeros(n)
        self._scatter_incumbent(x0, 0, ctx, idxs, inputs, cached, assignment)
        return x0

    # ------------------------------------------------------------ coordinate
    def _sweep(self, ctx: List[_WindowApp], idxs: List[int], shadow: _Shadow,
               assignment: List[int], costv: List[np.ndarray]) -> None:
        """Greedy arbitration over the FULL candidate lists: each listed
        app (in req_id order) may take any strictly cheaper candidate —
        including across a leaf-region boundary — that still fits the
        shared shadow."""
        order = sorted(idxs, key=lambda i: ctx[i].placed.req_id)
        for i in order:
            wa = ctx[i]
            app = wa.placed.request.app
            costs = costv[i]
            shadow.occupy(app, wa.candidates[assignment[i]], -1.0)
            best = assignment[i]
            better = np.nonzero(costs < costs[best] - 1e-12)[0]
            if better.size:
                # Cheapest fitting candidate wins (stable sort → ties break
                # toward the lowest candidate index).
                for j in better[np.argsort(costs[better], kind="stable")]:
                    if shadow.fits(app, wa.candidates[int(j)]):
                        best = int(j)
                        break
            shadow.occupy(app, wa.candidates[best], +1.0)
            assignment[i] = best

    def _coordinate_tree(
        self,
        ctx: List[_WindowApp],
        tree: PartitionTree,
        shadow: _Shadow,
        assignment: List[int],
        costv: List[np.ndarray],
    ) -> int:
        """Shadow-ledger arbitration applied per tree level, bottom-up.

        Each app is swept exactly once, at the lowest level ≥ 1 whose
        enclosing region is *closed* (no boundary links there).  Closed
        regions at one level are resource-disjoint from everything outside
        them — candidate containment — so sweeping them region-by-region
        admits exactly the moves one flat global sweep would, and on the
        degenerate two-level tree this IS the flat sweep.  The top level
        is a single closed global region, so every app gets arbitrated.
        Returns how many apps ended up outside their home *leaf* region.
        """
        leaf = tree.leaf
        home_leaf = [leaf.region_of_node[wa.placed.candidate.node.node_id]
                     for wa in ctx]
        swept = [False] * len(ctx)
        for level in range(1, tree.n_levels):
            part = tree.levels[level]
            by_region: Dict[str, List[int]] = {}
            for i in range(len(ctx)):
                if not swept[i]:
                    by_region.setdefault(
                        tree.ancestor(home_leaf[i], level), []).append(i)
            for region in part.regions:
                if region.boundary_links:
                    continue
                idxs = by_region.get(region.region_id)
                if not idxs:
                    continue
                self._sweep(ctx, idxs, shadow, assignment, costv)
                for i in idxs:
                    swept[i] = True
        return sum(
            1 for i, wa in enumerate(ctx)
            if leaf.region_of_node[wa.candidates[assignment[i]].node.node_id]
            != home_leaf[i])


class IncrementalPolicy(DecomposedPolicy):
    """`DecomposedPolicy` with incremental mode on by default — registered
    as the ``incremental`` policy name."""

    name = "incremental"

    def __init__(self, *args, incremental: bool = True, **kwargs):
        super().__init__(*args, incremental=incremental, **kwargs)


class HierarchicalPolicy(IncrementalPolicy):
    """Incremental planning over a deep region-of-regions tree — registered
    as the ``hierarchical`` policy name.

    Below ``hierarchy_min_nodes`` devices the tree stays the degenerate
    ``[leaf, global]`` shape, making this policy byte-identical to
    ``incremental`` (and hence ``decomposed``) on paper-scale topologies —
    the parity the scale sweep asserts.  Above it, leaf regions are
    coarsened in sorted runs of ``group_size`` per parent until the tree
    converges, enabling per-level arbitration and the quiet-subtree
    wholesale skip."""

    name = "hierarchical"

    def __init__(self, *args, hierarchy_min_nodes: int = 4000,
                 group_size: int = 16, **kwargs):
        super().__init__(*args, group_size=group_size, **kwargs)
        self.hierarchy_min_nodes = hierarchy_min_nodes

    def _tree_params(self, topo: Topology) -> Tuple[Optional[int],
                                                    Optional[int],
                                                    Optional[int]]:
        gs = self.group_size \
            if len(topo.nodes) >= self.hierarchy_min_nodes else None
        return (self.max_region_nodes, self.k_regions, gs)
