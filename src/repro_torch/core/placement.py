"""First-come-first-served initial placement (paper §3.3, 新規配置).

Each arriving request is solved alone under constraints (2)–(5): filter
candidates by the user's upper bounds, drop those that would exceed any
remaining device/link capacity, and minimize the user's objective metric.
For a single app with one-hot candidates that argmin IS the LP optimum;
`place_via_milp` routes through the full MILP machinery so tests can assert
the equivalence.

The engine owns the fleet occupancy state and is shared with the
reconfiguration layer (`core.reconfig`) and the accelerator-fleet scheduler
(`core.cluster`).

Admission fast path (struct-of-arrays).  Occupancy lives in numpy arrays
over *interned* node/link integer indexes (`node_used` / `link_used` /
`link_reserved` stay visible as dict-compatible views).  Candidate
enumeration is memoized per uplink *chain* (`_ChainTemplate`): every input
site below the same user-edge site shares one template holding the
per-candidate node-index column, a CSR link-index matrix, and the static
capacity/price vectors, so `place()` prices a request with a handful of
small array ops — requirement bounds, offline bitmask, capacity broadcast
minus usage, then a lexicographic argmin — with no per-candidate Python
`fits()` loop.  `place_scalar` retains the scalar reference implementation
(`admission_mode="scalar"`); property tests and the benchmark smoke gate
assert the two paths decide identically.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from collections.abc import Mapping, MutableMapping
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np

from .apps import (
    OBJ_PRICE,
    OBJ_RESPONSE,
    AppProfile,
    Candidate,
    PlacementRequest,
    enumerate_candidates,
)
from .lp import AppVars, build_joint_milp, filter_candidates
from .solver import solve_milp
from .topology import TIER_INPUT, Topology


STATE_PLACED = "placed"
STATE_MIGRATING = "migrating"

#: Rejected-request ring size: `rejected` is only ever read for recent
#: entries and counts (`rejected_total` carries the monotonic total), so
#: long planetary runs no longer grow it without bound.
REJECTED_KEEP = 1024


class ChangeRecord(NamedTuple):
    """One engine mutation and the resources it touched — the unit of the
    per-tick change journal incremental planners consume (arrivals,
    departures, drifts = release+place pairs, failures, recoveries, move
    lifecycle steps, and transfer bandwidth reservations).  A NamedTuple:
    one record is minted per admission, so construction sits on the
    arrival fast path."""

    kind: str
    req_id: Optional[int]
    nodes: Tuple[str, ...]
    links: Tuple[str, ...]


class ChangeJournal:
    """Bounded append-only log of engine mutations.

    Consumers keep a cursor (a value of ``total``) and ask for everything
    ``since`` it; when the ring has dropped entries past a cursor the
    journal answers ``None`` — "I can't tell you what changed, treat the
    whole fleet as dirty"."""

    def __init__(self, maxlen: int = 100_000) -> None:
        self._q: deque = deque(maxlen=maxlen)
        self.total = 0

    def record(self, kind: str, req_id: Optional[int] = None,
               nodes: Sequence[str] = (), links: Sequence[str] = ()) -> None:
        self._q.append(ChangeRecord(kind, req_id, tuple(nodes), tuple(links)))
        self.total += 1

    @property
    def start(self) -> int:
        """Cursor of the oldest retained entry."""
        return self.total - len(self._q)

    def since(self, cursor: int) -> Optional[List[ChangeRecord]]:
        """Entries appended after ``cursor``; None when the ring already
        dropped some of them (the caller must invalidate everything)."""
        if cursor < self.start:
            return None
        if cursor >= self.total:
            return []
        return list(itertools.islice(self._q, cursor - self.start, None))


class LedgerView(MutableMapping):
    """Dict-compatible view over one occupancy array.

    The engine's ground truth is the numpy array (`PlacementEngine` keeps
    ``node_used``/``link_used``/``link_reserved`` as arrays over interned
    indexes); this view preserves the historical dict API — ``engine.
    node_used[node_id]``, ``dict(engine.node_used)``, ``== other_dict`` —
    without copying."""

    __slots__ = ("_ids", "_index", "_arr", "_mirror", "_on_write")

    def __init__(self, ids: Sequence[str], index: Dict[str, int],
                 arr: np.ndarray, mirror: Optional[List[float]] = None,
                 on_write=None) -> None:
        self._ids = ids
        self._index = index
        self._arr = arr
        # Plain-list shadow of the array kept in lockstep (see
        # PlacementEngine: the admission probe walk reads the lists to
        # skip numpy scalar boxing).
        self._mirror = mirror
        # Engine hook: direct writes may *increase* capacity, which must
        # invalidate the monotone last-winner cache (`_cap_epoch`).
        self._on_write = on_write

    def __getitem__(self, key: str) -> float:
        return float(self._arr[self._index[key]])

    def __setitem__(self, key: str, value: float) -> None:
        i = self._index[key]
        self._arr[i] = value
        if self._mirror is not None:
            self._mirror[i] = float(value)
        if self._on_write is not None:
            self._on_write()

    def __delitem__(self, key: str) -> None:
        raise TypeError("ledger keys are fixed by the topology")

    def __iter__(self):
        return iter(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, key) -> bool:
        return key in self._index

    def __eq__(self, other) -> bool:
        if isinstance(other, (Mapping, dict)):
            return dict(self) == dict(other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"LedgerView({dict(self)!r})"


@dataclasses.dataclass
class CandidateSet:
    """A request's feasibility-filtered candidates plus pre-extracted
    per-candidate metric arrays (hot-path vectorization: policies and the
    MILP builder consume the arrays instead of touching attributes).

    Engine-built sets also carry the interned columns the vectorized
    admission path masks over — ``node_idx_arr`` (node index per
    candidate) and the CSR link-index matrix (``link_row``/``link_col``:
    one entry per path link, row = candidate index) — plus the
    *pre-filter* resource footprint (``touched_nodes``/``touched_links``)
    the O(Δ) cache invalidation reverse index is keyed on (it must cover
    resources that were offline-filtered out at build time, so a recovery
    evicts entries that omitted the recovered resource)."""

    cands: List[Candidate]
    response_arr: np.ndarray       # response_s per candidate
    price_arr: np.ndarray          # price per candidate
    node_id_arr: np.ndarray        # node_id per candidate ('<U' array)
    index_of: Dict[str, int]       # node_id -> candidate index
    node_idx_arr: Optional[np.ndarray] = None   # interned node index
    link_row: Optional[np.ndarray] = None       # CSR row (candidate) per entry
    link_col: Optional[np.ndarray] = None       # CSR interned link index
    touched_nodes: Tuple[str, ...] = ()
    touched_links: Tuple[str, ...] = ()
    _moved_masks: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def moved_mask(self, node_id: str) -> np.ndarray:
        """Boolean mask of candidates NOT on ``node_id`` (the move-penalty
        mask), cached per current node — string comparison over the
        candidate array is a measurable per-tick cost at fleet scale."""
        m = self._moved_masks.get(node_id)
        if m is None:
            m = self.node_id_arr != node_id
            self._moved_masks[node_id] = m
        return m


def _make_candidate_set(cands: List[Candidate]) -> CandidateSet:
    k = len(cands)
    return CandidateSet(
        cands=cands,
        response_arr=np.fromiter((c.response_s for c in cands), np.float64, k),
        price_arr=np.fromiter((c.price for c in cands), np.float64, k),
        node_id_arr=np.array([c.node.node_id for c in cands]) if k
        else np.array([], dtype=str),
        index_of={c.node.node_id: j for j, c in enumerate(cands)},
    )


@dataclasses.dataclass
class _ChainTemplate:
    """Online-state-independent candidate enumeration for one uplink chain
    × device-kind tuple, in exact `enumerate_candidates` order.

    Shared by every input site whose free attachment hangs below the same
    user-edge site (the chain and its priced links are identical), so the
    per-arrival admission decision needs no re-enumeration at all: metrics
    come from the signature-shared decision cache, and feasibility is a
    scalar-indexed probe of the interned occupancy arrays.  The numpy
    columns the candidate-set builder masks over are materialized lazily
    (`np_cols`) — the admission walk never needs them, and building them
    eagerly would dominate template construction at planetary scale."""

    # (slice, path links, device kind, capacities, monthly prices)
    groups: List[Tuple[slice, Tuple, str, List[float], List[float]]]
    nodes: List                    # DeviceNode per candidate
    links_of: List[Tuple]          # path links tuple per candidate (shared)
    node_idx_list: List[int]       # interned node index per candidate
    node_id_list: List[str]        # node id per candidate
    link_idx_of: List[Tuple[int, ...]]   # interned path per candidate (shared)
    link_ids_of: List[Tuple[str, ...]]   # path link ids per candidate (shared)
    all_node_ids: Tuple[str, ...]  # footprint (pre-filter) for O(Δ) eviction
    all_link_ids: Tuple[str, ...]
    # Metric signature id: two templates with the same sig_id produce the
    # same per-candidate (response, price) arrays for any app — the
    # decision cache (`_build_decision`) is shared across them.
    sig_id: int
    _np_cols: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = None
    # (position, response, price) -> shared frozen Candidate for admission
    # winners (bounded; see `place`).
    cand_memo: Dict[Tuple, "Candidate"] = dataclasses.field(default_factory=dict)
    # Per-(app, requirement) decision record: ``[blocks, resp, price,
    # verified_epoch, last_winner]`` — the first three alias the
    # signature-shared decision-cache entry; the last two memoize the
    # walk result under the capacity-epoch monotonicity argument (see
    # `_decide_idx`).  last_winner: position, or -2 = "rejected".
    dec: Dict[Tuple, List] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.nodes)

    def np_cols(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(node_ids '<U', node_idx, CSR link_row, CSR link_col) — the
        vectorized-mask columns, built on first use."""
        cols = self._np_cols
        if cols is None:
            link_row: List[int] = []
            link_col: List[int] = []
            for row, lis in enumerate(self.link_idx_of):
                for li in lis:
                    link_row.append(row)
                    link_col.append(li)
            cols = (
                (np.array(self.node_id_list) if self.nodes
                 else np.array([], dtype=str)),
                np.asarray(self.node_idx_list, dtype=np.int64),
                np.asarray(link_row, dtype=np.int64),
                np.asarray(link_col, dtype=np.int64),
            )
            self._np_cols = cols
        return cols


@dataclasses.dataclass(slots=True)
class PlacedApp:
    """A running deployment and the metrics it was admitted with."""

    request: PlacementRequest
    candidate: Candidate
    # Most recent metrics (updated when the app is migrated).
    response_s: float
    price: float
    state: str = STATE_PLACED
    # Admission sequence number (== `placement_order` position order).
    # Survives migrations: ordering is by original admission.
    seq: int = 0

    @property
    def req_id(self) -> int:
        return self.request.req_id


class CapacityError(ValueError):
    pass


class PlacementEngine:
    """Fleet state: occupancy per device node / link + the placed-app registry."""

    def __init__(self, topo: Topology, allow_cpu_fallback: bool = False,
                 all_sites: bool = False,
                 admission_mode: str = "vector") -> None:
        if admission_mode not in ("vector", "scalar"):
            raise ValueError(f"bad admission_mode {admission_mode!r}")
        self.topo = topo
        self.allow_cpu_fallback = allow_cpu_fallback
        self.all_sites = all_sites
        #: "vector" = array-masked admission (default); "scalar" = the
        #: retained per-candidate reference loop (parity gates/tests).
        self.admission_mode = admission_mode
        # ---- interned resource indexes + array-backed occupancy ledger.
        # Insertion order of the topology dicts fixes the interning, so
        # index i always names the same resource for the engine's lifetime.
        self._node_ids: List[str] = list(topo.nodes)
        self._link_ids: List[str] = list(topo.links)
        self._node_idx: Dict[str, int] = {n: i for i, n in enumerate(self._node_ids)}
        self._link_idx: Dict[str, int] = {l: i for i, l in enumerate(self._link_ids)}
        self._node_cap = np.fromiter(
            (topo.nodes[n].capacity for n in self._node_ids),
            np.float64, len(self._node_ids))
        self._link_cap = np.fromiter(
            (topo.links[l].bandwidth_mbps for l in self._link_ids),
            np.float64, len(self._link_ids))
        self._node_used = np.zeros(len(self._node_ids))
        self._link_used = np.zeros(len(self._link_ids))
        # Bandwidth debited against links by active migration transfers
        # (fleet executor): couples transfer traffic to admission control.
        self._link_res = np.zeros(len(self._link_ids))
        self._node_on = np.ones(len(self._node_ids), dtype=bool)
        self._link_on = np.ones(len(self._link_ids), dtype=bool)
        # Plain-list shadows of the occupancy/online state, dual-written in
        # lockstep at every mutation funnel (`_occupy`, the `place` inline
        # admit, bandwidth reserve/release, online flips, LedgerView
        # writes).  The admission probe walk reads these: a scalar numpy
        # index boxes an np.float64 per read (~2× a list load), which
        # dominates the per-arrival walk at planetary scale.  The arrays
        # stay the vectorized ground truth; `occupancy_invariants_ok`
        # cross-checks the shadows.
        self._node_cap_l: List[float] = self._node_cap.tolist()
        self._link_cap_l: List[float] = self._link_cap.tolist()
        self._node_used_l: List[float] = [0.0] * len(self._node_ids)
        self._link_used_l: List[float] = [0.0] * len(self._link_ids)
        self._link_res_l: List[float] = [0.0] * len(self._link_ids)
        self._node_on_l: List[bool] = [True] * len(self._node_ids)
        self._link_on_l: List[bool] = [True] * len(self._link_ids)
        # Capacity epoch: bumped by every event that can *increase*
        # capacity or availability (release, unreserve, recovery, direct
        # ledger writes).  Between bumps the feasible set of any decision
        # entry only shrinks (admissions/reservations/failures are
        # monotone debits), so a cached walk winner that still fits is
        # still optimal — it was the best of a superset.  `_decide_idx`
        # exploits this to verify one candidate instead of re-walking.
        self._cap_epoch = 0
        # Dict-compatible views over the arrays (the historical API).
        self.node_used = LedgerView(self._node_ids, self._node_idx,
                                    self._node_used, self._node_used_l,
                                    self._bump_cap_epoch)
        self.link_used = LedgerView(self._link_ids, self._link_idx,
                                    self._link_used, self._link_used_l,
                                    self._bump_cap_epoch)
        self.link_reserved = LedgerView(self._link_ids, self._link_idx,
                                        self._link_res, self._link_res_l,
                                        self._bump_cap_epoch)
        self.placed: Dict[int, PlacedApp] = {}
        self.placement_order: List[int] = []   # req_ids in admission order
        # Bounded rejection ring + monotonic total (long runs only ever
        # read counts / recent entries — see REJECTED_KEEP).
        self.rejected: deque = deque(maxlen=REJECTED_KEEP)
        self.rejected_total = 0
        self.offline_nodes: Set[str] = set()   # failed nodes (fleet runtime)
        self.offline_links: Set[str] = set()   # cut links (fleet runtime)
        # Feasible-candidate cache (requests are frozen/hashable; the set
        # only depends on the request + node/link online state).  Large-
        # window policies call `enumerate_feasible` for every window app
        # every tick — without the cache that enumeration dominates plan
        # time at scale ×4/×8.  Entries carry pre-extracted metric arrays
        # plus interned index columns (`CandidateSet`).  Invalidation is
        # O(Δ): `_cand_rev_nodes`/`_cand_rev_links` map each resource to
        # the cached req_ids whose (pre-filter) candidates touch it, so an
        # online flip evicts only the blast radius instead of clearing.
        self._cand_cache: Dict[int, CandidateSet] = {}
        self._cand_rev_nodes: Dict[str, Set[int]] = {}
        self._cand_rev_links: Dict[str, Set[int]] = {}
        # Chain templates (`_ChainTemplate`), keyed by (input site, kinds).
        # Input-tier sites with a free attachment delegate to their parent
        # site's template, so the expensive build happens once per
        # user-edge chain, not once per input node.
        self._templates: Dict[Tuple[str, Tuple[str, ...]], _ChainTemplate] = {}
        # Hot alias of `_templates` keyed (delegate site, app profile): the
        # arrival path resolves its template with two dict probes, skipping
        # the per-call kinds-tuple construction (the profile determines the
        # kinds given the engine's fixed cpu-fallback setting).  Size-capped
        # like `_decisions` (rate-scaled profiles mint new keys).
        self._tpl_hot: Dict[Tuple[str, AppProfile], _ChainTemplate] = {}
        # Free-attachment delegation, resolved once per topology: input
        # sites without a priced uplink share their parent's chain (the
        # `_template_for` recursion), so the hot path keys templates by the
        # *delegate* site — one entry per user-edge chain, not per input
        # node, which is what lets first-visit arrivals skip the build.
        self._delegate_site: Dict[str, str] = {}
        for s in topo.sites.values():
            tgt = s.site_id
            while True:
                st = topo.sites[tgt]
                if (st.tier == TIER_INPUT and st.parent is not None
                        and topo.uplink_of(tgt) is None):
                    tgt = st.parent
                else:
                    break
            self._delegate_site[s.site_id] = tgt
        # Admission decision cache: per (template metric signature, app
        # profile, requirement) the requirement-feasible candidate
        # positions grouped into objective-tied blocks — see
        # `_build_decision`.  Keyed by signature rather than site so every
        # structurally identical chain (all user-edge chains of the paper
        # topology) shares one entry.  Entries depend only on immutable
        # topology prices/capacities, so they never need invalidation; the
        # cache is size-capped because rate-scaled app profiles mint new
        # keys over long runs.
        self._decisions: Dict[Tuple, Tuple] = {}
        self._sig_ids: Dict[Tuple, int] = {}
        # Per-(site, kind) template group memo: carrier/cloud sites are
        # shared by every chain below them, so their node lists, interned
        # indexes, and signature parts are computed once fleet-wide.
        self._site_groups: Dict[Tuple[str, str], Optional[Tuple]] = {}
        # Reverse placement indexes: resource -> req_ids whose *live*
        # source placement occupies it (maintained on commit / release /
        # suspend / move lifecycle), so `apps_on_node` / `apps_on_link`
        # failure eviction is proportional to the blast radius instead of
        # scanning every placed app.  `PlacedApp.seq` orders members by
        # admission (== `placement_order` order).
        self._node_apps: Dict[str, Set[int]] = {}
        self._link_apps: Dict[str, Set[int]] = {}
        self._seq = 0
        # Mutation journal: incremental planners map the entries since
        # their last plan onto partition regions and re-solve only those.
        self.journal = ChangeJournal()
        # In-flight migrations (fleet runtime): destination reservation per
        # migrating app.  While a pre-copy transfer runs, BOTH the source
        # candidate and the destination reservation are occupied (the
        # double-booking window); a suspended app (stop-and-copy) holds only
        # its destination reservation once the transfer starts.
        self.in_flight: Dict[int, Candidate] = {}
        self.suspended: Set[int] = set()       # source occupancy released

    def _bump_cap_epoch(self) -> None:
        """Invalidate the monotone last-winner cache (capacity grew)."""
        self._cap_epoch += 1

    # ----------------------------------------------------------- node state
    def set_node_online(self, node_id: str, online: bool) -> None:
        """Mark a device node failed/recovered.  Offline nodes accept no new
        placements; evicting the apps already on them is the caller's job
        (`fleet.runtime` re-places or drops them).  Cached candidate sets
        touching the node are evicted (O(Δ) — see `_cand_rev_nodes`)."""
        if node_id not in self.topo.nodes:
            raise KeyError(f"unknown node {node_id}")
        if online:
            self.offline_nodes.discard(node_id)
            self._cap_epoch += 1
        else:
            self.offline_nodes.add(node_id)
        ni = self._node_idx[node_id]
        self._node_on[ni] = online
        self._node_on_l[ni] = online
        for req_id in tuple(self._cand_rev_nodes.get(node_id, ())):
            self._evict_cand(req_id)
        self.journal.record("recovery" if online else "failure",
                            nodes=(node_id,))

    def set_link_online(self, link_id: str, online: bool) -> None:
        """Mark a link cut/repaired.  Offline links disqualify every
        candidate path crossing them; evicting the apps already routed over
        the link is the caller's job (`fleet.runtime`).  Cached candidate
        sets whose paths touch the link are evicted (O(Δ))."""
        if link_id not in self.topo.links:
            raise KeyError(f"unknown link {link_id}")
        if online:
            self.offline_links.discard(link_id)
            self._cap_epoch += 1
        else:
            self.offline_links.add(link_id)
        li = self._link_idx[link_id]
        self._link_on[li] = online
        self._link_on_l[li] = online
        for req_id in tuple(self._cand_rev_links.get(link_id, ())):
            self._evict_cand(req_id)
        self.journal.record("link_recovery" if online else "link_failure",
                            links=(link_id,))

    # ----------------------------------------- reverse placement indexes
    def _index_add(self, req_id: int, cand: Candidate) -> None:
        node_apps, link_apps = self._node_apps, self._link_apps
        members = node_apps.get(cand.node.node_id)
        if members is None:
            node_apps[cand.node.node_id] = {req_id}
        else:
            members.add(req_id)
        for l in cand.links:
            members = link_apps.get(l.link_id)
            if members is None:
                link_apps[l.link_id] = {req_id}
            else:
                members.add(req_id)

    def _index_discard(self, req_id: int, cand: Candidate) -> None:
        members = self._node_apps.get(cand.node.node_id)
        if members is not None:
            members.discard(req_id)
        for l in cand.links:
            members = self._link_apps.get(l.link_id)
            if members is not None:
                members.discard(req_id)

    def in_admission_order(self, req_ids) -> List[int]:
        """The currently-placed subset of ``req_ids`` sorted by admission
        order (== their `placement_order` positions), via the O(1)
        per-app admission sequence numbers (`PlacedApp.seq`)."""
        placed = self.placed
        return sorted((r for r in req_ids if r in placed),
                      key=lambda r: placed[r].seq)

    def apps_on_node(self, node_id: str) -> List[int]:
        """req_ids whose *source* copy lives on ``node_id`` (admission
        order).  Suspended apps hold no source copy; in-flight destination
        reservations are tracked separately (`migrations_to_node`).
        Served from the node→apps reverse index — O(apps on the node)."""
        members = self._node_apps.get(node_id)
        if not members:
            return []
        placed = self.placed
        return sorted((r for r in members if r not in self.suspended),
                      key=lambda r: placed[r].seq)

    def apps_on_link(self, link_id: str) -> List[int]:
        """req_ids whose *live* path crosses ``link_id`` (admission order),
        skipping suspended apps (no live path) and mid-migration apps (the
        executor's failure hooks deal with their transfers).  Served from
        the link→apps reverse index — O(apps on the link)."""
        members = self._link_apps.get(link_id)
        if not members:
            return []
        placed = self.placed
        return sorted((r for r in members if not self.is_migrating(r)),
                      key=lambda r: placed[r].seq)

    def migrations_to_node(self, node_id: str) -> List[int]:
        """req_ids with an in-flight destination reservation on ``node_id``."""
        return sorted(r for r, cand in self.in_flight.items()
                      if cand.node.node_id == node_id)

    # ------------------------------------------------------------ capacity
    def node_remaining(self, node_id: str) -> float:
        i = self._node_idx[node_id]
        return float(self._node_cap[i] - self._node_used[i])

    def link_remaining(self, link_id: str) -> float:
        """Residual link bandwidth net of app traffic AND migration
        reservations (bandwidth-reserving transfers)."""
        i = self._link_idx[link_id]
        return float((self._link_cap[i] - self._link_used[i])
                     - self._link_res[i])

    def link_capacity_remaining(self) -> Tuple[np.ndarray, np.ndarray]:
        """(capacity, remaining) arrays over every link in topology order
        — the vectorized form of per-link `link_remaining` sweeps
        (per-tick utilization metrics)."""
        return self._link_cap, (self._link_cap - self._link_used) - self._link_res

    def fits(self, request: PlacementRequest, cand: Candidate) -> bool:
        # Probes the plain-list ledger shadows (lockstep with the arrays
        # and the offline sets — same IEEE doubles, no np.float64 boxing).
        ni = self._node_idx[cand.node.node_id]
        if (not self._node_on_l[ni]
                or self._node_cap_l[ni] - self._node_used_l[ni]
                < request.app.device_usage - 1e-9):
            return False
        lidx = self._link_idx
        on, cap = self._link_on_l, self._link_cap_l
        used, res = self._link_used_l, self._link_res_l
        bw = request.app.bandwidth_mbps - 1e-9
        for link in cand.links:
            i = lidx[link.link_id]
            if not on[i] or (cap[i] - used[i]) - res[i] < bw:
                return False
        return True

    def intern_links(self, link_ids: Sequence[str]) -> Tuple[int, ...]:
        """Interned indexes for a link-id path — callers that reserve the
        same path repeatedly (the migration executor's fair-share re-debit
        on every contention change) cache this to skip the id lookups."""
        idx = self._link_idx
        return tuple(idx[lid] for lid in link_ids)

    def reserve_link_bandwidth(
        self, link_ids: Sequence[str], mbps: float,
        link_idx: Optional[Sequence[int]] = None,
    ) -> Dict[str, float]:
        """Debit up to ``mbps`` of transfer bandwidth on each link (clamped
        to the current residual, never negative) so in-flight migrations
        compete with app traffic for admission.  Returns the per-link
        amounts actually reserved — pass the dict back to
        `release_link_bandwidth` on commit/abort/cancel.  ``link_idx``
        (from `intern_links`) skips the per-link id lookups."""
        if link_idx is None:
            link_idx = self.intern_links(link_ids)
        cap, used, res = self._link_cap, self._link_used, self._link_res
        res_l = self._link_res_l
        out: Dict[str, float] = {}
        for lid, i in zip(link_ids, link_idx):
            rem = float((cap[i] - used[i]) - res[i])
            amt = min(mbps, max(rem, 0.0))
            if amt > 0.0:
                res[i] += amt
                res_l[i] += amt
                out[lid] = amt
        if out:
            self.journal.record("reserve", links=tuple(out))
        return out

    def release_link_bandwidth(self, reserved: Dict[str, float]) -> None:
        res, res_l, idx = self._link_res, self._link_res_l, self._link_idx
        for lid, amt in reserved.items():
            i = idx[lid]
            val = max(float(res[i]) - amt, 0.0)
            res[i] = val
            res_l[i] = val
        if reserved:
            self._cap_epoch += 1
            self.journal.record("unreserve", links=tuple(reserved))

    def _occupy(self, request: PlacementRequest, cand: Candidate, sign: float) -> None:
        if sign < 0:
            self._cap_epoch += 1
        ni = self._node_idx[cand.node.node_id]
        du = sign * request.app.device_usage
        self._node_used[ni] += du
        self._node_used_l[ni] += du
        used, used_l, idx = self._link_used, self._link_used_l, self._link_idx
        dbw = sign * request.app.bandwidth_mbps
        for link in cand.links:
            i = idx[link.link_id]
            used[i] += dbw
            used_l[i] += dbw

    def _journal(self, kind: str, req_id: int, *cands: Candidate) -> None:
        """Record a placement mutation touching the given candidates'
        resources (node + uplink path per candidate)."""
        nodes = tuple(c.node.node_id for c in cands)
        links = tuple(l.link_id for c in cands for l in c.links)
        self.journal.record(kind, req_id=req_id, nodes=nodes, links=links)

    # --------------------------------------------------- chain templates
    def _kinds_for(self, request: PlacementRequest) -> Tuple[str, ...]:
        app = request.app
        if self.allow_cpu_fallback and app.cpu_proc_time_s:
            return (app.device_kind, "cpu")
        return (app.device_kind,)

    def _template_for(self, input_site: str,
                      kinds: Tuple[str, ...]) -> _ChainTemplate:
        key = (input_site, kinds)
        tpl = self._templates.get(key)
        if tpl is None:
            site = self.topo.sites[input_site]
            if (site.tier == TIER_INPUT and site.parent is not None
                    and self.topo.uplink_of(input_site) is None):
                # Free input attachment: candidates/paths are identical to
                # the parent site's — share one template per chain.
                tpl = self._template_for(site.parent, kinds)
            else:
                tpl = self._build_template(input_site, kinds)
            self._templates[key] = tpl
        return tpl

    def _site_group(self, site_id: str, kind: str) -> Optional[Tuple]:
        """Memoized per-(site, kind) group: (nodes, caps, prices, node ids,
        interned node indexes, signature part) — or None when the site has
        no servers of that kind."""
        key = (site_id, kind)
        grp = self._site_groups.get(key, False)
        if grp is False:
            site_nodes = self.topo.nodes_at(site_id, kind)
            if not site_nodes:
                grp = None
            else:
                caps = [n.capacity for n in site_nodes]
                prcs = [n.monthly_price for n in site_nodes]
                grp = (
                    site_nodes, caps, prcs,
                    [n.node_id for n in site_nodes],
                    [self._node_idx[n.node_id] for n in site_nodes],
                    (kind, tuple(caps), tuple(prcs)),
                )
            self._site_groups[key] = grp
        return grp

    def _chain_sites(self, input_site: str) -> List[Tuple[str, Tuple]]:
        """(site_id, uplink path) pairs in `enumerate_candidates` order."""
        topo = self.topo
        if self.all_sites:
            return [(sid, topo.path_between(input_site, sid))
                    for sid in sorted(s.site_id for s in topo.sites.values()
                                      if s.tier != TIER_INPUT)]
        out: List[Tuple[str, Tuple]] = []
        path: List = []
        for sid in topo.ancestors(input_site):
            if topo.sites[sid].tier != TIER_INPUT:
                out.append((sid, tuple(path)))
            up = topo.uplink_of(sid)
            if up is not None:   # input→user-edge hop has no Link: free
                path.append(up)
        return out

    def _build_template(self, input_site: str,
                        kinds: Tuple[str, ...]) -> _ChainTemplate:
        groups: List[Tuple[slice, Tuple, str, List[float], List[float]]] = []
        nodes: List = []
        links_of: List[Tuple] = []
        node_ids: List[str] = []
        node_idx: List[int] = []
        link_idx_of: List[Tuple[int, ...]] = []
        link_ids_of: List[Tuple[str, ...]] = []
        touched_links: List[str] = []
        seen_links: Set[str] = set()
        sig: List[Tuple] = []
        link_interned = self._link_idx
        pos = 0
        for site_id, path in self._chain_sites(input_site):
            lids = tuple(l.link_id for l in path)
            lis = tuple(link_interned[lid] for lid in lids)
            for l in path:
                if l.link_id not in seen_links:
                    seen_links.add(l.link_id)
                    touched_links.append(l.link_id)
            path_sig = tuple((l.monthly_price, l.bandwidth_mbps) for l in path)
            for kind in kinds:
                grp = self._site_group(site_id, kind)
                if grp is None:
                    continue
                site_nodes, caps, prcs, ids, idxs, kind_sig = grp
                k = len(site_nodes)
                groups.append((slice(pos, pos + k), path, kind, caps, prcs))
                pos += k
                nodes.extend(site_nodes)
                node_ids.extend(ids)
                node_idx.extend(idxs)
                links_of.extend([path] * k)
                link_idx_of.extend([lis] * k)
                link_ids_of.extend([lids] * k)
                sig.append((kind_sig, path_sig))
        return _ChainTemplate(
            groups=groups,
            nodes=nodes,
            links_of=links_of,
            node_idx_list=node_idx,
            node_id_list=node_ids,
            link_idx_of=link_idx_of,
            link_ids_of=link_ids_of,
            all_node_ids=tuple(node_ids),
            all_link_ids=tuple(touched_links),
            sig_id=self._sig_ids.setdefault(tuple(sig), len(self._sig_ids)),
        )

    def _template_metrics(
        self, request: PlacementRequest, tpl: _ChainTemplate
    ) -> Tuple[List[float], List[float]]:
        """Per-candidate (response_s, price) over the template, with the
        exact float-op order of `apps.response_time`/`apps.price` so the
        values are bit-identical to the scalar enumeration the
        tie-breaking argmin depends on.  Runs once per (signature, app,
        requirement) — the decision cache amortizes it away."""
        app = request.app
        resp = [0.0] * tpl.n
        price = [0.0] * tpl.n
        t_link = app.data_mb * 8.0 / app.bandwidth_mbps
        u, bw = app.device_usage, app.bandwidth_mbps
        for sl, path, kind, caps, prcs in tpl.groups:
            proc = (app.proc_time_s if kind == app.device_kind
                    else app.cpu_proc_time_s)
            transfer = 0.0
            for _ in path:
                transfer += t_link
            r = proc + transfer
            for i, j in enumerate(range(sl.start, sl.stop)):
                p = prcs[i] * (u / caps[i])
                for l in path:
                    p += l.monthly_price * (bw / l.bandwidth_mbps)
                resp[j] = r
                price[j] = p
        return resp, price

    def _requirement_idx(self, request: PlacementRequest,
                         resp: List[float], price: List[float]) -> List[int]:
        """Positions passing constraints (2)–(3): the user's upper bounds
        (same 1e-9 tolerance as `apps.feasible`)."""
        r_up = request.requirement.r_upper
        p_up = request.requirement.p_upper
        return [j for j in range(len(resp))
                if (r_up is None or resp[j] <= r_up + 1e-9)
                and (p_up is None or price[j] <= p_up + 1e-9)]

    # ----------------------------------------------------------- placement
    def enumerate_feasible(self, request: PlacementRequest) -> List[Candidate]:
        """Constraints (2)–(3) + node/link-online filter, *ignoring*
        capacity — the candidate set reconfiguration policies optimize
        over.  Cached per request until the online state changes; callers
        get a fresh list (candidates themselves are immutable)."""
        return list(self.candidate_set(request).cands)

    def candidate_set(self, request: PlacementRequest) -> CandidateSet:
        """`enumerate_feasible` plus the cached per-candidate metric arrays
        (response/price/node-id) and interned index columns — the form the
        vectorized policies, the admission fast path, and the MILP builder
        consume.  The returned object is shared: callers must not mutate
        it."""
        cached = self._cand_cache.get(request.req_id)
        if cached is None:
            cached = self._build_candidate_set(request)
            self._cand_cache[request.req_id] = cached
            self._register_cand(request.req_id, cached)
        return cached

    def _build_candidate_set(self, request: PlacementRequest) -> CandidateSet:
        """Template-driven `CandidateSet` build: metrics vectorized over
        the chain template, `Candidate` objects constructed only for the
        requirement- and online-feasible survivors — content-identical to
        ``filter_candidates(enumerate_candidates(...))`` minus offline
        resources."""
        tpl = self._template_for(request.input_site, self._kinds_for(request))
        resp, price = self._template_metrics(request, tpl)
        node_ids_arr, node_idx_arr, tpl_row, tpl_col = tpl.np_cols()
        keep = np.zeros(tpl.n, dtype=bool)
        keep[self._requirement_idx(request, resp, price)] = True
        keep &= self._node_on[node_idx_arr]
        if tpl_col.size:
            off = ~self._link_on[tpl_col]
            if off.any():
                keep[tpl_row[off]] = False
        sel = np.flatnonzero(keep)
        cands = [Candidate(tpl.nodes[j], tpl.links_of[j], resp[j], price[j])
                 for j in sel.tolist()]
        link_row: List[int] = []
        link_col: List[int] = []
        for row, j in enumerate(sel.tolist()):
            for li in tpl.link_idx_of[j]:
                link_row.append(row)
                link_col.append(li)
        k = len(cands)
        return CandidateSet(
            cands=cands,
            response_arr=np.array([c.response_s for c in cands]),
            price_arr=np.array([c.price for c in cands]),
            node_id_arr=(node_ids_arr[sel] if k else np.array([], dtype=str)),
            index_of={c.node.node_id: j for j, c in enumerate(cands)},
            node_idx_arr=node_idx_arr[sel],
            link_row=np.asarray(link_row, dtype=np.int64),
            link_col=np.asarray(link_col, dtype=np.int64),
            touched_nodes=tpl.all_node_ids,
            touched_links=tpl.all_link_ids,
        )

    # ------------------------------------------------ O(Δ) cache eviction
    def _register_cand(self, req_id: int, cs: CandidateSet) -> None:
        for nid in cs.touched_nodes:
            self._cand_rev_nodes.setdefault(nid, set()).add(req_id)
        for lid in cs.touched_links:
            self._cand_rev_links.setdefault(lid, set()).add(req_id)

    def _evict_cand(self, req_id: int) -> None:
        """Drop one cached candidate set AND its reverse-index entries —
        the single eviction funnel (online flips, departures, drops,
        rejections), so dead requests can no longer leak cache entries."""
        cs = self._cand_cache.pop(req_id, None)
        if cs is None:
            return
        for nid in cs.touched_nodes:
            members = self._cand_rev_nodes.get(nid)
            if members is not None:
                members.discard(req_id)
                if not members:
                    del self._cand_rev_nodes[nid]
        for lid in cs.touched_links:
            members = self._cand_rev_links.get(lid)
            if members is not None:
                members.discard(req_id)
                if not members:
                    del self._cand_rev_links[lid]

    def feasible_candidates(self, request: PlacementRequest) -> List[Candidate]:
        """Constraints (2)–(5) applied to the raw candidate set."""
        return [c for c in self.enumerate_feasible(request) if self.fits(request, c)]

    def feasible_mask(self, request: PlacementRequest,
                      cs: CandidateSet) -> np.ndarray:
        """Vectorized `fits` over an engine-built `CandidateSet`: offline
        bitmask + capacity broadcast minus usage via the interned columns.
        Bit-equivalent to calling `fits` per candidate (the property tests
        assert it)."""
        app = request.app
        ni = cs.node_idx_arr
        mask = self._node_on[ni] & (
            (self._node_cap[ni] - self._node_used[ni])
            >= app.device_usage - 1e-9)
        if cs.link_col.size:
            li = cs.link_col
            lrem = (self._link_cap[li] - self._link_used[li]) - self._link_res[li]
            bad = (~self._link_on[li]) | (lrem < app.bandwidth_mbps - 1e-9)
            if bad.any():
                mask[cs.link_row[bad]] = False
        return mask

    #: Decision-cache size cap (rate-scaled app profiles mint new keys on
    #: long runs; a full clear is cheap — entries rebuild in ~100 µs).
    _DECISION_CACHE_MAX = 262_144

    def _build_decision(self, request: PlacementRequest,
                        tpl: _ChainTemplate) -> Tuple:
        """Decision-cache entry: the requirement-feasible template
        positions sorted by the objective ``(primary, secondary)`` pair and
        grouped into *tie blocks* of exactly equal metrics, plus the
        per-position metric floats.

        Walking the blocks in order and picking, inside the first block
        with any fitting position, the fitting position with the smallest
        node id reproduces ``min(feasible_candidates, key=(primary,
        secondary, node_id))`` — the scalar path — exactly.  Tie blocks
        (not a flat sorted list) keep the entry valid for *every* template
        sharing the metric signature: the node-id comparison happens at
        walk time against the live template's ids."""
        if not tpl.n:
            return ()
        resp, price = self._template_metrics(request, tpl)
        idx = self._requirement_idx(request, resp, price)
        if not idx:
            return ()
        if request.requirement.objective == OBJ_RESPONSE:
            key = lambda j: (resp[j], price[j])
        else:
            key = lambda j: (price[j], resp[j])
        blocks: List[Tuple[int, ...]] = []
        run: List[int] = []
        run_key = None
        for j in sorted(idx, key=key):   # stable: ties keep position order
            kj = key(j)
            if kj != run_key:
                if run:
                    blocks.append(tuple(run))
                run, run_key = [], kj
            run.append(j)
        blocks.append(tuple(run))
        return (tuple(blocks), tuple(resp), tuple(price))

    def _decide_idx(self, request: PlacementRequest) -> Optional[Tuple]:
        """Array-ledger admission decision: ``(template, position, response,
        price)`` of the winning candidate, or None, without touching engine
        state.  The objective ordering comes from the signature-shared
        decision cache; the walk checks online + capacity directly against
        the interned occupancy arrays, so the common uncontended arrival
        resolves with one block probe."""
        app = request.app
        tkey = (self._delegate_site[request.input_site], app)
        tpl = self._tpl_hot.get(tkey)
        if tpl is None:
            if self.allow_cpu_fallback and app.cpu_proc_time_s:
                kinds: Tuple[str, ...] = (app.device_kind, "cpu")
            else:
                kinds = (app.device_kind,)
            tpl = self._template_for(tkey[0], kinds)
            if len(self._tpl_hot) >= self._DECISION_CACHE_MAX:
                self._tpl_hot.clear()
            self._tpl_hot[tkey] = tpl
        dec = tpl.dec
        dkey = (app, request.requirement)
        rec = dec.get(dkey)
        if rec is None:
            decisions = self._decisions
            skey = (tpl.sig_id, app, request.requirement)
            entry = decisions.get(skey)
            if entry is None:
                if len(decisions) >= self._DECISION_CACHE_MAX:
                    decisions.clear()
                entry = self._build_decision(request, tpl)
                decisions[skey] = entry
            if len(dec) >= 512:   # rate-scaled profiles mint new keys
                dec.clear()
            if entry:
                rec = [entry[0], entry[1], entry[2], -1, -1]
            else:
                rec = [(), (), (), -1, -1]
            dec[dkey] = rec
        blocks = rec[0]
        if not blocks:
            return None
        u_thr = app.device_usage - 1e-9
        b_thr = app.bandwidth_mbps - 1e-9
        # Probe the plain-list shadows (same IEEE doubles as the arrays,
        # kept in lockstep): scalar numpy indexing would box a np.float64
        # per read, ~2× the cost at this call rate.
        node_on, node_cap, node_used = (
            self._node_on_l, self._node_cap_l, self._node_used_l)
        link_on, link_cap = self._link_on_l, self._link_cap_l
        link_used, link_res = self._link_used_l, self._link_res_l
        nlist = tpl.node_idx_list
        lis_of = tpl.link_idx_of
        epoch = self._cap_epoch
        if rec[3] == epoch:
            # No capacity-increasing event since the last walk for this
            # record, so the feasible set only shrank and the cached
            # winner — the best of that superset — stays optimal as long
            # as it still fits.  Cached rejections stay rejections.
            j = rec[4]
            if j == -2:
                return None
            ni = nlist[j]
            if node_on[ni] and node_cap[ni] - node_used[ni] >= u_thr:
                ok = True
                for li in lis_of[j]:
                    if (not link_on[li] or
                            (link_cap[li] - link_used[li]) - link_res[li] < b_thr):
                        ok = False
                        break
                if ok:
                    return tpl, j, rec[1][j], rec[2][j]
        ids = tpl.node_id_list
        for blk in blocks:
            best_j = -1
            best_id = None
            for j in blk:
                ni = nlist[j]
                if not node_on[ni] or node_cap[ni] - node_used[ni] < u_thr:
                    continue
                fits = True
                for li in lis_of[j]:
                    if (not link_on[li] or
                            (link_cap[li] - link_used[li]) - link_res[li] < b_thr):
                        fits = False
                        break
                if not fits:
                    continue
                nid = ids[j]
                if best_id is None or nid < best_id:
                    best_j, best_id = j, nid
            if best_j >= 0:
                rec[3] = epoch
                rec[4] = best_j
                return tpl, best_j, rec[1][best_j], rec[2][best_j]
        rec[3] = epoch
        rec[4] = -2
        return None

    def _decide(self, request: PlacementRequest) -> Optional[Candidate]:
        """`_decide_idx` materialized as a `Candidate` (parity tests)."""
        hit = self._decide_idx(request)
        if hit is None:
            return None
        tpl, j, resp, price = hit
        return Candidate(tpl.nodes[j], tpl.links_of[j], resp, price)

    def _record_rejection(self, request: PlacementRequest) -> None:
        self.rejected.append(request)
        self.rejected_total += 1

    def place(self, request: PlacementRequest) -> Optional[PlacedApp]:
        """Sequential LP placement.  Returns None (and records the
        rejection) when no candidate satisfies (2)–(5).  Dispatches to the
        vectorized template path (`_decide`) or the retained scalar
        reference (`place_scalar`) per ``admission_mode`` — both decide
        identically (property-tested + smoke-gated)."""
        if self.admission_mode != "vector":
            return self.place_scalar(request)
        hit = self._decide_idx(request)
        if hit is None:
            self._record_rejection(request)
            self._evict_cand(request.req_id)   # dead request: no re-plan
            return None
        # `_decide_idx` just verified capacity against the live ledger, so
        # the `commit` fits re-check is skipped, and the `_admit`
        # bookkeeping is inlined over the template's interned columns —
        # this is the steady-state arrival hot path.
        tpl, j, resp, price = hit
        app = request.app
        req_id = request.req_id
        # Winning candidates recur (few distinct (app, requirement) pairs
        # per chain), so they are memoized per template — `Candidate` is
        # frozen/immutable and safely shared across placements.
        memo = tpl.cand_memo
        ck = (j, resp, price)
        cand = memo.get(ck)
        if cand is None:
            if len(memo) >= 256:   # rate-scaled profiles mint new metrics
                memo.clear()
            cand = Candidate(tpl.nodes[j], tpl.links_of[j], resp, price)
            memo[ck] = cand
        ni = tpl.node_idx_list[j]
        u = app.device_usage
        self._node_used[ni] += u
        self._node_used_l[ni] += u
        link_used, link_used_l = self._link_used, self._link_used_l
        bw = app.bandwidth_mbps
        for li in tpl.link_idx_of[j]:
            link_used[li] += bw
            link_used_l[li] += bw
        placed = PlacedApp(request, cand, resp, price)
        placed.seq = self._seq
        self._seq += 1
        self.placed[req_id] = placed
        self.placement_order.append(req_id)
        nid = tpl.node_id_list[j]
        members = self._node_apps.get(nid)
        if members is None:
            self._node_apps[nid] = {req_id}
        else:
            members.add(req_id)
        link_apps = self._link_apps
        lids = tpl.link_ids_of[j]
        for lid in lids:
            members = link_apps.get(lid)
            if members is None:
                link_apps[lid] = {req_id}
            else:
                members.add(req_id)
        # Inlined `journal.record` (call + kwargs overhead matters here).
        jrnl = self.journal
        jrnl._q.append(ChangeRecord("arrival", req_id, (nid,), lids))
        jrnl.total += 1
        return placed

    def decide_scalar(self, request: PlacementRequest) -> Optional[Candidate]:
        """The scalar reference admission *decision*, kept byte-for-byte at
        the pre-vectorization algorithm: fresh per-request candidate
        enumeration (`apps.enumerate_candidates` + requirement/offline
        filters + `_make_candidate_set`), a per-candidate `fits` loop, and
        a tuple-key `min`.  Pure — no engine mutation — so the admission
        bench can time it against `_decide` on identical occupancy.  It is
        both the decision-parity oracle for `place` (property-tested +
        smoke-gated) and the honest pre-vectorization cost baseline the
        `admission` bench rows measure the speedup against — it
        deliberately shares none of the chain-template/decision-cache
        machinery.  (The set is rebuilt per call, not `_cand_cache`d:
        arrivals are fresh req_ids, so the historical cache never hit on
        this path anyway.)"""
        cands = enumerate_candidates(self.topo, request, self.allow_cpu_fallback,
                                     all_sites=self.all_sites)
        cands = filter_candidates(request, cands)
        cands = [c for c in cands
                 if c.node.node_id not in self.offline_nodes
                 and not any(l.link_id in self.offline_links for l in c.links)]
        cs = _make_candidate_set(cands)
        cands = [c for c in cs.cands if self.fits(request, c)]
        if not cands:
            return None
        if request.requirement.objective == OBJ_RESPONSE:
            key = lambda c: (c.response_s, c.price, c.node.node_id)
        else:
            key = lambda c: (c.price, c.response_s, c.node.node_id)
        return min(cands, key=key)

    def place_scalar(self, request: PlacementRequest) -> Optional[PlacedApp]:
        """`decide_scalar` + rejection bookkeeping + `commit` — the full
        scalar reference admission path."""
        best = self.decide_scalar(request)
        if best is None:
            self._record_rejection(request)
            self._evict_cand(request.req_id)   # dead request: no re-plan
            return None
        return self.commit(request, best)

    def place_via_milp(self, request: PlacementRequest, backend: str = "auto") -> Optional[PlacedApp]:
        """Same decision through the joint-MILP path (validation aid)."""
        cands = self.feasible_candidates(request)
        if not cands:
            self._record_rejection(request)
            self._evict_cand(request.req_id)
            return None
        # Single-app window: encode objective metric via r/p_before = 1 and
        # zeroing the other term by scaling; simplest is direct coefficients.
        av = AppVars(request, cands, None, 1.0, 1.0)
        node_cap, link_cap = self._remaining_dicts()
        problem, index = build_joint_milp([av], node_cap, link_cap)
        want_resp = request.requirement.objective == OBJ_RESPONSE
        problem.c = np.array(
            [c.response_s if want_resp else c.price for c in cands], dtype=np.float64
        )
        res = solve_milp(problem, backend=backend)
        if not res.ok:
            self._record_rejection(request)
            self._evict_cand(request.req_id)
            return None
        choice = index.decode(res.x)[0]
        return self.commit(request, cands[choice])

    def commit(self, request: PlacementRequest, cand: Candidate) -> PlacedApp:
        if not self.fits(request, cand):
            raise CapacityError(f"candidate {cand.node.node_id} no longer fits")
        return self._admit(request, cand)

    def _admit(self, request: PlacementRequest, cand: Candidate) -> PlacedApp:
        """`commit` minus the fits re-check, for callers that just verified
        capacity against the unchanged ledger (the admission fast path)."""
        self._occupy(request, cand, +1.0)
        app = PlacedApp(request, cand, cand.response_s, cand.price)
        app.seq = self._seq
        self._seq += 1
        self.placed[request.req_id] = app
        self.placement_order.append(request.req_id)
        self._index_add(request.req_id, cand)
        self._journal("arrival", request.req_id, cand)
        return app

    # ------------------------------------------- migration (time-extended)
    def is_migrating(self, req_id: int) -> bool:
        """True while the app has an in-flight transfer, is suspended, or
        is marked MIGRATING with a move still waiting for capacity."""
        return (req_id in self.in_flight or req_id in self.suspended
                or self.placed[req_id].state == STATE_MIGRATING)

    def begin_move(self, req_id: int, new_cand: Candidate) -> bool:
        """Reserve ``new_cand`` for an in-flight migration of ``req_id``.

        Pre-copy semantics: the source stays occupied, so over the transfer
        window the app is double-booked.  Returns False (no state change)
        when the destination does not currently fit."""
        app = self.placed[req_id]
        if req_id in self.in_flight:
            raise ValueError(f"app {req_id} already has an in-flight move")
        if not self.fits(app.request, new_cand):
            return False
        self._occupy(app.request, new_cand, +1.0)
        self.in_flight[req_id] = new_cand
        app.state = STATE_MIGRATING
        self._journal("move_begin", req_id, new_cand)
        return True

    def commit_move(self, req_id: int) -> PlacedApp:
        """Finalize an in-flight migration: the destination reservation
        becomes the live placement and the source copy (if any) is freed."""
        app = self.placed[req_id]
        new_cand = self.in_flight.pop(req_id)
        old_cand = app.candidate
        if req_id in self.suspended:
            self.suspended.discard(req_id)   # source already released
        else:
            self._occupy(app.request, app.candidate, -1.0)
            self._index_discard(req_id, app.candidate)
        app.candidate = new_cand
        app.response_s = new_cand.response_s
        app.price = new_cand.price
        app.state = STATE_PLACED
        self._index_add(req_id, new_cand)
        self._journal("move_commit", req_id, old_cand, new_cand)
        return app

    def abort_move(self, req_id: int) -> PlacedApp:
        """Roll back an in-flight migration: drop the destination
        reservation.  A non-suspended app keeps running on its source; a
        suspended app is left homeless (the caller must re-place or drop
        it — it stays ``suspended`` until then)."""
        app = self.placed[req_id]
        new_cand = self.in_flight.pop(req_id)
        self._occupy(app.request, new_cand, -1.0)
        if req_id not in self.suspended:
            app.state = STATE_PLACED
        self._journal("move_abort", req_id, new_cand)
        return app

    def suspend(self, req_id: int) -> PlacedApp:
        """Release ``req_id``'s source occupancy (stop-and-copy: the app is
        paused and its resources freed while it waits for / runs its
        transfer).  Used to break migration cycles."""
        app = self.placed[req_id]
        if req_id in self.suspended:
            raise ValueError(f"app {req_id} already suspended")
        self._occupy(app.request, app.candidate, -1.0)
        self._index_discard(req_id, app.candidate)
        self.suspended.add(req_id)
        app.state = STATE_MIGRATING
        self._journal("suspend", req_id, app.candidate)
        return app

    def resume_at_source(self, req_id: int) -> bool:
        """Try to un-suspend ``req_id`` back onto its source candidate.
        Returns False when the freed capacity has been taken meanwhile."""
        app = self.placed[req_id]
        if not self.fits(app.request, app.candidate):
            return False
        self._occupy(app.request, app.candidate, +1.0)
        self._index_add(req_id, app.candidate)
        self.suspended.discard(req_id)
        app.state = STATE_PLACED
        self._journal("resume", req_id, app.candidate)
        return True

    def drop(self, req_id: int) -> None:
        """Remove a homeless suspended app (rollback found no capacity)."""
        if req_id not in self.suspended:
            raise ValueError(f"drop() is only for suspended apps; use release()")
        app = self.placed.pop(req_id)
        self.suspended.discard(req_id)
        dest = self.in_flight.pop(req_id, None)
        if dest is not None:
            self._occupy(app.request, dest, -1.0)
        self.placement_order.remove(req_id)
        self._record_rejection(app.request)
        self._evict_cand(req_id)
        self._journal("drop", req_id,
                      *((dest,) if dest is not None else ()))

    # ----------------------------------------------------------- migration
    def apply_move(self, req_id: int, new_cand: Candidate) -> PlacedApp:
        """Re-home a running app (capacity-checked; used by migration plans)."""
        app = self.placed[req_id]
        self._occupy(app.request, app.candidate, -1.0)
        try:
            if not self.fits(app.request, new_cand):
                raise CapacityError(
                    f"move of app {req_id} to {new_cand.node.node_id} does not fit"
                )
        except CapacityError:
            self._occupy(app.request, app.candidate, +1.0)  # roll back
            raise
        self._occupy(app.request, new_cand, +1.0)
        old_cand = app.candidate
        self._index_discard(req_id, old_cand)
        self._index_add(req_id, new_cand)
        app.candidate = new_cand
        app.response_s = new_cand.response_s
        app.price = new_cand.price
        self._journal("move", req_id, old_cand, new_cand)
        return app

    def release(self, req_id: int) -> None:
        app = self.placed.pop(req_id)
        if req_id not in self.suspended:
            self._occupy(app.request, app.candidate, -1.0)
            self._index_discard(req_id, app.candidate)
        self.suspended.discard(req_id)
        dest = self.in_flight.pop(req_id, None)
        if dest is not None:
            self._occupy(app.request, dest, -1.0)
        self.placement_order.remove(req_id)
        self._evict_cand(req_id)
        self._journal("departure", req_id, app.candidate,
                      *((dest,) if dest is not None else ()))

    def _remaining_dicts(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """(node, link) remaining-capacity dicts, computed in one array
        pass (identical values to per-id `node_remaining`/`link_remaining`)."""
        node_cap = dict(zip(self._node_ids,
                            (self._node_cap - self._node_used).tolist()))
        link_cap = dict(zip(self._link_ids,
                            ((self._link_cap - self._link_used)
                             - self._link_res).tolist()))
        return node_cap, link_cap

    def free_capacity_excluding(
        self, window: Sequence[int]
    ) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Remaining (node, link) capacity with window apps lifted out — the
        resource pool a joint re-placement of the window may use (non-window
        apps stay pinned).  Shared by the MILP and the heuristic policies."""
        node_cap, link_cap = self._remaining_dicts()
        for req_id in window:
            placed = self.placed[req_id]
            node_cap[placed.candidate.node.node_id] += placed.request.app.device_usage
            for l in placed.candidate.links:
                link_cap[l.link_id] += placed.request.app.bandwidth_mbps
        return node_cap, link_cap

    # ------------------------------------------------------------- queries
    def recent(self, n: int) -> List[int]:
        """The ``n`` most recently placed req_ids (reconfiguration window)."""
        return list(self.placement_order[-n:])

    def recent_stable(self, n: int) -> List[int]:
        """The ``n`` most recently placed req_ids that are NOT mid-migration
        — the window reconfiguration policies may plan over (in-flight apps
        are pinned until their transfer completes or aborts)."""
        stable = [r for r in self.placement_order if not self.is_migrating(r)]
        return stable[-n:]

    def occupancy_invariants_ok(self) -> bool:
        """True iff recomputing occupancy from the registry matches state."""
        node = {n: 0.0 for n in self.topo.nodes}
        link = {l: 0.0 for l in self.topo.links}
        for req_id, app in self.placed.items():
            if req_id not in self.suspended:
                node[app.candidate.node.node_id] += app.request.app.device_usage
                for l in app.candidate.links:
                    link[l.link_id] += app.request.app.bandwidth_mbps
        for req_id, cand in self.in_flight.items():
            app = self.placed[req_id]
            node[cand.node.node_id] += app.request.app.device_usage
            for l in cand.links:
                link[l.link_id] += app.request.app.bandwidth_mbps
        node_ref = np.fromiter((node[n] for n in self._node_ids),
                               np.float64, len(self._node_ids))
        link_ref = np.fromiter((link[l] for l in self._link_ids),
                               np.float64, len(self._link_ids))
        ok_n = bool(np.all(np.abs(node_ref - self._node_used) < 1e-6))
        ok_l = bool(np.all(np.abs(link_ref - self._link_used) < 1e-6))
        cap_n = bool(np.all(self._node_used <= self._node_cap + 1e-6))
        cap_l = bool(np.all(self._link_used + self._link_res
                            <= self._link_cap + 1e-6))
        res_l = bool(np.all(self._link_res >= -1e-6))
        # The plain-list shadows must be in exact lockstep with the arrays
        # (same float-op sequence at every mutation funnel).
        mirror = (self._node_used.tolist() == self._node_used_l
                  and self._link_used.tolist() == self._link_used_l
                  and self._link_res.tolist() == self._link_res_l
                  and self._node_on.tolist() == self._node_on_l
                  and self._link_on.tolist() == self._link_on_l)
        return ok_n and ok_l and cap_n and cap_l and res_l and mirror
