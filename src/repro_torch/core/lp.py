"""MILP formulation of placement/reconfiguration — paper eqs. (1)–(5).

Key structural observation (DESIGN.md §2): with a tree topology, an app's
response time (2) and price (3) are fully determined by its *candidate
placement* (node + unique uplink path).  So the decision variables are
binaries ``x[k,p]`` ("app k uses candidate p") and:

* eq. (2)/(3) user upper bounds   → pre-filtering of candidates,
* eq. (4) device capacity          → Σ_k usage·x ≤ remaining capacity,
* eq. (5) link bandwidth           → Σ_k bw·x ≤ remaining bandwidth,
* eq. (1) satisfaction objective   → c[k,p] = R_p/R_k^before + P_p/P_k^before.

The builder assembles the constraint rows as numpy scatter ops emitting
scipy CSR directly (the hot path at fleet scale — a dense row per touched
node/link was quadratic in practice); only the scipy-free fallback
materializes dense matrices, since the numpy simplex is dense anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .apps import Candidate, PlacementRequest, feasible
from .solver import MilpProblem

try:  # pragma: no cover - availability depends on environment
    from scipy import sparse as _scisparse

    _HAVE_SPARSE = True
except Exception:  # pragma: no cover
    _HAVE_SPARSE = False

OBJ_SATISFACTION = "satisfaction"


@dataclasses.dataclass
class AppVars:
    """One app's slice of the joint problem."""

    request: PlacementRequest
    candidates: List[Candidate]          # already feasibility-filtered (eqs. 2–3)
    current_node_id: Optional[str] = None  # where it runs now (reconfig only)
    r_before: Optional[float] = None
    p_before: Optional[float] = None
    # Per-candidate move penalty (aligned with ``candidates``); when set it
    # REPLACES the builder's scalar ``move_penalty`` for off-current
    # candidates — migration-aware cost models price each move's transfer
    # time individually.
    move_penalties: Optional[Sequence[float]] = None
    # Optional pre-extracted per-candidate metrics (aligned with
    # ``candidates``): response_s / price as float arrays and node ids as a
    # string array.  Policies pass the engine's cached arrays so the builder
    # skips per-candidate attribute access on the hot path.
    response_arr: Optional[np.ndarray] = None
    price_arr: Optional[np.ndarray] = None
    node_id_arr: Optional[np.ndarray] = None


@dataclasses.dataclass
class JointIndex:
    """Decoder from flat variable vector to per-app candidate choice."""

    apps: List[AppVars]
    offsets: np.ndarray  # offsets[i] = first var index of app i

    def decode(self, x: np.ndarray) -> List[int]:
        """Chosen candidate index per app (first argmax over its one-hot
        block), vectorized with reduceat over the block boundaries."""
        if not self.apps:
            return []
        x = np.asarray(x, dtype=np.float64)
        offs = np.asarray(self.offsets, dtype=np.int64)
        sizes = np.diff(np.append(offs, x.size))
        bmax = np.maximum.reduceat(x, offs)
        hit = x >= np.repeat(bmax, sizes)
        idx = np.where(hit, np.arange(x.size), x.size)
        first = np.minimum.reduceat(idx, offs) - offs
        return [int(v) for v in first]


def filter_candidates(
    request: PlacementRequest, candidates: Sequence[Candidate]
) -> List[Candidate]:
    """Apply the user's upper bounds — constraints (2) and (3)."""
    return [c for c in candidates if feasible(c, request.requirement)]


def _app_arrays(av: AppVars) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(response_s, price, node_id) arrays for one app's candidates, using
    the pre-extracted arrays when supplied."""
    k = len(av.candidates)
    if av.response_arr is not None and av.price_arr is not None \
            and av.node_id_arr is not None:
        return av.response_arr, av.price_arr, av.node_id_arr
    resp = np.fromiter((c.response_s for c in av.candidates), np.float64, k)
    price = np.fromiter((c.price for c in av.candidates), np.float64, k)
    nodes = np.array([c.node.node_id for c in av.candidates])
    return resp, price, nodes


def build_joint_milp(
    apps: Sequence[AppVars],
    node_capacity: Dict[str, float],
    link_capacity: Dict[str, float],
    move_penalty: float = 0.0,
) -> Tuple[MilpProblem, JointIndex]:
    """Build the reconfiguration MILP (objective = eq. (1) + optional
    per-move penalty modelling migration cost).

    ``node_capacity``/``link_capacity`` must already EXCLUDE usage by apps
    outside this window (eq. (4)(5) are computed "他ユーザ配置アプリ含めて").
    """
    apps = list(apps)
    if not apps:   # empty window → well-formed empty problem
        return (MilpProblem(c=np.zeros(0), A_eq=np.zeros((0, 0)),
                            b_eq=np.zeros(0), integrality=np.zeros(0)),
                JointIndex(apps=[], offsets=np.zeros(0, dtype=np.int64)))
    sizes = np.array([len(a.candidates) for a in apps], dtype=np.int64)
    if (sizes == 0).any():
        bad = [apps[i].request.req_id for i in np.nonzero(sizes == 0)[0]]
        raise ValueError(f"apps with no feasible candidates: {bad}")
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    n = int(sizes.sum())

    # Objective: per-candidate satisfaction ratio + move penalty, assembled
    # as one batched expression over the concatenated candidate arrays.
    # Per-candidate ``move_penalties`` are zero on the live candidate by
    # construction (both the policies' masked vectors and the migration
    # cost model return 0 for a same-node "move"), so they are added
    # directly; only the scalar fallback needs the moved mask.
    var_nodes: List[np.ndarray] = []
    resp_parts: List[np.ndarray] = []
    price_parts: List[np.ndarray] = []
    n_apps = len(apps)
    rb = np.empty(n_apps)
    pb = np.empty(n_apps)
    pens: Optional[np.ndarray] = None
    for i, av in enumerate(apps):
        if av.r_before is None or av.p_before is None:
            raise ValueError("reconfig objective needs r_before/p_before")
        resp, price, nodes = _app_arrays(av)
        rb[i], pb[i] = av.r_before, av.p_before
        resp_parts.append(resp)
        price_parts.append(price)
        var_nodes.append(nodes)
        if av.move_penalties is not None:
            if pens is None:
                pens = np.zeros(n)
            pens[offsets[i]:offsets[i] + sizes[i]] = \
                np.asarray(av.move_penalties, dtype=np.float64)
        elif move_penalty and av.current_node_id is not None:
            if pens is None:
                pens = np.zeros(n)
            pens[offsets[i]:offsets[i] + sizes[i]] = \
                (nodes != av.current_node_id) * move_penalty
    c = (np.concatenate(resp_parts) * np.repeat(1.0 / rb, sizes)
         + np.concatenate(price_parts) * np.repeat(1.0 / pb, sizes))
    if pens is not None:
        c += pens

    # Equality block: each app picks exactly one candidate (one 1 per var).
    eq_rows = np.repeat(np.arange(n_apps, dtype=np.int64), sizes)
    b_eq = np.ones(n_apps)

    # Capacity rows — only for resources actually touched by ≥ 1 candidate.
    # COO triplets: every variable hits its candidate's node row once and
    # each link row on the candidate's uplink path once.
    node_per_var = np.concatenate(var_nodes) if var_nodes else np.array([])
    usage_per_var = np.repeat(
        np.fromiter((a.request.app.device_usage for a in apps), np.float64, n_apps),
        sizes)
    link_ids: List[str] = []
    link_cols: List[int] = []
    for i, av in enumerate(apps):
        base = int(offsets[i])
        for j, cand in enumerate(av.candidates):
            var = base + j
            for link in cand.links:
                link_ids.append(link.link_id)
                link_cols.append(var)
    bw_per_var = np.repeat(
        np.fromiter((a.request.app.bandwidth_mbps for a in apps), np.float64, n_apps),
        sizes)

    uniq_nodes, node_row_per_var = np.unique(node_per_var, return_inverse=True)
    if link_ids:
        uniq_links, link_row = np.unique(np.array(link_ids), return_inverse=True)
    else:
        uniq_links, link_row = np.array([], dtype=str), np.array([], dtype=np.int64)
    m_nodes, m_links = len(uniq_nodes), len(uniq_links)
    m_ub = m_nodes + m_links

    ub_rows = np.concatenate([node_row_per_var,
                              m_nodes + link_row]).astype(np.int64)
    ub_cols = np.concatenate([np.arange(n, dtype=np.int64),
                              np.asarray(link_cols, dtype=np.int64)])
    ub_data = np.concatenate([usage_per_var,
                              bw_per_var[np.asarray(link_cols, dtype=np.int64)]
                              if link_cols else np.array([])])
    b_ub = np.concatenate([
        np.fromiter((node_capacity[nid] for nid in uniq_nodes), np.float64, m_nodes),
        np.fromiter((link_capacity[lid] for lid in uniq_links), np.float64, m_links),
    ])

    if _HAVE_SPARSE:
        A_ub = _scisparse.csr_matrix(
            (ub_data, (ub_rows, ub_cols)), shape=(m_ub, n)) if m_ub else None
        A_eq = _scisparse.csr_matrix(
            (np.ones(n), (eq_rows, np.arange(n))), shape=(n_apps, n))
    else:
        # Dense fallback for the numpy simplex (duplicate-safe scatter).
        A_ub = None
        if m_ub:
            A_ub = np.zeros((m_ub, n))
            np.add.at(A_ub, (ub_rows, ub_cols), ub_data)
        A_eq = np.zeros((n_apps, n))
        A_eq[eq_rows, np.arange(n)] = 1.0

    problem = MilpProblem(
        c=c,
        A_ub=A_ub,
        b_ub=b_ub if m_ub else None,
        A_eq=A_eq,
        b_eq=b_eq,
        integrality=np.ones(n),
    )
    return problem, JointIndex(apps=apps, offsets=offsets)
