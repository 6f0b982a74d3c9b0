"""MILP solver frontends.

The paper derives reconfiguration solutions with an off-the-shelf LP/MILP
solver (GLPK 5.0 / CPLEX).  Here:

* backend ``"highs"`` — `scipy.optimize.milp` (HiGHS), the drop-in analogue.
* backend ``"bnb"``   — our own branch-and-bound over the pure-numpy simplex
  (`core.simplex`), so the system works with zero external solver deps and
  the LP layer is property-testable end-to-end.
* backend ``"auto"``  — HiGHS when importable, else B&B.

Constraint matrices may be dense numpy arrays or scipy CSR (the joint-MILP
builder emits CSR when scipy is present); the B&B backend densifies once.

**Warm starts**: ``solve_milp(..., x0=…)`` accepts an incumbent assignment
(typically the previous tick's solution re-projected onto the current
candidate set).  A feasible incumbent is a *hit*: the B&B backend seeds its
upper bound with it and branches toward it, and either backend returns it
with status ``"feasible"`` when the time limit expires before optimality is
proven.  ``MilpResult.warm_start`` records ``"hit"`` / ``"miss"`` for
telemetry.

**Statuses**: ``"optimal"`` is only reported when optimality was *proven*.
An incumbent found before the deadline without proof is ``"feasible"``
(both count as ``ok``); ``"timeout"`` means the deadline passed with no
incumbent at all.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .simplex import solve_lp

try:  # pragma: no cover - availability depends on environment
    from scipy import optimize as _sciopt
    from scipy import sparse as _scisparse

    _HAVE_SCIPY = hasattr(_sciopt, "milp")
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False


def _nrows(a) -> int:
    """Row count of a dense/sparse matrix (len() is ambiguous for sparse)."""
    if a is None:
        return 0
    shape = getattr(a, "shape", None)
    if shape is not None and len(shape) == 2:
        return int(shape[0])
    return len(a)


def _dense(a) -> np.ndarray:
    """Densify a possibly-sparse matrix (no copy when already dense)."""
    if hasattr(a, "toarray"):
        return a.toarray()
    return np.asarray(a, dtype=np.float64)


@dataclasses.dataclass
class MilpProblem:
    """min c·x  s.t.  A_ub x ≤ b_ub,  A_eq x = b_eq,  0 ≤ x ≤ ub,
    x[integrality==1] ∈ ℤ.  ``A_ub``/``A_eq`` may be dense or scipy CSR."""

    c: np.ndarray
    A_ub: Optional[object] = None
    b_ub: Optional[np.ndarray] = None
    A_eq: Optional[object] = None
    b_eq: Optional[np.ndarray] = None
    ub: Optional[np.ndarray] = None          # default: 1.0 for integer vars, inf else
    integrality: Optional[np.ndarray] = None  # 1 = integer, 0 = continuous

    def n(self) -> int:
        return int(np.asarray(self.c).size)


@dataclasses.dataclass
class MilpResult:
    status: str                 # "optimal" | "feasible" | "infeasible" | "timeout" | <lp status>
    x: Optional[np.ndarray]
    objective: float
    solve_time_s: float = 0.0
    nodes_explored: int = 0     # B&B nodes (HiGHS: reported MIP node count)
    lp_iterations: int = 0      # simplex pivots summed over B&B relaxations
    warm_start: Optional[str] = None   # "hit" | "miss" | None (no x0 given)

    @property
    def ok(self) -> bool:
        """True when ``x`` is a usable (integral, feasible) assignment —
        proven optimal, or the best incumbent at the deadline."""
        return self.status in ("optimal", "feasible")


def _default_ub(p: MilpProblem) -> np.ndarray:
    ub = np.full(p.n(), np.inf)
    if p.integrality is not None:
        ub[np.asarray(p.integrality, dtype=bool)] = 1.0
    if p.ub is not None:
        ub = np.minimum(ub, p.ub)
    return ub


def _clean_x0(p: MilpProblem, x0) -> Optional[np.ndarray]:
    """Validate a warm-start incumbent: round its integer coordinates and
    check bounds + constraints.  Returns the cleaned vector, or None when
    the incumbent is not feasible for THIS problem (a warm-start miss)."""
    if x0 is None:
        return None
    x = np.asarray(x0, dtype=np.float64)
    if x.shape != (p.n(),):
        return None
    x = x.copy()
    if p.integrality is not None:
        mask = np.asarray(p.integrality, dtype=bool)
        x[mask] = np.round(x[mask])
    ub = _default_ub(p)
    if (x < -1e-9).any() or (x > ub + 1e-9).any():
        return None
    if _nrows(p.A_ub):
        if (p.A_ub @ x > np.asarray(p.b_ub) + 1e-6).any():
            return None
    if _nrows(p.A_eq):
        if np.abs(p.A_eq @ x - np.asarray(p.b_eq)).max() > 1e-6:
            return None
    return x


def solve_milp(
    problem: MilpProblem,
    backend: str = "auto",
    time_limit_s: float = 60.0,
    x0: Optional[np.ndarray] = None,
) -> MilpResult:
    if backend == "auto":
        backend = "highs" if _HAVE_SCIPY else "bnb"
    if problem.n() == 0:   # empty window → trivially optimal empty plan
        return MilpResult("optimal", np.zeros(0), 0.0,
                          warm_start=None if x0 is None else "hit")
    inc = _clean_x0(problem, x0)
    if backend == "highs":
        res = _solve_highs(problem, time_limit_s, inc)
    elif backend == "bnb":
        res = _solve_bnb(problem, time_limit_s, inc)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if x0 is not None:
        res.warm_start = "hit" if inc is not None else "miss"
    return res


# ----------------------------------------------------------------- HiGHS ---
def _solve_highs(p: MilpProblem, time_limit_s: float,
                 inc: Optional[np.ndarray] = None) -> MilpResult:
    t0 = time.perf_counter()
    n = p.n()
    c = np.asarray(p.c, dtype=np.float64)
    # One combined constraint block (CSR passed through untouched) keeps
    # scipy's per-call validation/conversion off the hot path.
    m_ub, m_eq = _nrows(p.A_ub), _nrows(p.A_eq)
    blocks = []
    if m_ub:
        blocks.append(_scisparse.csr_matrix(p.A_ub))
    if m_eq:
        blocks.append(_scisparse.csr_matrix(p.A_eq))
    constraints = []
    if blocks:
        A = blocks[0] if len(blocks) == 1 else _scisparse.vstack(blocks, format="csr")
        lo = np.concatenate([np.full(m_ub, -np.inf),
                             np.asarray(p.b_eq, dtype=np.float64)[:m_eq]])
        hi = np.concatenate([np.asarray(p.b_ub, dtype=np.float64)[:m_ub],
                             np.asarray(p.b_eq, dtype=np.float64)[:m_eq]])
        constraints.append(_sciopt.LinearConstraint(A, lo, hi))
    integrality = (
        np.asarray(p.integrality, dtype=np.int64) if p.integrality is not None else np.zeros(n)
    )
    bounds = _sciopt.Bounds(np.zeros(n), _default_ub(p))
    res = _sciopt.milp(
        c=c,
        constraints=constraints,
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit_s},
    )
    dt = time.perf_counter() - t0
    nodes = int(getattr(res, "mip_node_count", 0) or 0)
    if res.status == 0:
        return MilpResult("optimal", np.asarray(res.x), float(res.fun), dt, nodes)
    if res.status == 2:
        return MilpResult("infeasible", None, np.nan, dt, nodes)
    if res.status == 1:   # time limit — surface the best incumbent, if any
        if res.x is not None:
            return MilpResult("feasible", np.asarray(res.x), float(res.fun), dt, nodes)
        if inc is not None:
            return MilpResult("feasible", inc, float(c @ inc), dt, nodes)
        return MilpResult("timeout", None, np.nan, dt, nodes)
    return MilpResult(f"highs_status_{res.status}", None, np.nan, dt, nodes)


# ------------------------------------------------------- branch & bound ---
def _solve_bnb(p: MilpProblem, time_limit_s: float,
               inc: Optional[np.ndarray] = None) -> MilpResult:
    t0 = time.perf_counter()
    n = p.n()
    c = np.asarray(p.c, dtype=np.float64)
    int_mask = (
        np.asarray(p.integrality, dtype=bool) if p.integrality is not None else np.zeros(n, bool)
    )
    base_ub = _default_ub(p)
    A_ub_base = _dense(p.A_ub) if _nrows(p.A_ub) else np.zeros((0, n))
    b_ub_base = np.asarray(p.b_ub, dtype=np.float64) if _nrows(p.A_ub) else np.zeros((0,))
    A_eq = _dense(p.A_eq) if _nrows(p.A_eq) else None
    b_eq = p.b_eq if A_eq is not None else None

    # A feasible warm start is an immediate incumbent: it bounds the search
    # from above before the first node, and branching prefers the child
    # agreeing with it (depth-first toward the incumbent).
    best_x: Optional[np.ndarray] = inc.copy() if inc is not None else None
    best_obj = float(c @ inc) if inc is not None else np.inf
    nodes = 0
    lp_iters = 0
    # Stack of (lb, ub) variable-bound overrides; lower bounds realized by
    # shifting is overkill here — we instead add bound rows per node.
    stack = [(np.zeros(n), base_ub.copy())]
    timed_out = False
    while stack:
        if time.perf_counter() - t0 > time_limit_s:
            timed_out = True
            break
        lb, ub = stack.pop()
        # Encode lb via extra ≤ rows: −x ≤ −lb.
        A_ub, b_ub = A_ub_base, b_ub_base
        nz = np.nonzero(lb > 0)[0]
        if nz.size:
            A_lb = np.zeros((nz.size, n))
            A_lb[np.arange(nz.size), nz] = -1.0
            A_ub = np.vstack([A_ub, A_lb])
            b_ub = np.concatenate([b_ub, -lb[nz]])
        res = solve_lp(c, A_ub, b_ub, A_eq, b_eq, ub=ub)
        nodes += 1
        lp_iters += res.iterations
        if not res.ok or res.objective >= best_obj - 1e-9:
            continue
        x = res.x
        frac = np.abs(x - np.round(x))
        frac[~int_mask] = 0.0
        j = int(np.argmax(frac))
        if frac[j] < 1e-6:
            xi = x.copy()
            xi[int_mask] = np.round(xi[int_mask])
            obj = float(np.dot(c, xi))
            if obj < best_obj - 1e-12:
                best_obj, best_x = obj, xi
            continue
        # Branch on x[j]; explore the incumbent-side child first (LIFO:
        # pushed last is popped first).
        floor_v = np.floor(x[j])
        ub_lo = ub.copy()
        ub_lo[j] = floor_v
        lb_hi = lb.copy()
        lb_hi[j] = floor_v + 1.0
        down = (lb.copy(), ub_lo) if floor_v >= lb[j] - 1e-9 else None
        up = (lb_hi, ub.copy()) if lb_hi[j] <= ub[j] + 1e-9 else None
        toward_up = best_x is not None and best_x[j] >= floor_v + 1.0 - 1e-9
        first, second = (up, down) if toward_up else (down, up)
        if second is not None:
            stack.append(second)
        if first is not None:
            stack.append(first)
    dt = time.perf_counter() - t0
    if best_x is None:
        return MilpResult("timeout" if timed_out else "infeasible",
                          None, np.nan, dt, nodes, lp_iters)
    # Optimality is only proven when the search space was exhausted.
    return MilpResult("feasible" if timed_out else "optimal",
                      best_x, best_obj, dt, nodes, lp_iters)
