"""Dense two-phase primal simplex in pure numpy.

This is the fallback LP engine behind `core.solver` so the framework has no
hard dependency on an external solver (the paper uses GLPK/CPLEX; we default
to scipy's HiGHS when present and fall back to this).  Standard form:

    min c·x   s.t.  A_ub x ≤ b_ub,  A_eq x = b_eq,  0 ≤ x ≤ ub

Per-variable upper bounds are handled *natively* with the classic
bounded-variable (upper-bounding) technique: a nonbasic variable may sit at
either of its bounds, and an entering step is limited by three ratios —
a basic variable dropping to its lower bound, a basic variable climbing to
its upper bound, or the entering variable hitting its own upper bound (a
*bound flip*, realized by the substitution x_j ← u_j − x_j, which negates
the column and shifts the RHS but needs no pivot).  Encoding the bounds as
explicit ≤ rows — the previous approach — doubled the tableau height for
the all-binary reconfiguration LPs; native bounds keep the tableau at the
structural-constraint height.

Bland's rule is used for anti-cycling (smallest-index entering column;
leaving variable with the smallest variable index among minimal ratios,
the entering variable's own bound counting with its column index).
Intended problem sizes: up to a few thousand variables / constraints (the
reconfiguration MILPs are far smaller after candidate filtering).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_EPS = 1e-9


@dataclasses.dataclass
class LpResult:
    status: str            # "optimal" | "infeasible" | "unbounded" | "iteration_limit"
    x: Optional[np.ndarray]
    objective: float
    iterations: int = 0    # simplex pivots + bound flips across both phases

    @property
    def ok(self) -> bool:
        return self.status == "optimal"


def _tableau_simplex(
    T: np.ndarray,
    basis: np.ndarray,
    ub_all: np.ndarray,
    flipped: np.ndarray,
    max_iter: int,
) -> tuple:
    """In-place bounded-variable primal simplex on tableau ``T`` (last row =
    objective, last column = RHS).  ``ub_all`` holds every column's upper
    bound (inf when unbounded); ``flipped`` tracks the x ← u − x
    substitutions applied so far (updated in place).  All nonbasic columns
    are at value 0 *in the flipped coordinates*.  Returns
    ``(status, iterations)``."""
    m = T.shape[0] - 1
    for it in range(max_iter):
        obj = T[-1, :-1]
        # Bland: entering = smallest index with negative reduced cost.
        neg = np.nonzero(obj < -_EPS)[0]
        if neg.size == 0:
            return "optimal", it
        col = int(neg[0])
        colv = T[:m, col]
        rhs = T[:m, -1]
        # Ratio 1: a basic variable dropping to its lower bound (0).
        t_low = np.full(m, np.inf)
        pos = colv > _EPS
        t_low[pos] = rhs[pos] / colv[pos]
        # Ratio 2: a basic variable climbing to its upper bound.
        t_up = np.full(m, np.inf)
        ub_basic = ub_all[basis]
        clim = (colv < -_EPS) & np.isfinite(ub_basic)
        t_up[clim] = (ub_basic[clim] - rhs[clim]) / (-colv[clim])
        # Ratio 3: the entering variable hitting its own upper bound.
        t_own = ub_all[col]
        t_row = np.minimum(t_low, t_up)
        row_min = float(t_row.min()) if m else np.inf
        if not np.isfinite(min(row_min, t_own)):
            return "unbounded", it
        t_min = min(row_min, t_own)
        # Bland tie-break: smallest variable index among minimal ratios;
        # the entering variable's own bound counts with index ``col``.
        leave_row, leave_var = -1, np.iinfo(np.int64).max
        tie = np.nonzero(t_row <= t_min + _EPS)[0]
        if tie.size:
            k = int(tie[np.argmin(basis[tie])])
            leave_row, leave_var = k, int(basis[k])
        if t_own <= t_min + _EPS and col < leave_var:
            # Bound flip: substitute x_col ← u_col − x_col.  Uniform column
            # update keeps every row (objective constant included) exact.
            T[:, -1] -= T[:, col] * t_own
            T[:, col] *= -1.0
            flipped[col] = ~flipped[col]
            continue
        row = leave_row
        leave_col = int(basis[row])
        to_upper = t_up[row] < t_low[row] - _EPS   # leaving var exits at ub
        # Pivot.
        piv = T[row, col]
        T[row] /= piv
        colvals = T[:, col].copy()
        colvals[row] = 0.0
        T -= np.outer(colvals, T[row])
        T[:, col] = 0.0
        T[row, col] = 1.0
        basis[row] = col
        if to_upper:
            # The leaving variable becomes nonbasic at its UPPER bound:
            # flip it so nonbasic-at-zero stays the tableau invariant.
            u = ub_all[leave_col]
            T[:, -1] -= T[:, leave_col] * u
            T[:, leave_col] *= -1.0
            flipped[leave_col] = ~flipped[leave_col]
    return "iteration_limit", max_iter


def solve_lp(
    c: np.ndarray,
    A_ub: Optional[np.ndarray] = None,
    b_ub: Optional[np.ndarray] = None,
    A_eq: Optional[np.ndarray] = None,
    b_eq: Optional[np.ndarray] = None,
    ub: Optional[np.ndarray] = None,
    max_iter: int = 20_000,
) -> LpResult:
    """Two-phase bounded-variable simplex.  Variables are implicitly ≥ 0;
    ``ub`` adds per-variable upper bounds, handled natively (no extra
    tableau rows)."""
    c = np.asarray(c, dtype=np.float64)
    n = c.size
    ub_x = (np.full(n, np.inf) if ub is None
            else np.asarray(ub, dtype=np.float64).copy())
    A_ub_all = (np.asarray(A_ub, dtype=np.float64)
                if A_ub is not None and len(A_ub) else np.zeros((0, n)))
    b_ub_all = (np.asarray(b_ub, dtype=np.float64)
                if A_ub_all.shape[0] else np.zeros((0,)))
    A_eq = np.asarray(A_eq, dtype=np.float64) if A_eq is not None and len(A_eq) else np.zeros((0, n))
    b_eq = np.asarray(b_eq, dtype=np.float64) if A_eq.shape[0] else np.zeros((0,))

    flip = b_ub_all < 0  # ≤ with negative rhs → needs surplus+artificial
    m_ub, m_eq = A_ub_all.shape[0], A_eq.shape[0]
    m = m_ub + m_eq
    if m == 0:
        # Box-constrained min over 0 ≤ x ≤ ub.
        lower = c < -_EPS
        if (lower & ~np.isfinite(ub_x)).any():
            return LpResult("unbounded", None, -np.inf)
        x = np.where(lower, ub_x, 0.0)
        return LpResult("optimal", x, float(c @ x))

    # Build phase-1 tableau: columns = [x | slack/surplus | artificial | rhs].
    A = np.vstack([A_ub_all, A_eq])
    b = np.concatenate([b_ub_all, b_eq])
    neg = b < 0
    A[neg] *= -1.0
    b[neg] *= -1.0
    # slack for ≤ rows (sign −1 if the row was flipped → becomes surplus).
    slack = np.zeros((m, m_ub))
    for i in range(m_ub):
        slack[i, i] = -1.0 if flip[i] else 1.0
    # Artificials for: flipped ≤ rows and all eq rows.
    need_art = np.zeros(m, dtype=bool)
    need_art[:m_ub] = flip
    need_art[m_ub:] = True
    art_idx = np.nonzero(need_art)[0]
    art = np.zeros((m, art_idx.size))
    for j, i in enumerate(art_idx):
        art[i, j] = 1.0
    n_slack, n_art = m_ub, art_idx.size
    total = n + n_slack + n_art

    T = np.zeros((m + 1, total + 1))
    T[:m, :n] = A
    T[:m, n:n + n_slack] = slack
    T[:m, n + n_slack:total] = art
    T[:m, -1] = b
    # Column upper bounds: structural x bounds, slack/artificials unbounded.
    ub_all = np.concatenate([ub_x, np.full(n_slack + n_art, np.inf)])
    flipped = np.zeros(total, dtype=bool)
    basis = np.zeros(m, dtype=np.int64)
    for i in range(m):
        if need_art[i]:
            j = int(np.nonzero(art_idx == i)[0][0])
            basis[i] = n + n_slack + j
        else:
            basis[i] = n + i  # its own slack
    iters = 0
    if n_art:
        # Phase 1 objective: min sum of artificials.
        T[-1, n + n_slack:total] = 1.0
        for i in range(m):
            if need_art[i]:
                T[-1] -= T[i]
        status, iters = _tableau_simplex(T, basis, ub_all, flipped, max_iter)
        if status != "optimal":
            return LpResult(status, None, np.nan, iters)
        if T[-1, -1] < -1e-7:
            return LpResult("infeasible", None, np.nan, iters)
        # Drive artificials out of basis where possible.
        for i in range(m):
            if basis[i] >= n + n_slack:
                row = T[i, :n + n_slack]
                cand = np.nonzero(np.abs(row) > 1e-7)[0]
                if cand.size:
                    col = int(cand[0])
                    piv = T[i, col]
                    T[i] /= piv
                    colv = T[:, col].copy()
                    colv[i] = 0.0
                    T -= np.outer(colv, T[i])
                    T[:, col] = 0.0
                    T[i, col] = 1.0
                    basis[i] = col
        # Remove artificial columns.  ``ub_all``/``flipped`` stay full
        # length: a redundant row can leave its artificial stuck in the
        # basis (at value 0), and phase 2 indexes ``ub_all[basis]`` — the
        # stuck artificial keeps its +inf bound and, being absent from the
        # objective row, is never entered or flipped.
        keep = np.concatenate([np.arange(n + n_slack), [total]])
        T = T[:, keep]

    # Phase 2.  Flipped columns carry −c (objective constants only matter
    # for the phase-1 feasibility check, so they are not tracked here).
    T[-1, :] = 0.0
    T[-1, :n] = np.where(flipped[:n], -c, c)
    for i in range(m):
        if basis[i] < n + n_slack and abs(T[-1, basis[i]]) > _EPS:
            T[-1] -= T[-1, basis[i]] * T[i]
    status, it2 = _tableau_simplex(T, basis, ub_all, flipped, max_iter)
    iters += it2
    if status != "optimal":
        return LpResult(status, None, np.nan, iters)
    x = np.zeros(n + n_slack)
    for i in range(m):
        if basis[i] < n + n_slack:
            x[basis[i]] = T[i, -1]
    fl = flipped[:n + n_slack]
    x[fl] = ub_all[:n + n_slack][fl] - x[fl]
    xs = x[:n]
    return LpResult("optimal", xs, float(c @ xs), iters)
