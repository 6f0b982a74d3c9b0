"""The port's LP core (`repro_torch.core`: topology, apps, simplex, solver,
lp, placement, satisfaction, migration, reconfig, simulation) against the
JAX package's `repro.core`.

The modules are the reference's numpy with only their import paths
changed, so every comparison here is exact: each side is built from its
own package with the same seed, and plain values (floats, ids, statuses)
are compared with ``==``, no tolerance.  Wall-clock fields
(``solve_time_s``, ``plan_time_s``, ``placement_time_s``) are left out.
The solver paths are held twice: under scipy's `milp` (HiGHS) and under
the module's own simplex and branch-and-bound, the fallback taken where
`scipy.optimize.milp` is missing (`solver._HAVE_SCIPY` set False in both
packages); `tests/test_torch_lp_fallback.py` holds the paper sweep under
the fallback."""

import dataclasses

import numpy as np
import pytest

import repro.core as jc
from repro.core import lp as jlp
from repro.core import migration as jmig
from repro.core import placement as jplace
from repro.core import simplex as jsimplex
from repro.core import solver as jsolver
from repro.core.apps import requirement_from_pattern as jpattern
import repro_torch.core as tc
from repro_torch.core import lp as tlp
from repro_torch.core import migration as tmig
from repro_torch.core import placement as tplace
from repro_torch.core import simplex as tsimplex
from repro_torch.core import solver as tsolver
from repro_torch.core.apps import requirement_from_pattern as tpattern

SOLVERS = ["milp", "fallback"]


@pytest.fixture(params=SOLVERS)
def solver_path(request, monkeypatch):
    """Both packages' solver on scipy's `milp`, or both on the fallback."""
    if request.param == "fallback":
        monkeypatch.setattr(tsolver, "_HAVE_SCIPY", False)
        monkeypatch.setattr(jsolver, "_HAVE_SCIPY", False)
    else:
        assert tsolver._HAVE_SCIPY and jsolver._HAVE_SCIPY
    return request.param


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def test_core_exports_the_references_names():
    # The modules outside the package's exports are attributes only once
    # some test has imported them.
    later = {"adaptation", "cluster", "shard_search"}
    assert _public(tc) - later == _public(jc) - later


# ------------------------------------------------------------------ plain values --
def _lp(res):
    return (res.status, None if res.x is None else res.x.tolist(), res.objective,
            res.iterations)


def _milp(res, backend):
    effort = (res.nodes_explored, res.lp_iterations) if backend == "bnb" else ()
    return (res.status, None if res.x is None else res.x.tolist(), res.objective,
            res.warm_start) + effort


def _cand(c):
    return (c.node.node_id, tuple(l.link_id for l in c.links), c.response_s, c.price)


def _engine(e):
    placed = {rid: (_cand(p.candidate), p.response_s, p.price, p.state, p.seq)
              for rid, p in e.placed.items()}
    return (placed, list(e.placement_order), [r.req_id for r in e.rejected],
            e.rejected_total, dict(e.node_used), dict(e.link_used))


def _move(m):
    return (m.req_id, _cand(m.old), _cand(m.new), m.ratio)


def _reconfig(res):
    sat = [(s.req_id, s.r_before, s.r_after, s.p_before, s.p_after, s.ratio)
           for s in res.satisfaction]
    solver = None if res.solver is None else (res.solver.status, res.solver.objective)
    steps = [(_move(s.move), s.mode, s.est_downtime_s) for s in res.migration_steps]
    return (list(res.window), [_move(m) for m in res.moves], sat, res.s_before, res.s_after,
            res.accepted, solver, steps, res.gain, res.mean_moved_ratio)


def _experiment(r):
    return (r.window_size, r.n_placed, r.n_rejected,
            [(e.window_size, e.n_target, e.n_moved, e.mean_moved_ratio, e.gain)
             for e in r.events], r.moved_fraction, r.mean_moved_ratio)


# ----------------------------------------------------------------- simplex --
def _random_lp(seed):
    """The reference's random LP (tests/test_solver.py), mixed with
    test_incremental.py's infinite bounds and equality rows."""
    rng = np.random.default_rng(seed)
    n, m, me = int(rng.integers(1, 7)), int(rng.integers(0, 5)), int(rng.integers(0, 3))
    c = rng.normal(size=n)
    A, b = rng.normal(size=(m, n)), rng.uniform(-0.5, 3.0, size=m)
    Ae, be = rng.normal(size=(me, n)), rng.uniform(-0.5, 2.0, size=me)
    ub = np.where(rng.random(n) < 0.7, rng.uniform(0.0, 4.0, size=n), np.inf)
    return c, A, b, Ae, be, ub


FIXED_LPS = {
    "basic": (np.array([-1.0, -1.0]), np.array([[1.0, 1.0]]), np.array([1.0]), None, None, None),
    "equality": (np.array([1.0, 2.0]), np.array([[1.0, 0.0]]), np.array([0.3]),
                 np.array([[1.0, 1.0]]), np.array([1.0]), None),
    "infeasible": (np.array([1.0]), np.array([[1.0]]), np.array([1.0]), np.array([[1.0]]),
                   np.array([2.0]), None),
    "unbounded": (np.array([-1.0]), np.array([[-1.0]]), np.array([0.0]), None, None, None),
    "upper_bounds": (np.array([-1.0, -1.0]), None, None, None, None, np.array([2.0, 3.0])),
    "redundant_rows": (np.array([-1.0, -2.0]), None, None, np.array([[1.0, 1.0], [1.0, 1.0]]),
                       np.array([1.0, 1.0]), np.array([1.0, 1.0])),
    "zero_bound": (np.array([-5.0, -1.0]), np.array([[1.0, 1.0]]), np.array([2.0]), None,
                   None, np.array([0.0, np.inf])),
}


@pytest.mark.parametrize("name", sorted(FIXED_LPS))
def test_solve_lp_equals_the_reference_on_the_reference_tests_lps(name):
    c, A, b, Ae, be, ub = FIXED_LPS[name]
    assert _lp(tsimplex.solve_lp(c, A, b, Ae, be, ub=ub)) == \
        _lp(jsimplex.solve_lp(c, A, b, Ae, be, ub=ub))


@pytest.mark.parametrize("chunk", range(4))
def test_solve_lp_equals_the_reference_on_random_lps(chunk):
    statuses = set()
    for seed in range(chunk * 40, chunk * 40 + 40):
        c, A, b, Ae, be, ub = _random_lp(seed)
        t = tsimplex.solve_lp(c, A, b, Ae, be, ub=ub)
        assert _lp(t) == _lp(jsimplex.solve_lp(c, A, b, Ae, be, ub=ub)), seed
        statuses.add(t.status)
    assert "optimal" in statuses


# ------------------------------------------------------------------ solver --
def _assignment_milp(mod, rng, n_apps=4, n_slots=3):
    """The reference tests' random placement MILP, built by ``mod``'s
    `MilpProblem`."""
    n = n_apps * n_slots
    c = rng.uniform(0.5, 3.0, size=n)
    A_eq = np.zeros((n_apps, n))
    for i in range(n_apps):
        A_eq[i, i * n_slots:(i + 1) * n_slots] = 1.0
    usage = rng.uniform(0.3, 1.0, size=n_apps)
    A_ub = np.zeros((n_slots, n))
    for s in range(n_slots):
        for i in range(n_apps):
            A_ub[s, i * n_slots + s] = usage[i]
    b_ub = rng.uniform(1.0, 3.0, size=n_slots)
    return mod.MilpProblem(c=c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=np.ones(n_apps),
                           integrality=np.ones(n))


@pytest.mark.parametrize("backend", ["bnb", "highs"])
@pytest.mark.parametrize("chunk", range(3))
def test_solve_milp_equals_the_reference(backend, chunk):
    for seed in range(chunk * 15, chunk * 15 + 15):
        t = tsolver.solve_milp(_assignment_milp(tsolver, np.random.default_rng(seed)),
                               backend=backend)
        j = jsolver.solve_milp(_assignment_milp(jsolver, np.random.default_rng(seed)),
                               backend=backend)
        assert _milp(t, backend) == _milp(j, backend), seed


@pytest.mark.parametrize("backend", ["bnb", "highs"])
def test_warm_starts_and_deadlines_equal_the_reference(backend):
    """test_incremental.py's warm-start and status cases on both sides."""
    for seed in (2, 3, 4, 11):
        tp = _assignment_milp(tsolver, np.random.default_rng(seed))
        jp = _assignment_milp(jsolver, np.random.default_rng(seed))
        cold = tsolver.solve_milp(tp, backend=backend)
        for kw in (dict(x0=cold.x), dict(x0=np.zeros(tp.n()))):
            assert _milp(tsolver.solve_milp(tp, backend=backend, **kw), backend) == \
                _milp(jsolver.solve_milp(jp, backend=backend, **kw), backend)
    for kw in (dict(time_limit_s=0.0, x0=cold.x), dict(time_limit_s=0.0)):
        t = tsolver.solve_milp(tp, backend="bnb", **kw)
        j = jsolver.solve_milp(jp, backend="bnb", **kw)
        assert (t.status, t.objective, t.warm_start) == (j.status, j.objective, j.warm_start)
    infeasible = dict(c=np.array([1.0, 1.0]), A_ub=np.array([[1.0, 1.0]]),
                      b_ub=np.array([0.5]), A_eq=np.array([[1.0, 1.0]]), b_eq=np.array([1.0]),
                      integrality=np.ones(2))
    t = tsolver.solve_milp(tsolver.MilpProblem(**infeasible), backend=backend,
                           x0=np.array([1.0, 0.0]))
    j = jsolver.solve_milp(jsolver.MilpProblem(**infeasible), backend=backend,
                           x0=np.array([1.0, 0.0]))
    assert _milp(t, backend) == _milp(j, backend) and t.status == "infeasible"


def test_the_fallback_is_taken_without_scipy_milp(monkeypatch):
    """`solve_milp`'s "auto" backend is HiGHS with `scipy.optimize.milp`
    and the module's own branch-and-bound without it, in both packages."""
    p = _assignment_milp(tsolver, np.random.default_rng(0))
    q = _assignment_milp(jsolver, np.random.default_rng(0))
    for have in (True, False):
        monkeypatch.setattr(tsolver, "_HAVE_SCIPY", have)
        monkeypatch.setattr(jsolver, "_HAVE_SCIPY", have)
        auto = tsolver.solve_milp(p)
        own = tsolver.solve_milp(p, backend="highs" if have else "bnb")
        assert _milp(auto, "highs") == _milp(own, "highs") == \
            _milp(jsolver.solve_milp(q), "highs")


def _dense(a):
    return None if a is None else (a.toarray() if hasattr(a, "toarray") else np.asarray(a))


@pytest.mark.parametrize("sparse", [True, False])
def test_joint_milp_equals_the_reference(sparse, monkeypatch):
    """`build_joint_milp` over one window of a loaded engine (scipy CSR,
    and the dense rows built without scipy's sparse module) on both sides:
    the same objective, rows and bounds, and the same decoded choice."""
    monkeypatch.setattr(tlp, "_HAVE_SPARSE", sparse)
    monkeypatch.setattr(jlp, "_HAVE_SPARSE", sparse)
    built = []
    for core, lp in ((tc, tlp), (jc, jlp)):
        engine = _loaded(core, 120, 3)
        rec = core.Reconfigurator(engine, move_penalty=0.01)
        window = engine.recent(60)
        node_cap, link_cap = rec._free_capacity_excluding(window)
        p, idx = lp.build_joint_milp(rec._window_app_vars(window), node_cap, link_cap,
                                     move_penalty=0.01)
        built.append((p.c.tolist(), _dense(p.A_ub).tolist(), p.b_ub.tolist(),
                      _dense(p.A_eq).tolist(), p.b_eq.tolist(), p.integrality.tolist(),
                      idx.offsets.tolist(), idx.decode(p.c)))
    assert built[0] == built[1]


def test_decode_and_the_empty_window_equal_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        sizes = rng.integers(1, 9, size=int(rng.integers(1, 12)))
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        x = rng.random(int(sizes.sum()))
        if x.size >= 2 and sizes[0] >= 2:
            x[1] = x[0]                      # a tie resolves to the first argmax
        assert tlp.JointIndex(apps=[object()] * len(sizes), offsets=offsets).decode(x) == \
            jlp.JointIndex(apps=[object()] * len(sizes), offsets=offsets).decode(x)
    tp, _ = tlp.build_joint_milp([], {}, {})
    jp, _ = jlp.build_joint_milp([], {}, {})
    for backend in ("bnb", "highs"):
        t, j = tsolver.solve_milp(tp, backend=backend), jsolver.solve_milp(jp, backend=backend)
        assert (tp.n(), t.status, t.objective) == (jp.n(), j.status, j.objective)


# --------------------------------------------------------------- placement --
def _loaded(core, n, seed, **kw):
    topo = core.build_paper_topology()
    engine = core.PlacementEngine(topo, **kw)
    for r in core.sample_requests(topo, n, np.random.default_rng(seed)):
        engine.place(r)
    return engine


@pytest.mark.parametrize("mode", ["scalar", "vector"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placements_and_rejections_equal_the_reference(mode, seed):
    t = _loaded(tc, 500, seed, admission_mode=mode)
    j = _loaded(jc, 500, seed, admission_mode=mode)
    assert _engine(t) == _engine(j)
    assert t.rejected_total > 0 and t.occupancy_invariants_ok()


def test_paper_topology_and_worked_example_equal_the_reference():
    t, j = tc.build_paper_topology(), jc.build_paper_topology()
    for part in ("sites", "nodes", "links"):
        assert [dataclasses.astuple(x) for x in getattr(t, part).values()] == \
            [dataclasses.astuple(x) for x in getattr(j, part).values()], part
    for tapp, japp, pattern in ((tc.NAS_FT, jc.NAS_FT, "c"), (tc.MRI_Q, jc.MRI_Q, "y")):
        treq = tc.PlacementRequest(0, tapp, "input0",
                                   tpattern(pattern, np.random.default_rng(0)))
        jreq = jc.PlacementRequest(0, japp, "input0",
                                   jpattern(pattern, np.random.default_rng(0)))
        assert [_cand(c) for c in tc.enumerate_candidates(t, treq)] == \
            [_cand(c) for c in jc.enumerate_candidates(j, jreq)]
    carrier = [c for c in tc.enumerate_candidates(t, treq) if "carrier" in c.node.node_id]
    assert (carrier[-1].response_s, carrier[-1].price) == (3.2, 15300.0)   # paper §4.2, MRI-Q


def test_place_via_milp_equals_the_reference(solver_path):
    topo_t, topo_j = tc.build_paper_topology(), jc.build_paper_topology()
    et, ej = tc.PlacementEngine(topo_t), jc.PlacementEngine(topo_j)
    for rt, rj in zip(tc.sample_requests(topo_t, 40, np.random.default_rng(5)),
                      jc.sample_requests(topo_j, 40, np.random.default_rng(5))):
        a, b = et.place_via_milp(rt), ej.place_via_milp(rj)
        assert (a is None) == (b is None)
        if a is not None:
            assert (_cand(a.candidate), a.response_s, a.price) == \
                (_cand(b.candidate), b.response_s, b.price)
    assert _engine(et) == _engine(ej)


def _churned(core, seed):
    """test_admission_fast_path.py's churn: failures, recoveries and
    departures between rounds of arrivals."""
    rng = np.random.default_rng(seed)
    topo = core.build_paper_topology()
    engine = core.PlacementEngine(topo)
    reqs = core.sample_requests(topo, 400, rng)
    nodes, links = list(topo.nodes), list(topo.links)
    for chunk in np.array_split(np.arange(len(reqs)), 4):
        for i in chunk:
            engine.place(reqs[i])
        for _ in range(3):
            engine.set_node_online(nodes[int(rng.integers(len(nodes)))], bool(rng.random() < 0.5))
        for _ in range(2):
            engine.set_link_online(links[int(rng.integers(len(links)))], bool(rng.random() < 0.5))
        ids = list(engine.placement_order)
        for _ in range(min(5, len(ids))):
            rid = ids[int(rng.integers(len(ids)))]
            if rid in engine.placed:
                engine.release(rid)
    return engine


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_under_churn_equals_the_reference(seed):
    t, j = _churned(tc, seed), _churned(jc, seed)
    assert _engine(t) == _engine(j)
    assert t.occupancy_invariants_ok()
    assert tplace.REJECTED_KEEP == jplace.REJECTED_KEEP


# ---------------------------------------------------------------- reconfig --
@pytest.mark.parametrize("window", [20, 50, 100])
@pytest.mark.parametrize("seed", [0, 7])
def test_reconfigurator_plan_equals_the_reference(solver_path, window, seed):
    """`Reconfigurator.plan`'s trial: S before and after, moves and every
    window app's satisfaction; then `apply` and the fleet after it."""
    sides = []
    for core in (tc, jc):
        engine = _loaded(core, 150, seed)
        rec = core.Reconfigurator(engine, move_penalty=0.01)
        res = rec.plan(engine.recent(window))
        rec.apply(res)
        sides.append((_reconfig(res), _engine(engine)))
    assert sides[0] == sides[1]
    (res, _), _ = sides
    assert res[4] <= res[3]                       # S after <= S before


def test_weighted_plan_and_swap_cycles_equal_the_reference():
    """A traffic-weighted trial, and the migration planner's cycle break
    (two apps swapping full FPGA servers: one stop-and-copy step)."""
    sides = []
    for core, mig, pattern in ((tc, tmig, tpattern), (jc, jmig, jpattern)):
        engine = _loaded(core, 150, 4)
        window = engine.recent(60)
        weights = {rid: 1.0 + (rid % 5) for rid in window}
        res = core.Reconfigurator(engine).plan(window, weights=weights)
        topo = core.build_paper_topology()
        eng = core.PlacementEngine(topo)
        rng = np.random.default_rng(0)

        def cand_for(req, node_id):
            return [c for c in core.enumerate_candidates(topo, req)
                    if c.node.node_id == node_id][0]

        for i in range(20):
            req = core.PlacementRequest(i, core.MRI_Q, f"input{i}", pattern("Y", rng))
            eng.commit(req, cand_for(req, "cloud0_fpga0" if i < 10 else "cloud0_fpga1"))
        a, b = eng.placed[0], eng.placed[10]
        moves = [mig.Move(0, a.candidate, cand_for(a.request, "cloud0_fpga1"), 1.9),
                 mig.Move(10, b.candidate, cand_for(b.request, "cloud0_fpga0"), 1.9)]
        steps = mig.plan_and_apply(eng, moves)
        sides.append((_reconfig(res), res.mean_moved_ratio_weighted,
                      [(_move(s.move), s.mode, s.est_downtime_s) for s in steps], _engine(eng)))
    assert sides[0] == sides[1]
    assert any(s[1] == "stop_and_copy" for s in sides[0][2])


# -------------------------------------------------------------- simulation --
@pytest.mark.parametrize("window", [100, 200, 400])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_paper_experiment_equals_the_reference(window, seed):
    t = tc.run_paper_experiment(window, seed=seed)
    assert _experiment(t) == _experiment(jc.run_paper_experiment(window, seed=seed))
    assert t.events[0].n_moved > 0


def test_run_paper_sweep_equals_the_reference():
    t, j = tc.run_paper_sweep(), jc.run_paper_sweep()
    assert list(t) == list(j) == [100, 200, 400]
    assert {w: [_experiment(r) for r in rs] for w, rs in t.items()} == \
        {w: [_experiment(r) for r in rs] for w, rs in j.items()}
    # paper fig. 5(b): the mean X + Y of moved apps near 1.96
    assert abs(np.mean([r.mean_moved_ratio for r in t[400]]) - 1.96) < 0.02


def test_run_paper_experiment_over_batches_equals_the_reference(solver_path):
    kw = dict(seed=5, n_initial=200, batch=50, n_batches=3)
    assert _experiment(tc.run_paper_experiment(100, **kw)) == \
        _experiment(jc.run_paper_experiment(100, **kw))
