"""The port's fleet (`repro_torch.fleet`, `repro_torch.core.cluster` and the
adaptation controller's Steps 5 and 7) against the JAX package's.

Each side is built from its own package (a reference event fed to the
port's runtime would be dropped without a word, and each package has its
own policy registry) and plain values are compared exactly: fingerprints,
ids, floats.  The simulated elastic backend sizes a job from its config as
the reference does; the live backend executes a planner move on gloo ranks
(snapshot -> mesh resize -> `reshard_restore`, and a rollback).  The
scenario x policy sweep is in `tests/test_torch_fleet_sweep_faults.py` and
`tests/test_torch_fleet_sweep_demand.py`."""

import dataclasses
import json

import numpy as np
import pytest

import repro.fleet as jf
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.core import adaptation as jadapt
from repro.core import cluster as jcl
from repro.core import migration as jmig
from repro.core import placement as jplace
from repro.core import reconfig as jreconfig
from repro.core import satisfaction as jsat
from repro.core import solver as jsolver
from repro.models import SHAPES_BY_NAME as JSHAPES
from repro.runtime import elastic as jelastic
from repro.train import make_optimizer as jmake_optimizer
import repro_torch.fleet as tf
from repro_torch.configs import get_config
from repro_torch.core import adaptation as tadapt
from repro_torch.core import cluster as tcl
from repro_torch.core import migration as tmig
from repro_torch.core import placement as tplace
from repro_torch.core import reconfig as treconfig
from repro_torch.core import satisfaction as tsat
from repro_torch.core import solver as tsolver
from repro_torch.models import SHAPES_BY_NAME
from repro_torch.runtime import elastic as telastic
from repro_torch.train import make_optimizer

import torch_dist_util as du
from test_torch_launch import REF_HW

# Each package's modules, by the reference's name.
T = dict(fleet=tf, cl=tcl, mig=tmig, place=tplace, reconfig=treconfig, sat=tsat,
         elastic=telastic)
J = dict(fleet=jf, cl=jcl, mig=jmig, place=jplace, reconfig=jreconfig, sat=jsat,
         elastic=jelastic)
SIDES = [T, J]


@pytest.fixture(params=["milp", "fallback"])
def solver_path(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(tsolver, "_HAVE_SCIPY", False)
        monkeypatch.setattr(jsolver, "_HAVE_SCIPY", False)
    return request.param


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def test_fleet_exports_the_references_names_and_policies():
    assert _public(tf) == _public(jf)
    assert sorted(tf.POLICIES) == sorted(jf.POLICIES) and len(tf.POLICIES) == 10
    assert sorted(tf.SCENARIOS) == sorted(jf.SCENARIOS) and len(tf.SCENARIOS) == 10
    assert tf.POLICIES is not jf.POLICIES
    assert type(tf.get_policy("decomposed")).__module__ == "repro_torch.fleet.planner.decomposed"


def test_the_ports_identifiers_and_prices_are_the_references():
    """`KIND_TPU`, the node ids and `PodSpec`'s defaults stay the
    reference's (they are in the fingerprints)."""
    assert tcl.KIND_TPU == jcl.KIND_TPU == "tpu"
    assert dataclasses.astuple(tcl.PodSpec("p")) == dataclasses.astuple(jcl.PodSpec("p")) == \
        ("p", 256, 1.2, "v5e")
    t = tcl.build_fleet_topology([tcl.PodSpec("a"), tcl.PodSpec("b", 64, 0.8)])
    j = jcl.build_fleet_topology([jcl.PodSpec("a"), jcl.PodSpec("b", 64, 0.8)])
    for part in ("sites", "nodes", "links"):
        assert [dataclasses.astuple(x) for x in getattr(t, part).values()] == \
            [dataclasses.astuple(x) for x in getattr(j, part).values()]
    assert list(t.nodes) == ["a_tpu", "b_tpu"]


def test_jobs_from_dryrun_reads_the_ports_rows(tmp_path):
    rows = [{"arch": "granite-3-2b", "shape": "train_4k", "status": "ok",
             "roofline": {"t_step_s": 0.5}},
            {"arch": "xlstm-1.3b", "shape": "prefill_32k", "status": "skipped"},
            {"arch": "dbrx-132b", "shape": "decode_32k", "status": "ok",
             "roofline": {"t_step_s": 0.25}}]
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(rows))
    t, j = tcl.jobs_from_dryrun(str(path)), jcl.jobs_from_dryrun(str(path))
    assert [dataclasses.astuple(x) for x in t] == [dataclasses.astuple(x) for x in j]
    assert [x.job_id for x in t] == [0, 2] and t[0].step_slo_s == 0.75


# ------------------------------------------------------------ FleetScheduler --
def _fleet(m, prices=(1.2, 1.2, 0.85)):
    return m["cl"].build_fleet_topology([m["cl"].PodSpec(f"pod{i}", 256, p)
                                         for i, p in enumerate(prices)])


def _job(m, i, chips=64, t=1.0, slo=None, budget=10 ** 9, state_mb=None):
    return m["cl"].JobSpec(i, "a", "t", chips=chips, step_time_s=t, step_slo_s=slo,
                           budget_usd_month=budget, state_mb=state_mb)


def _cand(c):
    return (c.node.node_id, tuple(l.link_id for l in c.links), c.response_s, c.price)


def _move(m):
    return (m.req_id, _cand(m.old), _cand(m.new), m.ratio)


def _migrations(items):
    return [(_move(it.step.move), it.step.mode, it.step.est_downtime_s, it.start_s,
             it.duration_s) for it in items]


def _both(fn):
    a, b = fn(T), fn(J)
    assert a == b
    return a


class TestFleetScheduler:
    def test_budget_prefers_cheap_pod(self):
        assert _both(lambda m: m["cl"].FleetScheduler(_fleet(m)).submit(
            _job(m, 0, budget=10 ** 9))) == "pod2"

    def test_slo_rejects_infeasible(self):
        def run(m):
            sched = m["cl"].FleetScheduler(_fleet(m))
            return sched.submit(_job(m, 0, t=5.0, slo=1.0)), len(sched.engine.rejected)
        assert _both(run) == (None, 1)

    def test_capacity_spills_to_next_pod(self):
        def run(m):
            sched = m["cl"].FleetScheduler(_fleet(m, prices=(0.9, 1.2)))
            return [sched.submit(_job(m, i, chips=128)) for i in range(4)], sched.utilization()
        assert _both(run)[0] == ["pod0", "pod0", "pod1", "pod1"]

    def test_reconfig_moves_to_freed_cheap_pod(self, solver_path):
        def run(m):
            sched = m["cl"].FleetScheduler(_fleet(m, prices=(0.8, 2.0)), reconfig_every=10 ** 9)
            placed = [sched.submit(_job(m, i)) for i in range(5)]
            sched.engine.release(0)
            res = sched.recon.run(sched.engine.recent(8))
            return placed, [_move(mv) for mv in res.moves], res.s_before, res.s_after, \
                res.mean_moved_ratio
        placed, moves, *_ = _both(run)
        assert placed == ["pod0"] * 4 + ["pod1"] and len(moves) == 1
        assert moves[0][2][0] == "pod0_tpu"

    @pytest.mark.parametrize("policy", ["milp", "greedy", "hillclimb", "ga"])
    def test_periodic_reconfiguration_through_each_policy(self, policy, solver_path):
        """Admissions past ``reconfig_every`` plan through the policy and
        execute through `InstantExecutor`; releases between them."""
        def run(m):
            sched = m["cl"].FleetScheduler(_fleet(m, prices=(0.8, 1.5, 2.0)), reconfig_every=4,
                                           window=12, policy=policy)
            rng = np.random.default_rng(1)
            out = []
            for i in range(24):
                t = float(rng.uniform(0.5, 2.0))
                out.append(sched.submit(_job(m, i, chips=int(rng.choice([32, 64, 96])), t=t,
                                             slo=t + float(rng.choice([0.2, 3.0])),
                                             budget=float(rng.choice([60_000.0, 1e9])))))
                if i % 5 == 4 and i - 3 in sched.engine.placed:
                    sched.engine.release(i - 3)
            return out, _migrations(sched.migrations), sched.utilization()
        placed, migrations, _ = _both(run)
        assert any(placed) and (policy != "milp" or migrations)


# ---------------------------------------------- the demo fleet (Steps 1-3, 5) --
DEMO_PODS = [("tokyo-a", 256, 1.2), ("tokyo-b", 256, 1.2), ("osaka-spot", 256, 0.85),
             ("osaka-v5p", 256, 2.1)]
# What the trial gives under each solver path: the two paths reach the same
# S, through moves that differ in one of two tied jobs.
DEMO_MOVED = {"milp": [(4, "tokyo-a", "osaka-spot"), (10, "tokyo-b", "osaka-spot"),
                       (12, "osaka-v5p", "tokyo-a")],
              "fallback": [(4, "tokyo-a", "osaka-spot"), (11, "tokyo-b", "osaka-spot"),
                           (12, "osaka-v5p", "tokyo-a")]}


def _demo(m):
    """examples/reconfiguration_demo.py's Steps 1-3 and 5 in ``m``'s
    package: four pods, 14 jobs admitted FCFS, jobs 1 and 2 released, the
    LP trial over the 24 most recent."""
    cl = m["cl"]
    sched = cl.FleetScheduler(cl.build_fleet_topology([cl.PodSpec(*p) for p in DEMO_PODS]),
                              reconfig_every=10 ** 9, window=24)
    rng = np.random.default_rng(0)
    placed = []
    for i in range(14):
        fast = i % 3 == 0
        t = float(rng.uniform(0.8, 2.0))
        placed.append(sched.submit(cl.JobSpec(
            job_id=i, arch="granite-3-2b", shape="train_4k", chips=64, step_time_s=t,
            step_slo_s=t + (0.1 if fast else 2.0),
            budget_usd_month=None if fast else 90_000.0)))
    utilization = sched.utilization()
    for done in (1, 2):
        sched.engine.release(done)
    res = sched.recon.plan(sched.engine.recent(24))
    moved = [(mv.req_id, mv.old.node.site_id, mv.new.node.site_id, mv.ratio)
             for mv in res.moves]
    improved = [s.ratio for s in res.satisfaction if s.ratio < 2.0 - 1e-9]
    return dict(placed=placed, utilization=utilization, s_before=res.s_before,
                s_after=res.s_after, gain=res.gain, n_moved=res.n_moved, moved=moved,
                mean_moved_ratio=res.mean_moved_ratio, improved=improved,
                request=dataclasses.astuple(sched.engine.placed[res.moves[0].req_id].request))


def test_the_demo_fleet_equals_the_reference(solver_path):
    out = _both(_demo)
    assert out["placed"] == ["osaka-spot"] * 4 + ["tokyo-a"] * 4 + ["tokyo-b"] * 4 + \
        ["osaka-v5p", None]
    assert out["utilization"] == {"tokyo-a": 1.0, "tokyo-b": 1.0, "osaka-spot": 1.0,
                                  "osaka-v5p": 0.25}
    assert (out["s_before"], out["s_after"], out["n_moved"]) == (22.0, 20.988125193431365, 3)
    assert out["s_after"] <= out["s_before"] and out["gain"] == 1.0118748065686347
    assert [mv[:3] for mv in out["moved"]] == DEMO_MOVED[solver_path]
    assert [mv[3] for mv in out["moved"]] == [1.7083438822380557, 1.7083438822380557,
                                              1.5714374289552544]
    assert out["mean_moved_ratio"] == 1.662708397810455 and len(out["improved"]) == 3


# ------------------------------------------------- the adaptation controller --
def _controller(m, arch):
    """Steps 1-7 with a scheduler on the demo fleet: `run_all` places the
    job (Step 5), the demo's jobs follow, two leave, and `operate` runs one
    window (Step 7); the reference's mesh and constants."""
    cl = m["cl"]
    sched = cl.FleetScheduler(cl.build_fleet_topology([cl.PodSpec(*p) for p in DEMO_PODS]),
                              reconfig_every=10 ** 9, window=24)
    if m is T:
        ctl = tadapt.AdaptationController(sched, mesh_shape=(16, 16), hw=REF_HW)
        out = ctl.run_all(get_config(arch), SHAPES_BY_NAME["train_4k"], job_id=100)
    else:
        ctl = jadapt.AdaptationController(sched, mesh_shape=(16, 16))
        out = ctl.run_all(jget_config(arch), JSHAPES["train_4k"], job_id=100)
    rng = np.random.default_rng(0)
    placed = []
    for i in range(14):
        t = float(rng.uniform(0.8, 2.0))
        placed.append(ctl.place(cl.JobSpec(i, arch, "train_4k", chips=64, step_time_s=t,
                                           step_slo_s=t + (0.1 if i % 3 == 0 else 2.0),
                                           budget_usd_month=None if i % 3 == 0 else 9e4)))
    for done in (1, 2):
        sched.engine.release(done)
    window = _migrations(ctl.operate())
    return dict(chips=out["chips"], t_step=out["t_step"], pod=out["pod"], placed=placed,
                operate=window, migrations=_migrations(sched.migrations))


@pytest.mark.parametrize("arch", ["granite-3-2b", "dbrx-132b"])
def test_steps_five_and_seven_equal_the_reference(arch, solver_path):
    out = _both(lambda m: _controller(m, arch))
    assert out["pod"] == "osaka-spot" and len(out["operate"]) == 3
    assert out["operate"] == out["migrations"]


# ------------------------------------------------- the elastic bridge: parity --
def _run_scenario(m, name, policy="greedy", backend=None, **kwargs):
    spec = m["fleet"].build_scenario(name, **kwargs)
    if backend is not None:
        spec.config.elastic_backend = backend
    rt = spec.make_runtime(m["fleet"].get_policy(policy))
    return rt.run(spec.event_queue(), scenario=name, seed=kwargs.get("seed", 0))


@pytest.mark.parametrize("scenario,kwargs", [("paper-steady-state", {"n_arrivals": 200}),
                                             ("site-outage", {"n_arrivals": 120})])
def test_flat_parity_equals_the_reference(scenario, kwargs):
    """The simulated backend's no-declared-state fallback is the flat
    executor's behaviour, in both packages, with one fingerprint."""
    prints = []
    for m in SIDES:
        sim = _run_scenario(m, scenario, seed=3, **kwargs)
        flat = _run_scenario(m, scenario, seed=3, backend=m["fleet"].FlatStateBackend(64.0),
                             **kwargs)
        assert sim.counters["migrations_completed"] > 0
        assert sim.fingerprint() == flat.fingerprint()
        prints.append(sim.fingerprint())
    assert prints[0] == prints[1]


def _fleet_engine(m):
    pods = [m["cl"].PodSpec(f"pod{i}", 256, p) for i, p in enumerate((1.2, 1.2, 0.8, 0.8))]
    return m["place"].PlacementEngine(m["cl"].build_fleet_topology(pods), all_sites=True)


def _force_place(engine, job, pod):
    req = job.request()
    cand = next(c for c in engine.enumerate_feasible(req) if c.node.site_id == pod)
    return engine.commit(req, cand)


def _move_to(m, engine, req_id, pod):
    placed = engine.placed[req_id]
    new = next(c for c in engine.enumerate_feasible(placed.request) if c.node.site_id == pod)
    return m["mig"].Move(req_id, placed.candidate, new,
                         new.response_s / placed.response_s + new.price / placed.price)


def _fabricate(m, engine, moves):
    sat = [m["sat"].AppSatisfaction(mv.req_id, engine.placed[mv.req_id].response_s,
                                    mv.new.response_s, engine.placed[mv.req_id].price,
                                    mv.new.price) for mv in moves]
    return m["reconfig"].ReconfigResult([mv.req_id for mv in moves], moves, sat,
                                        2.0 * len(moves), sum(s.ratio for s in sat), True,
                                        None, 0.0)


@pytest.mark.parametrize("state_mb,flat_mb", [(512.0, 64.0), (None, 128.0)])
def test_executors_share_the_size_model_as_the_reference(state_mb, flat_mb):
    """`InstantExecutor` prices a declared-state job's copy from its
    checkpoint (downtime one dirty-page round of the same copy), and an
    undeclared one at the flat default."""
    def run(m):
        engine = _fleet_engine(m)
        placed = _force_place(engine, _job(m, 0, state_mb=state_mb), "pod0")
        mv = _move_to(m, engine, 0, "pod2")
        inst = m["fleet"].InstantExecutor(state_mb=flat_mb)
        item = inst.execute(engine, _fabricate(m, engine, [mv])).items[0]
        return (item.duration_s, item.step.mode, item.step.est_downtime_s,
                inst.backend.transfer_mbits(placed.request, mv))
    duration, mode, downtime, mbits = _both(run)
    assert mbits == (state_mb or flat_mb) * 8.0 and mode == "live"
    assert downtime == pytest.approx(0.05 * duration)


def test_simulated_phases_resize_and_rollback_equal_the_reference():
    """The simulated backend's snapshot, restore (mesh resized to the
    destination and back), rollback and release, on both sides."""
    def run(m):
        pods = [m["cl"].PodSpec("big", 8, 1.2), m["cl"].PodSpec("small", 4, 0.5)]
        engine = m["place"].PlacementEngine(m["cl"].build_fleet_topology(pods), all_sites=True)
        placed = _force_place(engine, _job(m, 0, chips=1, state_mb=2048.0), "big")
        backend = m["fleet"].SimulatedElasticBackend()
        backend.attach_job(0, mesh_plan=m["elastic"].MeshPlan((4, 2), ("data", "model")))
        out = []
        for pod in ("small", "big"):
            mv = _move_to(m, engine, 0, pod)
            ph = m["fleet"].execute_move(backend, placed.request, mv)
            out.append((dataclasses.astuple(ph), backend.mesh_plans[0].shape,
                        backend.predict_phases(placed.request, mv)))
        snap = backend.snapshot(placed.request, mv, 5.0)
        backend.rollback(placed.request, mv, snap, 6.0)
        out.append((dataclasses.astuple(snap), backend.rollbacks, backend.restores))
        backend.release(0)
        out.append((backend.snapshots, backend.mesh_plans))
        return out
    out = _both(run)
    assert [o[1] for o in out[:2]] == [(2, 2), (4, 2)]


# kimi-k2 is left out for its cost alone: the port builds its state on
# `meta` expert by expert (61 layers x 384 experts), about 2 minutes on a
# CPU core; dbrx-132b holds the MoE state here.
SIZED_ARCHS = [a for a in ARCH_IDS if a != "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("arch", SIZED_ARCHS)
def test_attach_job_sizes_a_config_as_the_reference(arch):
    """`attach_job(cfg=)`: the port counts its state's meta tensors, the
    reference runs `jax.eval_shape`; the same bytes, and so the same
    transfer and host phases, for every other architecture at full size
    (dense, MoE, hybrid, recurrent, encoder-decoder, VLM)."""
    tcfg, jcfg = get_config(arch), jget_config(arch)
    t, j = tf.SimulatedElasticBackend(), jf.SimulatedElasticBackend()
    t.attach_job(7, cfg=tcfg, optimizer=make_optimizer(tcfg.optimizer, lr=1e-3))
    j.attach_job(7, cfg=jcfg, optimizer=jmake_optimizer(jcfg.optimizer, lr=1e-3))
    treq, jreq = _job(T, 7).request(), _job(J, 7).request()
    assert t.predict_phases(treq) == j.predict_phases(jreq)
    assert t.predict_phases(treq)[0] > 8 * 1e3          # more than a GB


# -------------------------------------------------- the elastic bridge: live --
def test_auto_backend_follows_the_card(monkeypatch):
    import torch
    b = tf.auto_backend(state_mb=32.0)
    assert b.name == "simulated" and b.default_state_mb == 32.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tf.auto_backend().name == "live"


def test_the_live_backend_refuses_without_a_checkpoint_or_a_group(tmp_path):
    backend = tf.LiveElasticBackend()
    job = _job(T, 0)
    backend.register_job(0, str(tmp_path), get_config("granite-3-2b"), None,
                         telastic.MeshPlan((1, 1), ("data", "model")), device_type="cpu")
    assert backend.jobs[0].device_type == "cpu"
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        backend.snapshot(job.request(), None, 0.0)
    with pytest.raises(RuntimeError, match="init_process_group"):
        backend._devices(backend.jobs[0])


@pytest.fixture(scope="module")
def live_bridge(tmp_path_factory):
    return du.run_ranks("rank_live_bridge", 8, tmp_path_factory.mktemp("live"))


def test_live_move_resizes_and_reshards_onto_the_smaller_pod(live_bridge):
    from repro.ckpt import tree_nbytes
    from repro.train import state_shapes
    for r in live_bridge:
        assert (r["shape"], r["step"]) == ((2, 2), 4)
        ph = r["phases"]
        assert ph["snapshot_s"] > 0.0 and ph["restore_s"] > 0.0 and ph["mode"] == "stop_and_copy"
    assert [r["in_mesh"] for r in live_bridge] == [True] * 4 + [False] * 4
    assert live_bridge[0]["mesh_shape"] == (2, 2)
    # The checkpoint's payload is the reference's count of the same state.
    jcfg = du.granite_cut("jax")
    want = tree_nbytes(state_shapes(jcfg, jmake_optimizer("adamw", lr=1e-3)))
    assert live_bridge[0]["snapshot"][:3] == (want, 1, (4, 2))
    assert live_bridge[0]["phases"]["mbits"] == want * 8.0 / 1e6


def test_live_move_restores_every_leaf_bit_for_bit_and_resumes(live_bridge):
    for r in live_bridge[:4]:
        assert r["restored_equal"]
        assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
    assert all(r["losses"] == live_bridge[0]["losses"] for r in live_bridge[:4])


def test_live_rollback_reinstalls_the_source_checkpoint(live_bridge):
    for r in live_bridge:
        assert r["rollback"] == ((4, 2), (4, 2), 4, True)
