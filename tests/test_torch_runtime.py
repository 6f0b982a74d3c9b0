"""The port's runtime logic against the reference's on the same scripted
inputs: failure detection and recovery policy, the step timer, straggler
detection and mitigation, and mesh-plan resizing.  No device and no process
group is needed: the mesh plans are compared before they are built."""

import numpy as np
import pytest

from repro.runtime import elastic as jelastic
from repro.runtime import fault_tolerance as jft
from repro.runtime import straggler as jstrag
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import straggler as tstrag


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _heartbeat_run(mod, script, hosts=("h0", "h1", "h2", "h3")):
    """Drive a HeartbeatMonitor and a RecoveryPolicy with ``script``: a list
    of (time, hosts that beat); returns every poll's events and actions."""
    clock = Clock()
    mon = mod.HeartbeatMonitor(list(hosts), interval_s=10.0, miss_threshold=3, clock=clock)
    policy = mod.RecoveryPolicy(max_restarts=1)
    out = []
    for t, beats in script:
        clock.t = t
        for h in beats:
            mon.heartbeat(h)
        for ev in mon.poll():
            try:
                action = policy.decide(ev, len(mon.alive_hosts()), len(hosts))
            except RuntimeError as e:
                action = f"error: {e}"
            out.append((t, ev.host, ev.detected_at, ev.consecutive_misses, action))
        out.append((t, tuple(mon.alive_hosts())))
    return out


SCRIPTS = {
    "one_host_dies": [(5, "h0 h1 h2 h3".split()), (20, "h0 h1 h2".split()),
                      (45, "h0 h1 h2".split()), (60, "h0 h1 h2".split())],
    "restart_then_rescale": [(0, []), (35, "h1 h2 h3".split()), (36, ["h0"]),
                             (70, "h1 h2 h3".split()), (80, "h1 h2 h3".split())],
    "below_quorum": [(0, []), (31, ["h0"]), (65, ["h0"]), (100, [])],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_heartbeat_and_recovery_policy_match_the_reference(name):
    assert _heartbeat_run(tft, SCRIPTS[name]) == _heartbeat_run(jft, SCRIPTS[name])


def test_step_timer_matches_the_reference():
    def run(mod):
        clock = Clock()
        timer = mod.StepTimer(5.0, clock=clock)
        seen = [timer.expired()]
        timer.start()
        for t in (1.0, 5.0, 5.0001, 12.0):
            clock.t = t
            seen.append(timer.expired())
        return seen

    assert run(tft) == run(jft) == [False, False, False, True, True]
    assert tft.ACTION_RESTART == jft.ACTION_RESTART and tft.ACTION_RESCALE == jft.ACTION_RESCALE


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_detector_matches_the_reference(seed):
    """Random step times with one slow host that recovers late: the same
    EWMAs, actions, shares and batch splits, poll by poll."""
    hosts = [f"h{i}" for i in range(5)]
    rng = np.random.default_rng(seed)

    def run(mod):
        det = mod.StragglerDetector(hosts, mod.StragglerConfig(rebalance_after=2,
                                                               exclude_after=6))
        out = []
        for poll in range(14):
            for i, h in enumerate(hosts):
                slow = 3.0 if (i == 1 and poll < 9) or (i == 3 and 3 <= poll < 5) else 1.0
                det.record(h, float(times[poll, i]) * slow)
            out.append((det.poll(), dict(det.ewma), dict(det.shares), det.batch_split(64)))
        return out

    times = rng.uniform(0.9, 1.1, size=(14, len(hosts)))
    want, got = run(jstrag), run(tstrag)
    assert got == want
    assert any(tstrag.MITIGATE_EXCLUDE in actions.values() for actions, *_ in got)


PLANS = [((4, 2), ("data", "model"), 8), ((4, 2), ("data", "model"), 5),
         ((2, 2, 2), ("pod", "data", "model"), 6), ((8, 1), ("data", "model"), 3),
         ((4, 2), ("data", "model"), 1)]


@pytest.mark.parametrize("shape,names,n", PLANS)
def test_mesh_plans_resize_and_degrade_as_the_reference(shape, names, n):
    def run(mod):
        plan = mod.MeshPlan(shape, names)
        out = [plan.n_devices]
        for fn, arg in ((mod.resize_mesh_plan, n), (mod.degrade_mesh_plan, plan.n_devices - n)):
            try:
                new = fn(plan, arg)
                out.append((tuple(new.shape), tuple(new.axis_names), new.n_devices))
            except ValueError as e:
                out.append(("ValueError", str(e)))
        return out

    assert run(telastic) == run(jelastic)


def test_mesh_plan_build_needs_a_process_group():
    plan = telastic.MeshPlan((2, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="process group of at least 4 ranks"):
        plan.build(device_type="cpu")
    with pytest.raises(ValueError, match="backend"):
        plan.build(device_type="tpu")
    assert telastic.backend_for("cuda") == "nccl" and telastic.backend_for("cpu") == "gloo"
