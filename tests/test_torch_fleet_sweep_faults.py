"""The fleet runtime's fingerprint, scenario by policy, in the port and in
the JAX package: the fault and capacity scenarios (a backbone link cut, a
flapping node, cheap pods coming online, a node outage, a site outage)
under all 10 policies (the planner's among them), once on scipy's
`milp` and once on the solver's own fallback (`solver._HAVE_SCIPY` False
in both packages).  Each side is built from its own package and run as
a user runs it: `build_scenario`, then
`spec.make_runtime(get_policy(p)).run(spec.event_queue()).fingerprint()`
(the adaptive policy at a zero time budget, below); the fingerprints
leave out the wall-clock fields by the reference's own declared lists.
The other five scenarios are in `tests/test_torch_fleet_sweep_demand.py`."""

import pytest

import repro.fleet as jf
from repro.core import solver as jsolver
import repro_torch.fleet as tf
from repro_torch.core import solver as tsolver

SCENARIOS = ["backbone-cut", "flapping-node", "hetero-expansion",
             "node-outage", "site-outage"]
POLICIES = ["adaptive", "decomposed", "ga", "greedy", "hierarchical", "hillclimb", "horizon",
            "incremental", "milp", "noop"]
# The adaptive ladder steps down a tier when its plans' measured seconds
# pass `budget_s` (0.25 s by default), so which tier plans depends on the
# host's speed and load; at 0.0 it walks milp -> incremental -> greedy on
# any host, as the reference's benchmark holds it
# (benchmarks/bench_fleet.py's SLO cell).
POLICY_KWARGS = {"adaptive": {"budget_s": 0.0}}


def _fingerprint(fleet, scenario, policy):
    spec = fleet.build_scenario(scenario)
    rt = spec.make_runtime(fleet.get_policy(policy, **POLICY_KWARGS.get(policy, {})))
    return rt.run(spec.event_queue()).fingerprint()


@pytest.mark.parametrize("solver", ["milp", "fallback"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fingerprint_equals_the_reference(scenario, policy, solver, monkeypatch):
    if solver == "fallback":
        monkeypatch.setattr(tsolver, "_HAVE_SCIPY", False)
        monkeypatch.setattr(jsolver, "_HAVE_SCIPY", False)
    assert sorted(tf.POLICIES) == POLICIES
    assert _fingerprint(tf, scenario, policy) == _fingerprint(jf, scenario, policy)
