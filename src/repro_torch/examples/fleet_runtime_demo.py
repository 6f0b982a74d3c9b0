"""Continuous-operation fleet runtime, end to end:

  1. compile a scenario (event schedule over a topology); the default is
     the flash-crowd-during-reconfig story: a forced reconfiguration's
     migrations are still copying state when a flash crowd lands and a
     node fails, aborting the transfers headed to it;
  2. drive it through the discrete-event runtime under three policies:
     the paper's MILP, the decomposed planner (`fleet.planner`) and a
     no-op control;
  3. print the per-tick telemetry so the adaptation is visible: moved
     apps, satisfaction of moved apps (fig. 5(b) quantity, raw and
     traffic-weighted), transfers started / in flight, utilization, and
     the migration ledger (durations, aborts, downtime).

    python -m repro_torch.examples.fleet_runtime_demo [scenario] [--device cuda]

The twin of the JAX package's ``examples/fleet_runtime_demo.py``.  The
simulator is numpy on the host; like every entry point of the port it
asks for the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.examples import device_of
from repro_torch.fleet import SCENARIOS, build_scenario, get_policy

POLICIES = ("milp", "decomposed", "noop")


def run_one(name: str, policy_name: str, seed: int = 0):
    spec = build_scenario(name, seed=seed)
    runtime = spec.make_runtime(get_policy(policy_name))
    return runtime.run(spec.event_queue(), scenario=name, seed=seed)


def _r(v, fmt="9.4f"):
    width = int(fmt.split(".")[0])
    return f"{v:{fmt}}" if v is not None else "--".rjust(width)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenario", nargs="?", default="flash-crowd-during-reconfig")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device_of(args.device)
    name = args.scenario
    if name not in SCENARIOS:
        raise SystemExit(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")

    print(f"scenario: {name}\n")
    out = {"scenario": name, "policies": {}}
    for policy in POLICIES:
        tel = run_one(name, policy)
        c = tel.counters
        print(f"--- policy = {policy} ---")
        print(f"{'t':>9} {'trigger':>9} {'alive':>5} {'moved':>5} "
              f"{'X+Y moved':>9} {'X+Y wtd':>9} {'start':>5} {'infl':>4} "
              f"{'rate':>5} {'util':>5}")
        for t in tel.ticks:
            print(f"{t.t:9.0f} {t.trigger:>9} {t.n_alive:5d} {t.n_moved:5d} "
                  f"{_r(t.mean_moved_ratio)} {_r(t.mean_moved_ratio_weighted)} "
                  f"{t.n_started:5d} {t.n_inflight:4d} "
                  f"{t.mean_rate:5.2f} {t.utilization:5.2f}")
        n_ab = sum(1 for m in tel.migrations if m.outcome == "aborted")
        print(f"totals: {c['arrivals']} arrivals ({c['arrivals_inflight']} during "
              f"in-flight migrations), {c['admitted']} admitted, "
              f"{c['rejected']} rejected, {c['departures']} departed, "
              f"{c['failover_moved']} failed over, {c['moves']} moves planned")
        print(f"ledger: {c['migrations_started']} transfers started, "
              f"{c['migrations_completed']} completed, {n_ab} aborted, "
              f"{c['migrations_cancelled']} cancelled; "
              f"total downtime {tel.total_downtime_s:.1f}s")
        mmr = tel.mean_moved_ratio
        print(f"mean moved-app satisfaction X+Y = "
              f"{mmr if mmr is None else round(mmr, 4)} "
              f"(2.0 = unchanged; paper fig. 5(b) ≈ 1.96)\n")
        out["policies"][policy] = {
            "fingerprint": tel.fingerprint(), "ticks": len(tel.ticks),
            "counters": dict(c), "aborted": n_ab, "downtime_s": tel.total_downtime_s,
            "mean_moved_ratio": mmr}
    return out


if __name__ == "__main__":
    main()
