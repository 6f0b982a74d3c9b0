"""Accelerator-fleet instantiation of the paper's placement/reconfiguration
engine; the port of `repro.core.cluster`, the same numpy.

The paper's entities map 1:1 (DESIGN.md §3):

  compute site  → pod (e.g. a v5e-256);  device node → schedulable slice
  quota inside a pod (capacity = chips);  link → inter-pod DCN with a
  bandwidth cap and monthly price;  app → a training/serving *job* for one
  (arch × shape) cell;  B^p (processing time) → the job's roofline step
  time on that slice (from the dry-run table);  response-time requirement →
  step-time / decode-latency SLO;  price requirement → $/month budget.

The SAME `PlacementEngine`/`Reconfigurator` then do admission (eqs. 2–5)
and in-operation reconfiguration (eq. 1); accepted moves are executed as
checkpoint → re-shard → resume through `runtime.elastic` — live migration
for training jobs.

The identifiers stay the reference's (``KIND_TPU = "tpu"``, node ids
``f"{pod}_tpu"``) so that the fleet's fingerprints equal the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from .apps import AppProfile, PlacementRequest, Requirement
from .placement import PlacementEngine
from .reconfig import Reconfigurator
from .topology import DeviceNode, Link, Site, Topology

KIND_TPU = "tpu"


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """One pod of the fleet.  The defaults (``chip_hour_usd=1.2``,
    ``generation="v5e"``) are the reference's TPU figures, kept for parity;
    they are not an H100 price."""

    name: str
    chips: int = 256
    chip_hour_usd: float = 1.2     # v5e on-demand-ish
    generation: str = "v5e"


def build_fleet_topology(
    pods: Sequence[PodSpec],
    dcn_gbps: float = 100.0,
    dcn_monthly_usd: float = 2_000.0,
) -> Topology:
    """Star topology: pods hang off a logical fabric root (site "fabric").
    Device capacity = chips; node price = pod monthly cost at full use."""
    sites: List[Site] = [Site("fabric", "cloud", None)]
    nodes: List[DeviceNode] = []
    links: List[Link] = []
    for p in pods:
        sites.append(Site(p.name, "carrier_edge", "fabric"))
        monthly = p.chips * p.chip_hour_usd * 24 * 30
        nodes.append(DeviceNode(f"{p.name}_tpu", p.name, KIND_TPU, float(p.chips), monthly))
        links.append(Link(f"dcn_{p.name}", p.name, "fabric", dcn_gbps * 1000.0,
                          dcn_monthly_usd))
    return Topology(sites, nodes, links)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant job: run `arch × shape` on `chips` chips."""

    job_id: int
    arch: str
    shape: str
    chips: int
    step_time_s: float             # roofline t_step on a slice of `chips`
    bandwidth_mbps: float = 100.0  # ckpt/serving egress on the DCN
    data_mb: float = 1.0           # per-request data (serving) / ckpt stream
    step_slo_s: Optional[float] = None
    budget_usd_month: Optional[float] = None
    # Checkpointed state (params + optimizer moments) the job's migration
    # must copy, in MB.  None keeps the legacy flat executor default; the
    # fleet scenarios size it per chip (`fleet.scenarios.hetero_expansion`)
    # so the elastic bridge derives real snapshot/transfer/restore phases.
    state_mb: Optional[float] = None

    def profile(self) -> AppProfile:
        return AppProfile(
            name=f"{self.arch}×{self.shape}",
            device_kind=KIND_TPU,
            device_usage=float(self.chips),
            bandwidth_mbps=self.bandwidth_mbps,
            data_mb=self.data_mb,
            proc_time_s=self.step_time_s,
            state_mb=self.state_mb,
        )

    def request(self, input_site: str = "fabric") -> PlacementRequest:
        req = Requirement(
            r_upper=self.step_slo_s,
            p_upper=self.budget_usd_month,
            objective="price" if self.step_slo_s is not None else "response",
        )
        return PlacementRequest(self.job_id, self.profile(), input_site, req)


def jobs_from_dryrun(results_path: str, chips: int = 256,
                     slo_factor: float = 1.5,
                     budget_factor: float = 1.3,
                     chip_hour_usd: float = 1.2) -> List[JobSpec]:
    """Turn the dry-run roofline table (the JSON list that `python -m
    repro_torch.launch.dryrun --out F` writes) into a job mix: each traced cell
    becomes a job whose SLO is `slo_factor ×` its roofline step time and
    whose budget is `budget_factor ×` the cheapest pod's price."""
    rows = json.load(open(results_path))
    jobs: List[JobSpec] = []
    base_month = chips * chip_hour_usd * 24 * 30
    for i, r in enumerate(rows):
        if r.get("status") != "ok":
            continue
        t = r["roofline"]["t_step_s"]
        jobs.append(JobSpec(
            job_id=i, arch=r["arch"], shape=r["shape"], chips=chips,
            step_time_s=t, step_slo_s=t * slo_factor,
            budget_usd_month=base_month * budget_factor,
        ))
    return jobs


class FleetScheduler:
    """Admission + periodic reconfiguration over a pod fleet.

    Jobs are placed FCFS under their SLO/budget bounds (Step 5); every
    ``reconfig_every`` admissions, the most recent ``window`` jobs are
    jointly re-optimized (Step 7) through a pluggable policy
    (`fleet.policies`: "milp" — the paper's exact solver — "greedy",
    "hillclimb", "ga") and accepted moves are executed via the
    bandwidth-aware migration executor; the resulting schedule entries are
    migration directives for `runtime.elastic`."""

    def __init__(self, topo: Topology, reconfig_every: int = 16,
                 window: int = 32, move_penalty: float = 0.01,
                 policy: str = "milp", state_mb: float = 64.0):
        # Imported here: repro_torch.fleet builds on repro_torch.core (not the reverse).
        from repro_torch.fleet.executor import InstantExecutor
        from repro_torch.fleet.policies import get_policy

        self.engine = PlacementEngine(topo, all_sites=True)
        self.recon = Reconfigurator(self.engine, move_penalty=move_penalty)
        self.policy = get_policy(policy, move_penalty=move_penalty)
        self.executor = InstantExecutor(state_mb=state_mb)
        self.reconfig_every = reconfig_every
        self.window = window
        self.admitted = 0
        self.migrations: List = []

    def submit(self, job: JobSpec):
        """Returns the placed pod name, or None if rejected."""
        placed = self.engine.place(job.request(input_site="fabric"))
        self.admitted += 1
        result = None
        if placed is not None:
            result = placed.candidate.node.site_id
        if self.admitted % self.reconfig_every == 0:
            res = self.policy.plan(self.engine, self.engine.recent(self.window))
            if res.accepted:
                schedule = self.executor.execute(self.engine, res)
                self.migrations.extend(schedule.items)
        return result

    def utilization(self) -> Dict[str, float]:
        out = {}
        for nid, node in self.engine.topo.nodes.items():
            if node.kind == KIND_TPU:
                out[node.site_id] = self.engine.node_used[nid] / node.capacity
        return out
