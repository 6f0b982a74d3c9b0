"""Scenario library for the continuous-operation runtime.

Each scenario deterministically (seeded rng) compiles to a topology + event
schedule + runtime config:

* ``paper-steady-state``   — the paper's workload run as a *service*:
  Poisson arrivals of the §4.1 app mix with exponential lifetimes,
  reconfiguration every 100 admissions over the recent-100 window.
* ``diurnal-streams``      — every app is a request *stream*: per-app
  diurnal `RateCurve`s (shared day/night phase, random amplitude, a few
  viral bursts) sampled by periodic `RequestRateUpdate` events, replacing
  the old step `DemandDrift` rescaling.
* ``flash-crowd``          — background trickle + a burst of short-lived
  apps concentrated on one user-edge region (hot links/devices).
* ``flash-crowd-during-reconfig`` — a forced reconfiguration, then a flash
  crowd of arrivals plus coordinated rate bursts land while the planned
  migrations are still in flight; a node failure mid-burst aborts the
  transfers headed to it.
* ``node-outage``          — steady state, then cloud GPU nodes fail
  mid-run and recover later (failover + re-optimization on recovery).
* ``site-outage``          — correlated failure: ALL nodes of one cloud
  site fail together and recover together.
* ``backbone-cut``         — a carrier→cloud backbone link is cut while
  transfers cross it (abort + source rollback, path filtering, eviction
  of apps routed over the link) and repaired later.
* ``flapping-node``        — one node periodically fails and recovers,
  churning placements (and colliding with in-flight migrations).
* ``hetero-expansion``     — a TPU pod fleet where cheap capacity comes
  online mid-run; reconfiguration migrates budget-bound jobs onto it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.apps import PlacementRequest, sample_requests
from repro_torch.core.cluster import JobSpec, PodSpec, build_fleet_topology
from repro_torch.core.topology import Topology, build_paper_topology

from .events import (
    AppArrival,
    Event,
    EventQueue,
    LinkFailure,
    LinkRecovery,
    NodeFailure,
    NodeRecovery,
    RateCurve,
    ReconfigTick,
    RequestRateUpdate,
    SessionArrival,
)
from .policies import ReconfigPolicy
from .runtime import FleetRuntime, RuntimeConfig
from .serving import ServingConfig, ServingProfile


@dataclasses.dataclass
class ScenarioSpec:
    name: str
    topo: Topology
    events: List[Tuple[float, Event]]
    config: RuntimeConfig
    all_sites: bool = False   # fleet topologies place across the whole tree

    def event_queue(self) -> EventQueue:
        return EventQueue(self.events)

    def make_runtime(self, policy: ReconfigPolicy,
                     tracer=None) -> FleetRuntime:
        return FleetRuntime(self.topo, policy, config=self.config,
                            all_sites=self.all_sites, tracer=tracer)


def _poisson_arrivals(
    topo: Topology,
    rng: np.random.Generator,
    n: int,
    mean_interarrival_s: float,
    mean_lifetime_s: float,
    start_id: int = 0,
    t0: float = 0.0,
    curve_fn: Optional[Callable[[int, float], Optional[RateCurve]]] = None,
) -> List[Tuple[float, Event]]:
    """``curve_fn(i, t_arrival) -> RateCurve|None`` attaches request streams."""
    reqs = sample_requests(topo, n, rng, start_id=start_id)
    out: List[Tuple[float, Event]] = []
    t = t0
    for i, req in enumerate(reqs):
        t += float(rng.exponential(mean_interarrival_s))
        curve = curve_fn(i, t) if curve_fn else None
        out.append((t, AppArrival(req, float(rng.exponential(mean_lifetime_s)),
                                  rate_curve=curve)))
    return out


def _site_nodes(topo: Topology, site_id: str) -> List[str]:
    return sorted(n.node_id for n in topo.nodes.values() if n.site_id == site_id)


# ----------------------------------------------------------------- scenarios
#
# Every paper-topology scenario takes ``scale``: tier counts, arrival
# volume and arrival *rate* all multiply, so per-node load density stays
# at the paper's level while the topology (and the reconfiguration MILP)
# grows ×2/×4/×8 — the ROADMAP solver-scaling sweep.  ``window`` /
# ``reconfig_every`` default to 100×scale but can be forced (the bench
# sweep uses 400×scale to record the monolithic solver's latency cliff).


def paper_steady_state(seed: int = 0, n_arrivals: Optional[int] = None,
                       scale: int = 1, window: Optional[int] = None,
                       reconfig_every: Optional[int] = None) -> ScenarioSpec:
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    n_arrivals = 1100 * scale if n_arrivals is None else n_arrivals
    events = _poisson_arrivals(topo, rng, n_arrivals,
                               mean_interarrival_s=10.0 / scale,
                               mean_lifetime_s=4_000.0)
    if window is None:
        window = 100 * scale
    if reconfig_every is None:
        reconfig_every = 100 * scale
    return ScenarioSpec("paper-steady-state", topo, events,
                        RuntimeConfig(reconfig_every=reconfig_every,
                                      window=window))


def diurnal_streams(seed: int = 0, n_arrivals: Optional[int] = None,
                    period_s: float = 4_000.0,
                    sample_every_s: float = 150.0,
                    scale: int = 1) -> ScenarioSpec:
    """Continuous per-app load curves instead of step demand drift: a
    shared day/night sinusoid (random amplitude per app), ~10 % of apps go
    viral with a burst segment, and the arrival rate itself swings over
    the same period."""
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    n_arrivals = 500 * scale if n_arrivals is None else n_arrivals
    reqs = sample_requests(topo, n_arrivals, rng)
    events: List[Tuple[float, Event]] = []
    t = 0.0
    for req in reqs:
        arrival_rate = 1.0 + 0.8 * np.sin(2.0 * np.pi * t / period_s)
        t += float(rng.exponential(8.0 / scale / max(arrival_rate, 0.2)))
        bursts: Tuple[Tuple[float, float, float], ...] = ()
        if rng.random() < 0.1:   # viral app: one strong burst mid-life
            bursts = ((t + float(rng.uniform(200.0, 1_500.0)),
                       float(rng.uniform(200.0, 500.0)),
                       float(rng.uniform(2.0, 4.0))),)
        curve = RateCurve(base=1.0,
                          amplitude=float(rng.uniform(0.3, 0.7)),
                          period_s=period_s,
                          phase=0.0,        # the day is shared fleet-wide
                          bursts=bursts)
        events.append((t, AppArrival(req, float(rng.exponential(1_500.0)),
                                     rate_curve=curve)))
    events.append((sample_every_s, RequestRateUpdate(sample_every_s, t)))
    return ScenarioSpec("diurnal-streams", topo, events,
                        RuntimeConfig(reconfig_every=60 * scale,
                                      window=80 * scale))


def flash_crowd(seed: int = 0, n_background: Optional[int] = None,
                n_burst: Optional[int] = None, scale: int = 1) -> ScenarioSpec:
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    n_background = 350 * scale if n_background is None else n_background
    n_burst = 150 * scale if n_burst is None else n_burst
    events = _poisson_arrivals(topo, rng, n_background,
                               mean_interarrival_s=16.0 / scale,
                               mean_lifetime_s=3_000.0)
    burst_t0 = events[len(events) // 2][0]   # burst lands mid-run
    hot_sites = [f"input{i}" for i in range(5)]  # one user-edge region
    burst = sample_requests(topo, n_burst, rng, start_id=n_background)
    t = burst_t0
    for req in burst:
        t += float(rng.exponential(0.4 / scale))  # ~150·scale arrivals in ~60 s
        req = dataclasses.replace(
            req, input_site=hot_sites[int(rng.integers(len(hot_sites)))])
        events.append((t, AppArrival(req, float(rng.exponential(600.0)))))
    return ScenarioSpec("flash-crowd", topo, events,
                        RuntimeConfig(reconfig_every=50 * scale,
                                      window=100 * scale))


def flash_crowd_during_reconfig(seed: int = 0, n_background: Optional[int] = None,
                                n_burst: Optional[int] = None,
                                scale: int = 1) -> ScenarioSpec:
    """The regime the paper's relocation-during-operation story hinges on:
    a reconfiguration is forced, and while its migrations are still copying
    state a flash crowd arrives on one edge region AND running apps there
    spike (burst segments on their curves); a GPU node then fails
    mid-transfer window, aborting the migrations headed to it."""
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    n_background = 400 * scale if n_background is None else n_background
    n_burst = 120 * scale if n_burst is None else n_burst
    hot_sites = [f"input{i}" for i in range(5)]
    burst_t0 = n_background * 12.0 / scale * 0.55   # mid-run, after churn

    def curve_fn(i: int, t_arrival: float) -> Optional[RateCurve]:
        # Apps arriving before the crowd carry a coordinated burst segment:
        # the crowd also hammers already-running deployments.
        if t_arrival < burst_t0 and rng.random() < 0.25:
            return RateCurve(bursts=((burst_t0, 120.0,
                                      float(rng.uniform(1.5, 3.0))),))
        return None

    events = _poisson_arrivals(topo, rng, n_background,
                               mean_interarrival_s=12.0 / scale,
                               mean_lifetime_s=3_500.0,
                               curve_fn=curve_fn)
    # Force a reconfiguration just before the crowd: its migrations (tens
    # of seconds over 10–100 Mbps uplinks) are in flight when it hits.
    events.append((burst_t0 - 5.0, ReconfigTick()))
    burst = sample_requests(topo, n_burst, rng, start_id=n_background)
    t = burst_t0
    for req in burst:
        t += float(rng.exponential(0.5 / scale))
        req = dataclasses.replace(
            req, input_site=hot_sites[int(rng.integers(len(hot_sites)))])
        events.append((t, AppArrival(req, float(rng.exponential(600.0)))))
    # A destination-side failure inside the transfer window.
    events.append((burst_t0 + 10.0, NodeFailure("cloud0_gpu0")))
    events.append((burst_t0 + 600.0, NodeRecovery("cloud0_gpu0")))
    events.append((burst_t0 / 2.0, RequestRateUpdate(60.0, burst_t0 + 300.0)))
    return ScenarioSpec("flash-crowd-during-reconfig", topo, events,
                        RuntimeConfig(reconfig_every=50 * scale,
                                      window=100 * scale))


def node_outage(seed: int = 0, n_arrivals: Optional[int] = None,
                scale: int = 1) -> ScenarioSpec:
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    n_arrivals = 500 * scale if n_arrivals is None else n_arrivals
    events = _poisson_arrivals(topo, rng, n_arrivals,
                               mean_interarrival_s=10.0 / scale,
                               mean_lifetime_s=4_000.0)
    horizon = events[-1][0]
    for k, node in enumerate(("cloud0_gpu0", "cloud0_gpu1", "cloud1_fpga0")):
        events.append((horizon * 0.5 + k, NodeFailure(node)))
        events.append((horizon * 0.8 + k, NodeRecovery(node)))
    return ScenarioSpec("node-outage", topo, events,
                        RuntimeConfig(reconfig_every=80 * scale,
                                      window=100 * scale))


def site_outage(seed: int = 0, n_arrivals: Optional[int] = None,
                site: str = "cloud1", scale: int = 1) -> ScenarioSpec:
    """Correlated failure: every device node of one cloud site goes dark in
    the same instant (power/network cut) and the whole site returns later."""
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    n_arrivals = 450 * scale if n_arrivals is None else n_arrivals
    events = _poisson_arrivals(topo, rng, n_arrivals,
                               mean_interarrival_s=10.0 / scale,
                               mean_lifetime_s=4_000.0)
    horizon = events[-1][0]
    for node in _site_nodes(topo, site):
        events.append((horizon * 0.5, NodeFailure(node)))
        events.append((horizon * 0.8, NodeRecovery(node)))
    return ScenarioSpec("site-outage", topo, events,
                        RuntimeConfig(reconfig_every=80 * scale,
                                      window=100 * scale))


def backbone_cut(seed: int = 0, n_arrivals: Optional[int] = None,
                 link: str = "link_carrier0_cloud0",
                 scale: int = 1) -> ScenarioSpec:
    """Uplink-cut failure (ROADMAP open item): a carrier→cloud backbone
    link is cut mid-run.  A reconfiguration is forced just before the cut
    so transfers crossing the link are in flight when it dies (abort +
    source rollback); every app whose live path used the link is evicted
    and re-placed below the cut (or lost), and the link returns later."""
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    if link not in topo.links:
        raise ValueError(f"unknown link {link!r}")
    n_arrivals = 450 * scale if n_arrivals is None else n_arrivals
    events = _poisson_arrivals(topo, rng, n_arrivals,
                               mean_interarrival_s=10.0 / scale,
                               mean_lifetime_s=4_000.0)
    horizon = events[-1][0]
    events.append((horizon * 0.5 - 5.0, ReconfigTick()))
    events.append((horizon * 0.5, LinkFailure(link)))
    events.append((horizon * 0.8, LinkRecovery(link)))
    return ScenarioSpec("backbone-cut", topo, events,
                        RuntimeConfig(reconfig_every=80 * scale,
                                      window=100 * scale))


def flapping_node(seed: int = 0, n_arrivals: Optional[int] = None,
                  node: str = "cloud0_gpu0", up_s: float = 600.0,
                  down_s: float = 200.0, scale: int = 1) -> ScenarioSpec:
    """One node flaps: repeatedly fails for ``down_s`` then recovers for
    ``up_s`` over the middle half of the run — each flap evicts its apps,
    aborts transfers headed to it, and triggers re-optimization."""
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    n_arrivals = 450 * scale if n_arrivals is None else n_arrivals
    events = _poisson_arrivals(topo, rng, n_arrivals,
                               mean_interarrival_s=10.0 / scale,
                               mean_lifetime_s=4_000.0)
    horizon = events[-1][0]
    t = horizon * 0.25
    while t < horizon * 0.75:
        events.append((t, NodeFailure(node)))
        events.append((t + down_s, NodeRecovery(node)))
        t += down_s + up_s
    return ScenarioSpec("flapping-node", topo, events,
                        RuntimeConfig(reconfig_every=80 * scale,
                                      window=100 * scale))


def hetero_expansion(seed: int = 0, n_jobs: Optional[int] = None,
                     scale: int = 1,
                     state_mb_per_chip: float = 48.0) -> ScenarioSpec:
    """TPU fleet: expensive pods serve first; cheap pods come online later.
    ``scale`` replicates the 5-pod group (suffix ``-gN``) and the job mix.

    Jobs declare real migratable state — ``state_mb_per_chip`` MB of
    checkpoint per chip (≈ a 2-byte/param model plus fp32 Adam moments
    sharded across the slice) — so the elastic bridge derives each
    migration's transfer bytes and snapshot/restore phase times from the
    checkpoint instead of the flat executor default
    (`fleet.elastic_bridge.SimulatedElasticBackend`)."""
    rng = np.random.default_rng(seed)
    n_jobs = 140 * scale if n_jobs is None else n_jobs
    pods: List[PodSpec] = []
    spot_pods: List[str] = []
    for g in range(scale):
        sfx = "" if scale == 1 else f"-g{g}"
        pods += [PodSpec(f"tokyo-a{sfx}", 256, 1.2),
                 PodSpec(f"tokyo-b{sfx}", 256, 1.2),
                 PodSpec(f"osaka-v5p{sfx}", 256, 2.1),
                 PodSpec(f"spot-a{sfx}", 256, 0.8),
                 PodSpec(f"spot-b{sfx}", 256, 0.8)]
        spot_pods += [f"spot-a{sfx}", f"spot-b{sfx}"]
    topo = build_fleet_topology(pods)
    events: List[Tuple[float, Event]] = []
    # The spot pods are "not yet provisioned": fail them before any arrival.
    for pod in spot_pods:
        events.append((0.0, NodeFailure(f"{pod}_tpu")))
    t = 0.0
    for i in range(n_jobs):
        t += float(rng.exponential(30.0 / scale))
        step = float(rng.uniform(0.5, 5.0))
        job = JobSpec(i, f"arch{i % 5}", "train_4k", chips=32,
                      step_time_s=step,
                      step_slo_s=None if i % 2 else step * 3.0,
                      budget_usd_month=float(rng.uniform(5e4, 3e5)) if i % 2 else None,
                      state_mb=32 * state_mb_per_chip)
        events.append((t, AppArrival(job.request(), float(rng.exponential(900.0)))))
    horizon = t
    for k, pod in enumerate(spot_pods):              # expansion lands mid-run
        events.append((horizon * 0.55 + k, NodeRecovery(f"{pod}_tpu")))
    return ScenarioSpec("hetero-expansion", topo, events,
                        RuntimeConfig(reconfig_every=16 * scale,
                                      window=32 * scale),
                        all_sites=True)


def serving_fleet(seed: int = 0, scale: int = 1,
                  n_serving: Optional[int] = None,
                  n_background: Optional[int] = None,
                  sessions_per_app: int = 10,
                  strategy: Optional[str] = None,
                  flash: bool = False) -> ScenarioSpec:
    """Serving as a first-class fleet workload (`fleet.serving`): a core
    of long-lived serving apps — token-level session streams against
    each (`SessionArrival`: prefill burst + decode cadence) — churned by
    background batch arrivals that keep the reconfigurator ticking, so
    serving apps migrate *while decoding* and the backend must pick a
    KV-cache-aware strategy per move (forced fleet-wide by
    ``strategy``).  ``flash=True`` lands a flash crowd plus a session
    burst while a forced reconfiguration's transfers are still in
    flight — the tokens-under-migration stress variant."""
    rng = np.random.default_rng(seed)
    topo = build_paper_topology(scale=scale)
    n_serving = 16 * scale if n_serving is None else n_serving
    n_background = 140 * scale if n_background is None else n_background
    horizon = n_background * 8.0 / scale
    serving_reqs = sample_requests(topo, n_serving, rng)
    events: List[Tuple[float, Event]] = []
    profiles: Dict[int, ServingProfile] = {}
    session_id = 0
    t = 0.0
    for req in serving_reqs:
        t += float(rng.exponential(4.0))
        # Gentle rate curves: per-update swings stay under the runtime's
        # ``rate_epsilon`` so a serving app is never force-readmitted (and
        # possibly lost) by its own traffic wobble — only failures cancel.
        curve = RateCurve(base=1.0,
                          amplitude=float(rng.uniform(0.05, 0.15)),
                          period_s=2_000.0)
        # Serving apps outlive the run: pending tokens are never
        # cancelled by a scheduled departure (only failures cancel).
        events.append((t, AppArrival(req, horizon * 2.0, rate_curve=curve)))
        profiles[req.req_id] = ServingProfile()
        ts = t + 1.0
        for _ in range(sessions_per_app):
            ts += float(rng.exponential(horizon / (2.0 * sessions_per_app)))
            # Decode-heavy sessions: tens of seconds of cadence each, so
            # reconfigurations routinely catch live KV context mid-decode.
            events.append((ts, SessionArrival(
                req.req_id, session_id,
                prompt_tokens=int(rng.integers(16, 64)),
                decode_tokens=int(rng.integers(192, 512)))))
            session_id += 1
    events += _poisson_arrivals(topo, rng, n_background,
                                mean_interarrival_s=8.0 / scale,
                                mean_lifetime_s=600.0,
                                start_id=n_serving)
    events.append((60.0, RequestRateUpdate(60.0, horizon)))
    if flash:
        burst_t0 = horizon * 0.5
        events.append((burst_t0 - 5.0, ReconfigTick()))
        hot_sites = [f"input{i}" for i in range(5)]
        burst = sample_requests(topo, 60 * scale, rng,
                                start_id=n_serving + n_background)
        tb = burst_t0
        for req in burst:
            tb += float(rng.exponential(0.5 / scale))
            req = dataclasses.replace(
                req, input_site=hot_sites[int(rng.integers(len(hot_sites)))])
            events.append((tb, AppArrival(req, float(rng.exponential(400.0)))))
        # Session burst against every serving app inside the in-flight
        # transfer window: tokens decode *during* the migrations.
        for req in serving_reqs:
            for _ in range(3):
                events.append((burst_t0 + float(rng.uniform(0.0, 30.0)),
                               SessionArrival(
                                   req.req_id, session_id,
                                   prompt_tokens=int(rng.integers(32, 96)),
                                   decode_tokens=int(rng.integers(96, 256)))))
                session_id += 1
    # The window spans the whole fleet so long-lived serving apps keep
    # getting re-planned (and migrated) as background churn frees nodes.
    cfg = RuntimeConfig(
        reconfig_every=40 * scale,
        window=(n_serving + n_background) * 2,
        serving=ServingConfig(profiles=profiles, forced_strategy=strategy))
    return ScenarioSpec("serving-fleet", topo, events, cfg)


SCENARIOS: Dict[str, Callable[..., ScenarioSpec]] = {
    "paper-steady-state": paper_steady_state,
    "diurnal-streams": diurnal_streams,
    "flash-crowd": flash_crowd,
    "flash-crowd-during-reconfig": flash_crowd_during_reconfig,
    "node-outage": node_outage,
    "site-outage": site_outage,
    "backbone-cut": backbone_cut,
    "flapping-node": flapping_node,
    "hetero-expansion": hetero_expansion,
    "serving-fleet": serving_fleet,
}


def build_scenario(name: str, seed: int = 0, **kwargs) -> ScenarioSpec:
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}") from None
    return fn(seed=seed, **kwargs)
