"""Application profiles, user requirements and placement candidates.

Paper §4.1: two converted applications with measured offload profiles:

* **NAS.FT** — FFT, GPU-offloaded (5× vs CPU): 1 GB GPU RAM, 2 Mbps,
  0.2 MB transfer, 5.8 s processing.
* **MRI-Q** — MRI reconstruction, FPGA-offloaded (7× vs CPU): 10 % of an
  FPGA, 1 Mbps, 0.15 MB transfer, 2.0 s processing.

Response time (eq. 2) and price (eq. 3) of a concrete placement are
computed here; both are *fully determined* by the (app, node, link-path)
triple, which lets the MILP treat each candidate placement as one binary
variable with precomputed (R, P) coefficients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .topology import TIER_INPUT, DeviceNode, Link, Topology

OBJ_RESPONSE = "response"
OBJ_PRICE = "price"


@dataclasses.dataclass(frozen=True)
class AppProfile:
    """Measured resource profile of a converted app (paper fig. 4 params)."""

    name: str
    device_kind: str          # offload target device kind
    device_usage: float       # B^d_k, in the node's capacity units
    bandwidth_mbps: float     # B^l_k
    data_mb: float            # C_k  (transferred per request)
    proc_time_s: float        # B^p_{i,k} on the offload device
    cpu_proc_time_s: Optional[float] = None  # un-offloaded fallback (unused in paper sim)
    # Migratable state (checkpoint payload) in MB.  None = the app carries
    # no declared state and migrations fall back to the executor's flat
    # default; training jobs (`core.cluster.JobSpec`) declare their real
    # checkpoint size here so `fleet.elastic_bridge` can derive transfer
    # bytes and snapshot/restore phase times from it.
    state_mb: Optional[float] = None

    def __hash__(self) -> int:
        # Same value the generated frozen-dataclass __hash__ would produce,
        # cached: profiles key the admission decision cache, so this is hit
        # once per arrival at fleet scale.
        try:
            return self._cached_hash
        except AttributeError:
            h = hash((self.name, self.device_kind, self.device_usage,
                      self.bandwidth_mbps, self.data_mb, self.proc_time_s,
                      self.cpu_proc_time_s, self.state_mb))
            object.__setattr__(self, "_cached_hash", h)
            return h


NAS_FT = AppProfile("NAS.FT", "gpu", 1.0, 2.0, 0.2, 5.8, cpu_proc_time_s=5.8 * 5)
MRI_Q = AppProfile("MRI-Q", "fpga", 0.1, 1.0, 0.15, 2.0, cpu_proc_time_s=2.0 * 7)


@dataclasses.dataclass(frozen=True)
class Requirement:
    """Per-request user requirement (paper §3.3): upper bounds + objective.

    ``objective`` is which metric to minimize.  Paper rules: if only one
    bound is given, the objective is the *other* metric; if both are given
    the user picks one at random (§4.1.2).
    """

    r_upper: Optional[float]  # seconds
    p_upper: Optional[float]  # ¥/month
    objective: str

    def __post_init__(self) -> None:
        if self.objective not in (OBJ_RESPONSE, OBJ_PRICE):
            raise ValueError(f"bad objective {self.objective}")
        if self.r_upper is None and self.p_upper is None:
            raise ValueError("at least one of r_upper/p_upper required")
        # Precomputed generated-equivalent hash: requirements are minted
        # fresh per request and hashed once on the admission fast path, so
        # the first (and usually only) hash must not pay a miss.
        object.__setattr__(
            self, "_cached_hash",
            hash((self.r_upper, self.p_upper, self.objective)))

    def __hash__(self) -> int:
        return self._cached_hash

    def __eq__(self, other: object) -> bool:
        # Same semantics as the generated field-tuple comparison, without
        # allocating the two tuples: requirements are fresh objects per
        # request, so the admission decision-cache probe compares them by
        # value on every arrival.
        if other.__class__ is not Requirement:
            return NotImplemented
        return (self.r_upper == other.r_upper
                and self.p_upper == other.p_upper
                and self.objective == other.objective)


@dataclasses.dataclass(frozen=True)
class PlacementRequest:
    """One user's request to deploy ``app`` fed from ``input_site``."""

    req_id: int
    app: AppProfile
    input_site: str
    requirement: Requirement


@dataclasses.dataclass(frozen=True)
class Candidate:
    """A concrete placement option: node + uplink path, with (R, P) metrics."""

    node: DeviceNode
    links: Tuple[Link, ...]
    response_s: float
    price: float


def response_time(app: AppProfile, node: DeviceNode, links: Sequence[Link]) -> float:
    """Eq. (2) LHS:  Σ A^d·B^p  +  Σ A^l · C_k / B^l_k  (per-hop transfer)."""
    if node.kind == app.device_kind:
        proc = app.proc_time_s
    elif node.kind == "cpu" and app.cpu_proc_time_s is not None:
        proc = app.cpu_proc_time_s
    else:
        raise ValueError(f"{app.name} cannot run on {node.kind}")
    transfer = sum(app.data_mb * 8.0 / app.bandwidth_mbps for _ in links)
    return proc + transfer


def price(app: AppProfile, node: DeviceNode, links: Sequence[Link]) -> float:
    """Eq. (3) LHS:  Σ a_i·B^d_k/C^d_i  +  Σ b_j·B^l_k/C^l_j."""
    p = node.monthly_price * (app.device_usage / node.capacity)
    for l in links:
        p += l.monthly_price * (app.bandwidth_mbps / l.bandwidth_mbps)
    return p


def enumerate_candidates(
    topo: Topology,
    request: PlacementRequest,
    allow_cpu_fallback: bool = False,
    all_sites: bool = False,
) -> List[Candidate]:
    """All placements of ``request``: its uplink chain (paper topology), or
    every compute site via LCA paths (``all_sites`` — fleet topologies).
    Feasibility is NOT applied here — requirement filtering happens in the
    LP layer so tests can inspect raw candidates."""
    out: List[Candidate] = []
    app = request.app
    kinds = [app.device_kind] + (["cpu"] if allow_cpu_fallback and app.cpu_proc_time_s else [])
    if all_sites:
        sites = sorted(s.site_id for s in topo.sites.values() if s.tier != TIER_INPUT)
    else:
        sites = topo.compute_sites_above(request.input_site)
    for site_id in sites:
        links = (topo.path_between(request.input_site, site_id) if all_sites
                 else topo.uplink_path(request.input_site, site_id))
        for kind in kinds:
            for node in topo.nodes_at(site_id, kind):
                out.append(
                    Candidate(
                        node=node,
                        links=links,
                        response_s=response_time(app, node, links),
                        price=price(app, node, links),
                    )
                )
    return out


def feasible(cand: Candidate, req: Requirement) -> bool:
    """Constraints (2)–(3): user upper bounds (capacity handled separately)."""
    if req.r_upper is not None and cand.response_s > req.r_upper + 1e-9:
        return False
    if req.p_upper is not None and cand.price > req.p_upper + 1e-9:
        return False
    return True


# --------------------------------------------------------------------------
# Paper §4.1.2 requirement distributions.
#
# NAS.FT price caps: a=¥7500, b=¥8500, c=¥10000;  response caps: A=6 s,
# B=7 s, C=10 s.  Patterns a,b,c,A,B,C,aC,bB,bC,cA,cB,cC each 1/12.
# MRI-Q price caps: x=¥12500, y=¥20000 (paper prints "2000", which is
# infeasible everywhere — see DESIGN.md §2.1); response caps X=4 s, Y=8 s.
# Patterns x,y,X,Y,xY,yX,yY each 1/7.
# --------------------------------------------------------------------------

_NASFT_P = {"a": 7_500.0, "b": 8_500.0, "c": 10_000.0}
_NASFT_R = {"A": 6.0, "B": 7.0, "C": 10.0}
_MRIQ_P = {"x": 12_500.0, "y": 20_000.0}
_MRIQ_R = {"X": 4.0, "Y": 8.0}

NASFT_PATTERNS = ["a", "b", "c", "A", "B", "C", "aC", "bB", "bC", "cA", "cB", "cC"]
MRIQ_PATTERNS = ["x", "y", "X", "Y", "xY", "yX", "yY"]


def requirement_from_pattern(pattern: str, rng: np.random.Generator) -> Requirement:
    """Decode a pattern string like ``"bC"`` into a `Requirement`."""
    p_upper = None
    r_upper = None
    for ch in pattern:
        if ch in _NASFT_P:
            p_upper = _NASFT_P[ch]
        elif ch in _NASFT_R:
            r_upper = _NASFT_R[ch]
        elif ch in _MRIQ_P:
            p_upper = _MRIQ_P[ch]
        elif ch in _MRIQ_R:
            r_upper = _MRIQ_R[ch]
        else:
            raise ValueError(f"bad pattern char {ch!r} in {pattern!r}")
    if p_upper is not None and r_upper is not None:
        objective = OBJ_RESPONSE if rng.random() < 0.5 else OBJ_PRICE
    elif p_upper is not None:
        objective = OBJ_RESPONSE  # price bounded → minimize response
    else:
        objective = OBJ_PRICE     # response bounded → minimize price
    return Requirement(r_upper=r_upper, p_upper=p_upper, objective=objective)


def sample_requests(
    topo: Topology,
    n: int,
    rng: np.random.Generator,
    nasft_ratio: float = 0.75,
    start_id: int = 0,
) -> List[PlacementRequest]:
    """Paper workload: NAS.FT : MRI-Q = 3 : 1, input node uniform-random."""
    input_sites = [s.site_id for s in topo.sites.values() if s.tier == "input"]
    input_sites.sort()
    out: List[PlacementRequest] = []
    for i in range(n):
        if rng.random() < nasft_ratio:
            app, patterns = NAS_FT, NASFT_PATTERNS
        else:
            app, patterns = MRI_Q, MRIQ_PATTERNS
        pattern = patterns[int(rng.integers(len(patterns)))]
        req = requirement_from_pattern(pattern, rng)
        site = input_sites[int(rng.integers(len(input_sites)))]
        out.append(PlacementRequest(start_id + i, app, site, req))
    return out
