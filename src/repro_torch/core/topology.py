"""Resource topology for environment-adaptive placement (paper §3.2, §4.1.2).

The paper assumes a 3-tier compute topology — cloud / carrier edge / user
edge — below which *input nodes* (IoT sources) generate data.  Compute sites
host typed device servers (CPU / GPU / FPGA); sites are wired as a tree with
priced, capacity-limited links:

    cloud (5) --100 Mbps/¥8k-- carrier edge (20) --10 Mbps/¥3k-- user edge (60)
                                                                    |
                                                            input nodes (300)

The same structures model an accelerator fleet (`core/cluster.py`): sites = pods,
device nodes = slices, links = DCN/ICI — the placement math is identical.

Units: time s, bandwidth Mbps, data MB, price ¥/month (or $/h for fleets —
the math only needs consistency).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

TIER_CLOUD = "cloud"
TIER_CARRIER = "carrier_edge"
TIER_USER = "user_edge"
TIER_INPUT = "input"

KIND_CPU = "cpu"
KIND_GPU = "gpu"
KIND_FPGA = "fpga"


@dataclasses.dataclass(frozen=True)
class Site:
    """A physical location hosting device nodes."""

    site_id: str
    tier: str
    parent: Optional[str]  # site_id one tier up (tree topology); None for cloud


@dataclasses.dataclass(frozen=True)
class DeviceNode:
    """One server (paper: device #i with capacity ``C^d_i`` and price ``a_i``).

    ``capacity`` is in device-native units (GPU: GB RAM, FPGA: fraction of
    fabric = 1.0, CPU: core-seconds-per-second = cores).  ``monthly_price``
    is the price ``a_i`` of using the *whole* server for a month; an app
    using ``B^d_k`` units pays ``a_i * B^d_k / C^d_i`` (eq. 3).
    """

    node_id: str
    site_id: str
    kind: str
    capacity: float
    monthly_price: float


@dataclasses.dataclass(frozen=True)
class Link:
    """A network link (paper: link #j, bandwidth ``C^l_j``, price ``b_j``)."""

    link_id: str
    site_a: str  # lower-tier side
    site_b: str  # higher-tier side
    bandwidth_mbps: float
    monthly_price: float


class Topology:
    """Tree topology of sites, device nodes and links with path queries."""

    def __init__(
        self,
        sites: Sequence[Site],
        nodes: Sequence[DeviceNode],
        links: Sequence[Link],
    ) -> None:
        self.sites: Dict[str, Site] = {s.site_id: s for s in sites}
        self.nodes: Dict[str, DeviceNode] = {n.node_id: n for n in nodes}
        self.links: Dict[str, Link] = {l.link_id: l for l in links}
        if len(self.sites) != len(sites):
            raise ValueError("duplicate site ids")
        if len(self.nodes) != len(nodes):
            raise ValueError("duplicate node ids")
        if len(self.links) != len(links):
            raise ValueError("duplicate link ids")
        self._nodes_by_site: Dict[str, List[DeviceNode]] = {}
        for n in nodes:
            if n.site_id not in self.sites:
                raise ValueError(f"node {n.node_id}: unknown site {n.site_id}")
            self._nodes_by_site.setdefault(n.site_id, []).append(n)
        self._uplink: Dict[str, Link] = {}
        for l in links:
            if l.site_a not in self.sites or l.site_b not in self.sites:
                raise ValueError(f"link {l.link_id}: unknown endpoint")
            if l.site_a in self._uplink:
                raise ValueError(f"site {l.site_a} has two uplinks (tree required)")
            self._uplink[l.site_a] = l

    # ------------------------------------------------------------------ tree
    def ancestors(self, site_id: str) -> List[str]:
        """Site ids from ``site_id`` (inclusive) to the tree root."""
        out = [site_id]
        cur = self.sites[site_id]
        while cur.parent is not None:
            out.append(cur.parent)
            cur = self.sites[cur.parent]
        return out

    def uplink_path(self, from_site: str, to_site: str) -> Tuple[Link, ...]:
        """Links on the unique tree path from ``from_site`` up to ``to_site``.

        Only *priced* links count: the paper does not price/capacity the
        input-node attachment, which is modelled by input sites having no
        uplink ``Link`` object (their parent hop is free and unconstrained).
        """
        chain = self.ancestors(from_site)
        if to_site not in chain:
            raise ValueError(
                f"{to_site} is not an ancestor of {from_site}; "
                "tree topology supports uplink placement only"
            )
        path: List[Link] = []
        for sid in chain:
            if sid == to_site:
                break
            link = self._uplink.get(sid)
            if link is not None:  # input→user-edge hop has no Link: free
                path.append(link)
        return tuple(path)

    def uplink_of(self, site_id: str) -> Optional[Link]:
        """The site's priced uplink ``Link``, or None — input sites have no
        uplink object (their attachment hop is free and unconstrained)."""
        return self._uplink.get(site_id)

    def path_between(self, site_a: str, site_b: str) -> Tuple[Link, ...]:
        """Links on the unique tree path between two sites (via their LCA).
        Used by fleet topologies where placement is not ancestor-restricted."""
        anc_a = self.ancestors(site_a)
        anc_b = self.ancestors(site_b)
        common = next(s for s in anc_a if s in set(anc_b))
        return self.uplink_path(site_a, common) + self.uplink_path(site_b, common)

    def nodes_at(self, site_id: str, kind: Optional[str] = None) -> List[DeviceNode]:
        out = self._nodes_by_site.get(site_id, [])
        if kind is None:
            return list(out)
        return [n for n in out if n.kind == kind]

    def compute_sites_above(self, input_site: str) -> List[str]:
        """Candidate hosting sites for an app whose data源 is ``input_site``."""
        return [s for s in self.ancestors(input_site) if self.sites[s].tier != TIER_INPUT]

    def all_compute_nodes(self) -> List[DeviceNode]:
        return [n for n in self.nodes.values() if self.sites[n.site_id].tier != TIER_INPUT]


# --------------------------------------------------------------------------
# Paper §4.1.2 topology builder — prices calibrated so the worked example
# reproduces exactly (NAS.FT carrier→cloud: 6.6→7.4 s, ¥8412.5→¥7010).
# --------------------------------------------------------------------------

#: Cloud monthly price of a *full* server, by device kind (¥).  The paper
#: gives 5万/10万/12万 for CPU / GPU(16 GB) / FPGA at cloud; GPU price scales
#: with RAM (8 GB = ¥50k, 4 GB = ¥25k) — this is what makes the paper's
#: ¥8412.5 carrier-edge figure come out (see DESIGN.md §2.1).
CLOUD_FULL_PRICE = {KIND_CPU: 50_000.0, KIND_GPU: 100_000.0, KIND_FPGA: 120_000.0}
#: Tier price multipliers (paper: carrier ×1.25, user edge ×1.5 — 集約効果).
TIER_MULT = {TIER_CLOUD: 1.0, TIER_CARRIER: 1.25, TIER_USER: 1.5}
#: GPU RAM capacity (GB) per tier.
GPU_RAM = {TIER_CLOUD: 16.0, TIER_CARRIER: 8.0, TIER_USER: 4.0}
#: Server counts per site per tier: (CPU, GPU, FPGA).
SERVERS = {TIER_CLOUD: (8, 4, 2), TIER_CARRIER: (4, 2, 1), TIER_USER: (2, 1, 0)}

CPU_CORES = 8.0  # capacity units of one CPU server (cores); paper leaves
#                  CPU capacity unspecified — only used by non-paper configs.


def gpu_price(tier: str) -> float:
    """Monthly price of a full GPU server at ``tier`` (RAM-proportional)."""
    return CLOUD_FULL_PRICE[KIND_GPU] * (GPU_RAM[tier] / GPU_RAM[TIER_CLOUD]) * TIER_MULT[tier]


def build_paper_topology(
    n_cloud: int = 5,
    n_carrier: int = 20,
    n_user: int = 60,
    n_input: int = 300,
    scale: int = 1,
) -> Topology:
    """The evaluation topology of paper §4.1.2 (defaults = paper values).

    ``scale`` multiplies every tier count uniformly (the ROADMAP's
    ×2/×4/×8 solver-scaling sweep): the tree keeps the paper's fan-out and
    link pricing, it just has ``scale×`` more cloud subtrees.
    """
    if scale < 1:
        raise ValueError("scale must be >= 1")
    if scale != 1:
        n_cloud, n_carrier, n_user, n_input = (
            n_cloud * scale, n_carrier * scale, n_user * scale, n_input * scale,
        )
    if n_carrier % n_cloud or n_user % n_carrier or n_input % n_user:
        raise ValueError("tier sizes must nest evenly for round-robin wiring")
    sites: List[Site] = []
    nodes: List[DeviceNode] = []
    links: List[Link] = []

    for c in range(n_cloud):
        sites.append(Site(f"cloud{c}", TIER_CLOUD, None))
    per_cloud = n_carrier // n_cloud
    for e in range(n_carrier):
        parent = f"cloud{e // per_cloud}"
        sites.append(Site(f"carrier{e}", TIER_CARRIER, parent))
        links.append(
            Link(f"link_carrier{e}_{parent}", f"carrier{e}", parent, 100.0, 8_000.0)
        )
    per_carrier = n_user // n_carrier
    for u in range(n_user):
        parent = f"carrier{u // per_carrier}"
        sites.append(Site(f"user{u}", TIER_USER, parent))
        links.append(
            Link(f"link_user{u}_{parent}", f"user{u}", parent, 10.0, 3_000.0)
        )
    per_user = n_input // n_user
    for i in range(n_input):
        sites.append(Site(f"input{i}", TIER_INPUT, f"user{i // per_user}"))
        # No Link object: the input attachment is free & unconstrained (§4).

    for site in list(sites):
        if site.tier == TIER_INPUT:
            continue
        n_cpu, n_gpu, n_fpga = SERVERS[site.tier]
        mult = TIER_MULT[site.tier]
        for k in range(n_cpu):
            nodes.append(
                DeviceNode(
                    f"{site.site_id}_cpu{k}", site.site_id, KIND_CPU,
                    CPU_CORES, CLOUD_FULL_PRICE[KIND_CPU] * mult,
                )
            )
        for k in range(n_gpu):
            nodes.append(
                DeviceNode(
                    f"{site.site_id}_gpu{k}", site.site_id, KIND_GPU,
                    GPU_RAM[site.tier], gpu_price(site.tier),
                )
            )
        for k in range(n_fpga):
            nodes.append(
                DeviceNode(
                    f"{site.site_id}_fpga{k}", site.site_id, KIND_FPGA,
                    1.0, CLOUD_FULL_PRICE[KIND_FPGA] * mult,
                )
            )
    return Topology(sites, nodes, links)
