"""Topology partitioner: cut the site tree into planning regions.

The monolithic reconfiguration MILP couples every window app through the
shared capacity rows, which stops scaling exactly when the topology does.
The companion placement papers frame placement per-site with cloud/edge
tiers — the natural decomposition seam: with a tree topology, capacity
constraints only couple apps whose candidate paths share a subtree, so
cutting the site tree into subtree **regions** block-diagonalizes the
problem (exactly, on the paper topology, where an app's whole uplink chain
lives inside one cloud subtree).

Rules:

* one region per root subtree (per-cloud on the paper topology);
* a root site with **no device nodes of its own** (a pure fabric root,
  e.g. the TPU-fleet star hub) is split automatically — each child subtree
  becomes a region and the hub gets a singleton region;
* ``max_region_nodes`` recursively splits any oversized subtree at its
  root's children (the subtree root becomes a singleton region);
* ``k_regions`` merges the smallest regions until at most ``k`` remain
  (k-way partitioning for topologies with many tiny subtrees).

Every device node lands in exactly one region (the partition invariant the
property tests assert).  A link is **interior** to a region when both of
its endpoints map there, otherwise it is a **boundary** link of both — the
decomposed planner gives regional subproblems only a budgeted share of
boundary-link capacity and lets the coordination pass arbitrate the rest.

**Region-of-regions trees** (`PartitionTree`, built by `partition_tree`)
stack coarsenings of one leaf partition: level 0 is the finest cut, each
higher level merges whole lower-level regions, and the top level is the
single global region.  Every link gets a **merge level** — the lowest
level at which both endpoints fall into one region (`link_level`); a link
still split at level ``k`` is a *cross-level boundary link* there and
keeps its leaf-solve budget, while a region with no boundary links at its
level is **closed**: no path can leave it, so it provably contains every
candidate of every app homed inside — the property the hierarchical
planner's per-level arbitration and quiet-subtree replay both lean on.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class Region:
    """One planning region: a connected set of sites and its resources."""

    region_id: str                     # root site of the subtree (or merge head)
    sites: Tuple[str, ...]
    nodes: Tuple[str, ...]             # device node ids hosted in the region
    interior_links: FrozenSet[str]
    boundary_links: FrozenSet[str]


@dataclasses.dataclass
class Partition:
    """A full cut of the topology into regions, with lookup tables."""

    topo: Topology
    regions: List[Region]
    region_of_site: Dict[str, str]
    region_of_node: Dict[str, str]
    boundary_links: FrozenSet[str]     # union over regions

    def region(self, region_id: str) -> Region:
        return next(r for r in self.regions if r.region_id == region_id)

    def regions_of_link(self, link_id: str) -> Tuple[str, ...]:
        """Region(s) a link belongs to: one for an interior link, both
        endpoint regions for a boundary link — the regions an event on that
        link dirties (a boundary-link failure must invalidate BOTH adjacent
        regions' cached plans)."""
        link = self.topo.links[link_id]
        ra = self.region_of_site[link.site_a]
        rb = self.region_of_site[link.site_b]
        return (ra,) if ra == rb else (ra, rb)


def _subtree_sites(topo: Topology, root: str,
                   children: Dict[str, List[str]]) -> List[str]:
    out: List[str] = []
    queue = deque([root])
    while queue:
        sid = queue.popleft()
        out.append(sid)
        queue.extend(children.get(sid, []))
    return out


def partition_topology(
    topo: Topology,
    max_region_nodes: Optional[int] = None,
    k_regions: Optional[int] = None,
) -> Partition:
    """Cut ``topo``'s site tree into regions (see module docstring)."""
    children: Dict[str, List[str]] = {}
    for site in topo.sites.values():
        if site.parent is not None:
            children.setdefault(site.parent, []).append(site.site_id)
    for kids in children.values():
        kids.sort()
    # One O(nodes) pass; preserves `nodes_at` ordering without its
    # per-call list copies (the splitting loops call it per site).
    nodes_by_site: Dict[str, List] = {}
    for node in topo.nodes.values():
        nodes_by_site.setdefault(node.site_id, []).append(node)

    def n_nodes(sites: List[str]) -> int:
        return sum(len(nodes_by_site.get(s, ())) for s in sites)

    groups: List[Tuple[str, List[str]]] = []   # (region_id, sites)
    roots = sorted(s.site_id for s in topo.sites.values() if s.parent is None)
    queue = deque(roots)
    while queue:
        root = queue.popleft()
        sites = _subtree_sites(topo, root, children)
        kids = children.get(root, [])
        fabric_root = root in roots and not nodes_by_site.get(root) and kids
        oversized = (max_region_nodes is not None
                     and n_nodes(sites) > max_region_nodes and kids)
        if fabric_root or oversized:
            groups.append((root, [root]))      # the root becomes a singleton
            queue.extend(kids)                 # children split recursively
        else:
            groups.append((root, sites))

    if k_regions is not None and k_regions >= 1:
        while len(groups) > k_regions:
            # Merge the two smallest regions (ties broken by region id) so
            # k-way cuts stay balanced and deterministic.
            order = sorted(groups, key=lambda g: (n_nodes(g[1]), g[0]))
            (id_a, sites_a), (id_b, sites_b) = order[0], order[1]
            groups = [g for g in groups if g[0] not in (id_a, id_b)]
            groups.append((min(id_a, id_b), sorted(sites_a + sites_b)))
        groups.sort(key=lambda g: g[0])

    region_of_site: Dict[str, str] = {}
    for rid, sites in groups:
        for sid in sites:
            if sid in region_of_site:
                raise ValueError(f"site {sid} assigned to two regions")
            region_of_site[sid] = rid

    interior: Dict[str, set] = {rid: set() for rid, _ in groups}
    boundary: Dict[str, set] = {rid: set() for rid, _ in groups}
    for link in topo.links.values():
        ra = region_of_site[link.site_a]
        rb = region_of_site[link.site_b]
        if ra == rb:
            interior[ra].add(link.link_id)
        else:
            boundary[ra].add(link.link_id)
            boundary[rb].add(link.link_id)

    regions: List[Region] = []
    region_of_node: Dict[str, str] = {}
    for rid, sites in groups:
        nodes: List[str] = []
        for sid in sites:
            for node in nodes_by_site.get(sid, ()):
                nodes.append(node.node_id)
                region_of_node[node.node_id] = rid
        regions.append(Region(
            region_id=rid,
            sites=tuple(sites),
            nodes=tuple(nodes),
            interior_links=frozenset(interior[rid]),
            boundary_links=frozenset(boundary[rid]),
        ))
    all_boundary = frozenset().union(*(r.boundary_links for r in regions)) \
        if regions else frozenset()
    return Partition(topo, regions, region_of_site, region_of_node, all_boundary)


# ------------------------------------------------------- region-of-regions
@dataclasses.dataclass
class PartitionTree:
    """A stack of coarsenings of one leaf partition.

    ``levels[0]`` is the finest cut (the partition the regional MILPs are
    solved against), every higher level merges whole lower-level regions,
    and ``levels[-1]`` is a single global region.  ``parents[k]`` maps a
    region id at level ``k`` to its containing region at ``k+1``;
    ``ancestor_of[k]`` maps every *leaf* region id straight to its level-k
    ancestor.  ``link_level`` is each link's **merge level**: the lowest
    level at which both endpoints land in one region (0 for leaf-interior
    links; a leaf-boundary link "merges" wherever its two leaf regions
    first share an ancestor — below that level it stays a budgeted
    cross-level boundary link)."""

    topo: Topology
    levels: List[Partition]
    parents: List[Dict[str, str]]
    link_level: Dict[str, int]
    ancestor_of: List[Dict[str, str]]

    @property
    def leaf(self) -> Partition:
        return self.levels[0]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def ancestor(self, leaf_region_id: str, level: int) -> str:
        """Region at ``level`` containing the given leaf region."""
        return self.ancestor_of[level][leaf_region_id]

    def dirty_at(self, level: int, dirty_leaves: Iterable[str]) -> Set[str]:
        """Lift a dirty *leaf*-region set up the tree: a level-k region is
        dirty iff any dirty leaf maps into it — the journal drives
        dirtiness at every level through the same leaf mapping."""
        amap = self.ancestor_of[level]
        return {amap[rid] for rid in dirty_leaves if rid in amap}

    def leaves_under(self, level: int, region_id: str) -> List[str]:
        """Leaf region ids contained in one level-``level`` region, in
        leaf-partition order (deterministic: matches ``leaf.regions``)."""
        amap = self.ancestor_of[level]
        return [r.region_id for r in self.leaf.regions
                if amap[r.region_id] == region_id]


def _coarsen(lower: Partition, group_of: Dict[str, str]) -> Partition:
    """Merge whole ``lower`` regions into the groups named by ``group_of``
    (lower region id -> upper region id) and re-classify every link at the
    coarser cut."""
    topo = lower.topo
    region_of_site = {sid: group_of[rid]
                      for sid, rid in lower.region_of_site.items()}
    members: Dict[str, List[Region]] = {}
    for r in lower.regions:
        members.setdefault(group_of[r.region_id], []).append(r)
    interior: Dict[str, set] = {rid: set() for rid in members}
    boundary: Dict[str, set] = {rid: set() for rid in members}
    for link in topo.links.values():
        ra = region_of_site[link.site_a]
        rb = region_of_site[link.site_b]
        if ra == rb:
            interior[ra].add(link.link_id)
        else:
            boundary[ra].add(link.link_id)
            boundary[rb].add(link.link_id)
    regions: List[Region] = []
    region_of_node: Dict[str, str] = {}
    for rid in sorted(members):
        sites: List[str] = []
        nodes: List[str] = []
        for r in sorted(members[rid], key=lambda m: m.region_id):
            sites.extend(r.sites)
            nodes.extend(r.nodes)
        for nid in nodes:
            region_of_node[nid] = rid
        regions.append(Region(
            region_id=rid,
            sites=tuple(sites),
            nodes=tuple(nodes),
            interior_links=frozenset(interior[rid]),
            boundary_links=frozenset(boundary[rid]),
        ))
    all_boundary = frozenset().union(*(r.boundary_links for r in regions)) \
        if regions else frozenset()
    return Partition(topo, regions, region_of_site, region_of_node,
                     all_boundary)


def partition_tree(
    topo: Topology,
    max_region_nodes: Optional[int] = None,
    k_regions: Optional[int] = None,
    group_size: Optional[int] = None,
) -> PartitionTree:
    """Build a region-of-regions tree over ``topo``.

    * the **leaf** level is `partition_topology(topo, max_region_nodes,
      k_regions)` — exactly the single-level planner's cut;
    * when ``max_region_nodes`` split below the root subtrees, the default
      per-root partition is inserted as the next level (each split cloud
      re-merges there);
    * ``group_size`` keeps coarsening by merging sorted runs of at most
      ``group_size`` regions per parent until one level fits;
    * the top level is always the single global region.

    With default arguments this degenerates to ``[default partition,
    global]`` — the exact structure the single-level planner implicitly
    used, which is what keeps the tree-based planner bit-identical to it.
    """
    leaf = partition_topology(topo, max_region_nodes, k_regions)
    levels: List[Partition] = [leaf]
    parents: List[Dict[str, str]] = []
    # Re-merge split subtrees at their root region.  (Skipped under
    # k_regions: merged leaves can span roots, breaking containment.)
    if max_region_nodes is not None and k_regions is None:
        root_part = partition_topology(topo)
        if 1 < len(root_part.regions) < len(leaf.regions):
            group_of = {r.region_id: root_part.region_of_site[r.region_id]
                        for r in leaf.regions}
            levels.append(_coarsen(leaf, group_of))
            parents.append(group_of)
    if group_size is not None and group_size > 1:
        while len(levels[-1].regions) > group_size:
            cur = levels[-1]
            rids = sorted(r.region_id for r in cur.regions)
            group_of = {rid: rids[(i // group_size) * group_size]
                        for i, rid in enumerate(rids)}
            upper = _coarsen(cur, group_of)
            levels.append(upper)
            parents.append(group_of)
    if len(levels[-1].regions) > 1:
        cur = levels[-1]
        root_id = min(r.region_id for r in cur.regions)
        group_of = {r.region_id: root_id for r in cur.regions}
        levels.append(_coarsen(cur, group_of))
        parents.append(group_of)

    link_level: Dict[str, int] = {}
    for k, part in enumerate(levels):
        ros = part.region_of_site
        for link in topo.links.values():
            if link.link_id not in link_level \
                    and ros[link.site_a] == ros[link.site_b]:
                link_level[link.link_id] = k

    ancestor_of: List[Dict[str, str]] = [
        {r.region_id: r.region_id for r in leaf.regions}]
    for pmap in parents:
        prev = ancestor_of[-1]
        ancestor_of.append({rid: pmap[a] for rid, a in prev.items()})
    return PartitionTree(topo, levels, parents, link_level, ancestor_of)
