"""Scalable planning subsystem: decomposed + rolling-horizon reconfiguration.

The paper's joint MILP re-optimizes the whole fleet at once; this package
makes the planning step tractable at topology scale ×2/×4/×8 without
giving up the satisfaction objective:

  partition       — cut the site tree into per-subtree (or k-way) regions
                    with boundary-link budgets
  decomposed      — one small MILP per region + a greedy coordination pass
                    arbitrating cross-boundary moves, merged into one
                    conflict-free `ReconfigResult`; its *incremental* mode
                    (policy ``incremental``) consumes the engine's change
                    journal to re-solve only dirty regions, replaying
                    cached plans for clean ones and warm-starting the rest;
                    its *hierarchical* mode (policy ``hierarchical``) plans
                    over a region-of-regions `PartitionTree` — per-level
                    arbitration sweeps and wholesale skips of journal-clean
                    closed subtrees — activating only on fleets above
                    ``hierarchy_min_nodes`` devices
  forecast        — sample each app's `RateCurve` ahead of the clock
                    (peak/mean over a rolling horizon) + forecast-error
                    scoring
  horizon         — rolling-horizon policy wrapper planning against the
                    forecast instead of the instantaneous snapshot
  migration_cost  — price each candidate move's transfer time (executor
                    ledger contention included) into the move penalty;
                    sizes come from the elastic backend for apps that
                    declare state, and — with ``RuntimeConfig.
                    cost_feedback`` — from calibration-ledger measurements

Importing this package registers the ``decomposed``, ``incremental`` and
``horizon`` policies in `fleet.policies.POLICIES`; `repro_torch.fleet` imports
it eagerly.
"""

from ..policies import POLICIES
from .decomposed import (  # noqa: F401
    DecomposedPolicy,
    HierarchicalPolicy,
    IncrementalPolicy,
)
from .forecast import DemandForecaster, Forecast  # noqa: F401
from .horizon import HorizonPolicy  # noqa: F401
from .migration_cost import MigrationCostModel  # noqa: F401
from .partition import (  # noqa: F401
    Partition,
    PartitionTree,
    Region,
    partition_topology,
    partition_tree,
)

POLICIES.setdefault(DecomposedPolicy.name, DecomposedPolicy)
POLICIES.setdefault(IncrementalPolicy.name, IncrementalPolicy)
POLICIES.setdefault(HierarchicalPolicy.name, HierarchicalPolicy)
POLICIES.setdefault(HorizonPolicy.name, HorizonPolicy)
