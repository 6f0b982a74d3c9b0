"""Core: the paper's contribution — LP placement + in-operation reconfiguration;
the port of `repro.core` (the LP modules are the reference's numpy, with
only their import paths changed).

Layer map (paper flow Step → module):
  Step 3 (offload search, GA)      → `ga`, `shard_search`
  Step 4 (resource sizing)         → `cluster` (accelerator fleet), `shard_search`
  Step 5 (placement, eqs. 2–5)     → `topology`, `apps`, `lp`, `placement`
  Step 7 (reconfiguration, eq. 1)  → `reconfig`, `migration`, `satisfaction`
  Steps 1-7 as one controller      → `adaptation`
  solver substrate                 → `solver` (HiGHS / own B&B), `simplex`
  paper §4 evaluation              → `simulation`
"""

from .apps import (  # noqa: F401
    MRI_Q,
    NAS_FT,
    AppProfile,
    Candidate,
    PlacementRequest,
    Requirement,
    enumerate_candidates,
    price,
    response_time,
    sample_requests,
)
from .ga import GaConfig, GaResult, GeneticSearch  # noqa: F401
from .lp import AppVars, build_joint_milp, filter_candidates  # noqa: F401
from .migration import MigrationStep, Move, plan_and_apply  # noqa: F401
from .placement import PlacedApp, PlacementEngine  # noqa: F401
from .reconfig import ReconfigResult, Reconfigurator  # noqa: F401
from .satisfaction import AppSatisfaction, mean_moved_ratio, window_sum  # noqa: F401
from .simulation import ExperimentResult, run_paper_experiment, run_paper_sweep  # noqa: F401
from .solver import MilpProblem, MilpResult, solve_milp  # noqa: F401
from .topology import Topology, build_paper_topology  # noqa: F401
