"""Core: the paper's environment-adaptation flow on the port.

Layer map (paper flow Step → module):
  Step 3 (offload search, GA)      → `ga`, `shard_search`
  Steps 1-4 and 6                  → `adaptation` (Step 6 through
                                     `launch.dryrun`)
Steps 5 and 7 (LP placement and reconfiguration) and the fleet scheduler
come with ROADMAP Queue 1 item 17.
"""

from .ga import GaConfig, GaResult, GeneticSearch  # noqa: F401
