"""End-to-end reproduction of the paper's evaluation (§4).

Protocol (§4.1.2): place 400 apps FCFS (NAS.FT : MRI-Q = 3 : 1, random input
nodes, requirement patterns 1/12 resp. 1/7 each); thereafter, every 100 new
placements run one reconfiguration over a window of the most recent
{100, 200, 400} apps.  The paper places 500 in total → one reconfiguration
event per run; ``n_batches`` generalizes this.

Reported (fig. 5): (a) how many window apps actually moved, (b) the mean
``R_a/R_b + P_a/P_b`` over moved apps (~1.96), plus solver wall time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .apps import sample_requests
from .placement import PlacementEngine
from .reconfig import ReconfigResult, Reconfigurator
from .topology import Topology, build_paper_topology


@dataclasses.dataclass
class ReconfigEventStats:
    window_size: int
    n_target: int
    n_moved: int
    mean_moved_ratio: float
    gain: float
    plan_time_s: float


@dataclasses.dataclass
class ExperimentResult:
    window_size: int
    n_placed: int
    n_rejected: int
    events: List[ReconfigEventStats]
    placement_time_s: float

    @property
    def moved_fraction(self) -> float:
        tot_t = sum(e.n_target for e in self.events)
        tot_m = sum(e.n_moved for e in self.events)
        return tot_m / tot_t if tot_t else 0.0

    @property
    def mean_moved_ratio(self) -> float:
        moved = [(e.n_moved, e.mean_moved_ratio) for e in self.events if e.n_moved]
        n = sum(m for m, _ in moved)
        if not n:
            return 2.0
        return sum(m * r for m, r in moved) / n


def run_paper_experiment(
    window_size: int,
    seed: int = 0,
    n_initial: int = 400,
    batch: int = 100,
    n_batches: int = 1,
    topo: Optional[Topology] = None,
    backend: str = "auto",
    move_penalty: float = 0.01,
) -> ExperimentResult:
    """One full run at a given reconfiguration window size."""
    import time

    rng = np.random.default_rng(seed)
    topo = topo or build_paper_topology()
    engine = PlacementEngine(topo)
    recon = Reconfigurator(engine, move_penalty=move_penalty, backend=backend)

    t0 = time.perf_counter()
    reqs = sample_requests(topo, n_initial, rng)
    for r in reqs:
        engine.place(r)
    events: List[ReconfigEventStats] = []
    next_id = n_initial
    for _ in range(n_batches):
        more = sample_requests(topo, batch, rng, start_id=next_id)
        next_id += batch
        for r in more:
            engine.place(r)
        window = engine.recent(min(window_size, len(engine.placement_order)))
        res: ReconfigResult = recon.run(window)
        events.append(
            ReconfigEventStats(
                window_size=window_size,
                n_target=len(res.window),
                n_moved=res.n_moved,
                mean_moved_ratio=res.mean_moved_ratio,
                gain=res.gain,
                plan_time_s=res.plan_time_s,
            )
        )
        assert engine.occupancy_invariants_ok()
    return ExperimentResult(
        window_size=window_size,
        n_placed=len(engine.placed),
        n_rejected=engine.rejected_total,
        events=events,
        placement_time_s=time.perf_counter() - t0,
    )


def run_paper_sweep(
    windows=(100, 200, 400),
    seeds=(0, 1, 2),
    backend: str = "auto",
) -> Dict[int, List[ExperimentResult]]:
    """Fig. 5 sweep: window sizes × seeds."""
    return {
        w: [run_paper_experiment(w, seed=s, backend=backend) for s in seeds]
        for w in windows
    }
