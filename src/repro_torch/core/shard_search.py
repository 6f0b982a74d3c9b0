"""GA search over execution plans: the paper's §3.1 re-targeted to the
accelerator; the port of `repro.core.shard_search`, wired to the port's
`launch.analytic`.

The paper's automatic offloading encodes "offload loop ℓ to GPU?" as genes
and evolves them against measured performance in a verification
environment.  Here: genes = execution-plan knobs (microbatch, loss
chunking, FSDP on/off, sequence sharding of the cache), fitness =
−roofline step time, measured either by

  * the **analytic** estimator (`launch.analytic`, calibrated against the
    traced table) — fast, used inside the GA loop, or
  * the **dry run** (`launch.dryrun.run_cell`, the port's own program
    traced on meta) — used to score the final champion, and on the card
    `launch.dryrun.verify_cell`.

This is Step 3 of the environment-adaptation flow (`core.adaptation`); the
winning plan lands in `launch.plans.PLAN_OVERRIDES` and becomes the cell's
deployed configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..launch.analytic import estimate
from ..launch.plans import CellPlan
from ..launch.roofline import H100_SXM, Hardware
from ..models import ModelConfig, ShapeConfig
from .ga import GaConfig, GaResult, GeneticSearch

# Gene space: one locus per knob.
MICROBATCH = (1, 2, 4, 8, 16, 32)
LOSS_CHUNK = (0, 256, 512, 1024, 2048)
FSDP = (None, "data")
SEQ = (None, "model")


@dataclasses.dataclass
class PlanSearchResult:
    best_plan: CellPlan
    best_t_step: float
    baseline_t_step: float
    ga: GaResult

    @property
    def speedup(self) -> float:
        return self.baseline_t_step / max(self.best_t_step, 1e-12)


def gene_to_plan(gene: Tuple[int, ...]) -> CellPlan:
    mb, lc, fsdp, seq = gene
    overrides: Dict = {"fsdp": FSDP[fsdp], "seq": SEQ[seq]}
    return CellPlan(n_microbatch=MICROBATCH[mb], loss_chunk=LOSS_CHUNK[lc],
                    strategy_overrides=overrides)


def plan_to_gene(plan: CellPlan) -> Tuple[int, ...]:
    mb = MICROBATCH.index(plan.n_microbatch) if plan.n_microbatch in MICROBATCH else 0
    lc = LOSS_CHUNK.index(plan.loss_chunk) if plan.loss_chunk in LOSS_CHUNK else 0
    fsdp = FSDP.index(plan.strategy_overrides.get("fsdp", "data"))
    seq = SEQ.index(plan.strategy_overrides.get("seq", "model"))
    return (mb, lc, fsdp, seq)


def search_plan(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh_shape: Tuple[int, ...] = (32, 8),
    baseline: Optional[CellPlan] = None,
    fitness: Optional[Callable[[CellPlan], float]] = None,
    ga_config: Optional[GaConfig] = None,
    hbm_budget_bytes: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    hw: Hardware = H100_SXM,
) -> PlanSearchResult:
    """Evolve an execution plan for one cell.  ``fitness`` returns step
    seconds (lower better); default = calibrated analytic roofline on
    ``hw`` with a memory-feasibility penalty (params + optimizer states
    must fit ``hbm_budget_bytes``, by default the card's memory)."""
    baseline = baseline or CellPlan()
    budget = hw.hbm_bytes if hbm_budget_bytes is None else hbm_budget_bytes
    if fitness is None:
        def fitness(plan: CellPlan) -> float:
            terms = estimate(cfg, shape, mesh_shape, plan, hw=hw)
            t = terms.t_step
            chips = int(np.prod(mesh_shape))
            # Infeasibility penalties: replicated params without FSDP.
            state_bytes = cfg.param_count() * (2.0 + (12.0 if cfg.optimizer == "adamw" else 2.1))
            if plan.strategy_overrides.get("fsdp") is None:
                per_dev = state_bytes / mesh_shape[-1]
            else:
                per_dev = state_bytes / chips
            if per_dev > budget:
                t *= 100.0
            if shape.kind == "train" and shape.global_batch % (
                    plan.n_microbatch * (chips // mesh_shape[-1])):
                t *= 100.0  # microbatch must divide per-replica batch
            return t

    ga = GeneticSearch(
        alphabet=[len(MICROBATCH), len(LOSS_CHUNK), len(FSDP), len(SEQ)],
        fitness=lambda g: -fitness(gene_to_plan(g)),
        config=ga_config or GaConfig(population=16, generations=12),
        rng=rng or np.random.default_rng(0),
    )
    res = ga.run(seed_genes=[plan_to_gene(baseline)])
    best_plan = gene_to_plan(res.best_gene)
    return PlanSearchResult(
        best_plan=best_plan,
        best_t_step=-res.best_fitness,
        baseline_t_step=fitness(baseline),
        ga=res,
    )
