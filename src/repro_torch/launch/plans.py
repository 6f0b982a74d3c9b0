"""Per-cell execution plans: microbatching, loss chunking and sharding
strategy for each (arch × shape).  This is the knob surface the hillclimb
(`launch.hillclimb`) and `core.shard_search`'s GA mutate: a plan is the
accelerator analogue of the paper's "offload pattern".  The port of
`repro.launch.plans`, with the same plans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from ..configs import get_config
from ..models import ModelConfig, ShapeConfig
from ..parallel.sharding import ShardingStrategy, default_strategy


@dataclasses.dataclass(frozen=True)
class CellPlan:
    n_microbatch: int = 1
    loss_chunk: int = 0
    strategy_overrides: Dict = dataclasses.field(default_factory=dict)
    config_overrides: Dict = dataclasses.field(default_factory=dict)
    notes: str = ""

    def apply_config(self, cfg: ModelConfig) -> ModelConfig:
        return dataclasses.replace(cfg, **self.config_overrides) \
            if self.config_overrides else cfg

    def strategy(self, mesh) -> ShardingStrategy:
        """`default_strategy(mesh)` with the plan's overrides."""
        return dataclasses.replace(default_strategy(mesh), **self.strategy_overrides)


def default_plan(cfg: ModelConfig, shape: ShapeConfig) -> CellPlan:
    if shape.kind != "train":
        return CellPlan(loss_chunk=0)
    params_b = cfg.param_count() / 1e9
    # Microbatches sized so the per-microbatch residual stream is ~1 row per
    # device at d_model ≥ 6k (the reference's saved-activation budget).
    if params_b > 500:
        n_micro = 16
    elif params_b > 50:
        n_micro = 8
    elif params_b > 5:
        n_micro = 4
    else:
        n_micro = 1
    loss_chunk = 512 if cfg.vocab_size >= 100_000 else 0
    return CellPlan(n_microbatch=n_micro, loss_chunk=loss_chunk)


#: Tuned overrides; key = (arch, shape_name).
PLAN_OVERRIDES: Dict[Tuple[str, str], CellPlan] = {}

#: The reference's tuned plans, kept for parity: they were chosen on its
#: TPU mesh and are not tuned for the H100.  Activated by
#: `use_optimized_plans()` (or ``dryrun --optimized``).
OPTIMIZED_PLANS: Dict[Tuple[str, str], CellPlan] = {
    ("kimi-k2-1t-a32b", "train_4k"): CellPlan(
        n_microbatch=4, loss_chunk=512,
        strategy_overrides={"moe": "ep_shardmap"},
        notes="expert-parallel dispatch + mb=4 (the reference's tuned plan)"),
    ("dbrx-132b", "train_4k"): CellPlan(
        n_microbatch=4, loss_chunk=512,
        strategy_overrides={"moe": "ep_shardmap"},
        notes="expert-parallel dispatch (the reference's tuned plan)"),
    ("kimi-k2-1t-a32b", "prefill_32k"): CellPlan(
        strategy_overrides={"moe": "ep_shardmap"},
        notes="expert-parallel dispatch for prefill (the reference's tuned plan)"),
    ("dbrx-132b", "prefill_32k"): CellPlan(
        strategy_overrides={"moe": "ep_shardmap"},
        notes="expert-parallel dispatch for prefill (the reference's tuned plan)"),
    ("qwen2-vl-2b", "train_4k"): CellPlan(
        n_microbatch=1, loss_chunk=512,
        strategy_overrides={"dp": ("data", "model"), "tp": None,
                            "fsdp": "model", "seq": None},
        notes="pure data parallelism over every rank, ZeRO over model "
              "(the reference's tuned plan: kv=2 heads leave little to split)"),
    ("qwen1.5-110b", "train_4k"): CellPlan(
        n_microbatch=8, loss_chunk=512,
        notes="the baseline plan (the reference's tuned plan)"),
}


def use_optimized_plans() -> None:
    PLAN_OVERRIDES.update(OPTIMIZED_PLANS)


def plan_for(arch: str, shape: ShapeConfig) -> CellPlan:
    if (arch, shape.name) in PLAN_OVERRIDES:
        return PLAN_OVERRIDES[(arch, shape.name)]
    return default_plan(get_config(arch), shape)
