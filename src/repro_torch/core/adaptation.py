"""The environment-adaptation flow (paper §2.2, Steps 1–7) as a controller;
the port of `repro.core.adaptation`, on the H100.

Paper step → the port's action:

  Step 1  コード分析            → inspect the model config (families, layer
                                  pattern, params) — `analyze`
  Step 2  オフロード可能部抽出   → identify the hand-written kernels' hot
                                  spots & parallelizable dims —
                                  `extract_offloadable`
  Step 3  適切なオフロード部探索 → GA over execution plans, fitness from the
                                  roofline estimator — `search`
  Step 4  リソース量調整         → cards needed for memory + SLO —
                                  `size_resources`
  Step 5  配置場所調整           → LP admission onto the fleet — `place`
  Step 6  実行ファイル配置と検証  → the port's step traced on meta on the
                                  production mesh (`verify`), and run for
                                  real on the card (`verify_on_card`)
  Step 7  運用中再構成           → periodic fleet reconfiguration —
                                  `operate`

Steps 5 and 7 need the fleet scheduler and the LP core (`core/cluster.py`,
placement, reconfig, topology, apps, lp, solver, simplex, satisfaction,
migration), which the port takes with ROADMAP Queue 1 item 17; until then
a controller given a scheduler, and `place`, raise `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..launch.analytic import estimate
from ..launch.plans import CellPlan, plan_for
from ..launch.roofline import H100_SXM, Hardware
from ..models import ModelConfig, ShapeConfig
from ..models.config import BLOCK_ATTN, BLOCK_MAMBA2, BLOCK_MLSTM, BLOCK_MOE
from .shard_search import PlanSearchResult, search_plan

_ITEM_17 = "the fleet scheduler and the LP core come with ROADMAP Queue 1 item 17"


@dataclasses.dataclass
class Analysis:
    families: List[str]
    n_params: int
    kernel_hotspots: List[str]
    parallel_dims: Dict[str, int]


class AdaptationController:
    def __init__(self, scheduler=None, mesh_shape: Tuple[int, ...] = (32, 8),
                 hw: Hardware = H100_SXM):
        if scheduler is not None:
            raise NotImplementedError(f"AdaptationController(scheduler=...): {_ITEM_17}")
        self.scheduler = None
        self.mesh_shape = mesh_shape
        self.hw = hw
        self.hbm_bytes = hw.hbm_bytes

    # Step 1 -----------------------------------------------------------
    def analyze(self, cfg: ModelConfig) -> Analysis:
        kinds = set(cfg.layer_pattern())
        hotspots = []
        if kinds & {BLOCK_ATTN, BLOCK_MOE} or cfg.shared_attn_every:
            hotspots += ["flash_attention", "decode_attention", "rmsnorm"]
        if BLOCK_MAMBA2 in kinds:
            hotspots += ["ssm_scan"]
        if BLOCK_MLSTM in kinds:
            hotspots += ["mlstm_chunked"]
        dims = {"batch": 1, "heads": cfg.n_heads, "mlp": cfg.d_ff,
                "vocab": cfg.vocab_size, "experts": cfg.n_experts,
                "layers": cfg.n_layers}
        return Analysis(sorted(kinds), cfg.param_count(), hotspots,
                        {k: v for k, v in dims.items() if v})

    # Step 2 -----------------------------------------------------------
    def extract_offloadable(self, analysis: Analysis) -> List[str]:
        return analysis.kernel_hotspots

    # Step 3 -----------------------------------------------------------
    def search(self, cfg: ModelConfig, shape: ShapeConfig, **kw) -> PlanSearchResult:
        baseline = plan_for(cfg.name, shape)
        kw.setdefault("hbm_budget_bytes", self.hbm_bytes)
        return search_plan(cfg, shape, self.mesh_shape, baseline=baseline, hw=self.hw, **kw)

    # Step 4 -----------------------------------------------------------
    def size_resources(self, cfg: ModelConfig, shape: ShapeConfig,
                       plan: Optional[CellPlan] = None,
                       step_slo_s: Optional[float] = None) -> int:
        """Smallest power-of-two card count that fits the cards' memory and
        (optionally) meets the step-time SLO per the analytic roofline."""
        state_bytes = cfg.param_count() * (
            2.0 + (12.0 if cfg.optimizer == "adamw" and shape.is_train else 2.1))
        chips = 1
        while chips < 16_384:
            mesh = (max(chips // self.mesh_shape[-1], 1),
                    min(chips, self.mesh_shape[-1]))
            fits = state_bytes / chips <= 0.6 * self.hbm_bytes
            t = estimate(cfg, shape, mesh, plan, hw=self.hw).t_step
            if fits and (step_slo_s is None or t <= step_slo_s):
                return chips
            chips *= 2
        return chips

    # Step 5 -----------------------------------------------------------
    def place(self, job) -> Optional[str]:
        raise NotImplementedError(f"AdaptationController.place: {_ITEM_17}")

    # Step 6 -----------------------------------------------------------
    def verify(self, arch: str, shape_name: str, multi_pod: bool = False) -> Dict:
        """Trace the deployed step on the production mesh (the dry run is
        the verification environment off the card); returns the cell's row
        with its roofline terms."""
        from ..launch.dryrun import run_cell
        return run_cell(arch, shape_name, multi_pod, verbose=False, hw=self.hw)

    def verify_on_card(self, arch: str, shape_name: str, batch: int, seq_len: int,
                       **kw) -> Dict:
        """Run the deployed step for real on one card at a cut it holds
        (`launch.dryrun.verify_cell`); raises without a card."""
        from ..launch.dryrun import verify_cell
        return verify_cell(arch, shape_name, batch, seq_len, hw=self.hw, **kw)

    # Step 7 -----------------------------------------------------------
    def operate(self) -> List:
        """One reconfiguration window through the fleet scheduler; with no
        scheduler there is nothing to reconfigure, as in the reference."""
        return []

    # ------------------------------------------------------------------
    def run_all(self, cfg: ModelConfig, shape: ShapeConfig,
                job_id: int = 0, step_slo_factor: float = 1.5) -> Dict:
        """Steps 1-4 for one job; without a scheduler nothing is placed
        (``"pod": None``), as in the reference."""
        analysis = self.analyze(cfg)
        offload = self.extract_offloadable(analysis)
        search = self.search(cfg, shape)
        chips = self.size_resources(cfg, shape, search.best_plan)
        t = estimate(cfg, shape,
                     (max(chips // self.mesh_shape[-1], 1),
                      min(chips, self.mesh_shape[-1])), search.best_plan, hw=self.hw).t_step
        return {"analysis": analysis, "offload": offload, "search": search,
                "chips": chips, "t_step": t, "pod": None}


def _plan_row(plan: CellPlan) -> Dict:
    return {"n_microbatch": plan.n_microbatch, "loss_chunk": plan.loss_chunk,
            "strategy_overrides": plan.strategy_overrides,
            "config_overrides": plan.config_overrides}


def adapt(arch: str, shape_name: str, multi_pod: bool = False,
          hw: Hardware = H100_SXM) -> Dict:
    """Steps 1-4 and 6 for one cell on the production mesh: the analysis,
    the GA's plan, the cards it needs, and the dry run of the step under
    that plan (its roofline terms and bottleneck)."""
    import time

    from ..configs import get_config
    from ..launch.mesh import production_shape
    from ..launch.plans import PLAN_OVERRIDES
    from ..models import SHAPES_BY_NAME

    t0 = time.perf_counter()
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    ctl = AdaptationController(mesh_shape=production_shape(multi_pod)[0], hw=hw)
    analysis = ctl.analyze(cfg)
    offload = ctl.extract_offloadable(analysis)
    search = ctl.search(cfg, shape)
    chips = ctl.size_resources(cfg, shape, search.best_plan)
    t_plan = time.perf_counter() - t0
    before = PLAN_OVERRIDES.get((arch, shape_name))
    PLAN_OVERRIDES[(arch, shape_name)] = search.best_plan
    try:
        row = ctl.verify(arch, shape_name, multi_pod)
    finally:
        if before is None:
            PLAN_OVERRIDES.pop((arch, shape_name))
        else:
            PLAN_OVERRIDES[(arch, shape_name)] = before
    return {"arch": arch, "shape": shape_name, "mesh_shape": list(ctl.mesh_shape),
            "analysis": dataclasses.asdict(analysis), "offload": offload,
            "best_plan": _plan_row(search.best_plan),
            "baseline_t_step_s": search.baseline_t_step, "best_t_step_s": search.best_t_step,
            "speedup": search.speedup, "ga_evaluations": search.ga.evaluations,
            "chips": chips, "steps_1_to_4_s": t_plan,
            "seconds": time.perf_counter() - t0, "verify": row}


def main(argv=None) -> int:
    """``python -m repro_torch.core.adaptation --arch A --shape S [--mesh
    multi] [--out F]``: `adapt` for one cell, its JSON on the last line
    (and in ``F``)."""
    import argparse
    import json

    from ..configs import ARCH_IDS
    from ..models import SHAPES_BY_NAME

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES_BY_NAME))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = adapt(args.arch, args.shape, multi_pod=args.mesh == "multi")
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0 if out["verify"]["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
