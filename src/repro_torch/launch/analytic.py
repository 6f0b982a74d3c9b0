"""Closed-form roofline estimator for (cfg × shape × mesh × plan); the port
of `repro.launch.analytic`.

Used as the fast fitness oracle of the GA plan search
(`core.shard_search`) and for job profiles where no traced row is at hand.
The constants are coarse (elementwise-traffic factor, remat recompute
factor); `calibrate()` fits per-term scale factors against the dry run's
or the verification run's rows, so that the estimator ranks plans as the
traced analysis does: the GA needs *ordering*, not absolute seconds.  The
formulas are the reference's; ``hw`` supplies the card's constants, and
the wire bytes go to their mesh axes (the tensor-parallel psums and the
experts' all-to-all over "model", the gradient reduction and FSDP gather
over the data axes), each at its bandwidth (`roofline.t_collective`).
Given the reference's constants as a `Hardware`, `estimate` returns the
reference's numbers bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np

from ..models import ModelConfig, ShapeConfig
from ..models.config import BLOCK_ATTN, BLOCK_MOE
from .plans import CellPlan
from .roofline import H100_SXM, Hardware, t_collective


@dataclasses.dataclass
class AnalyticTerms:
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def t_step(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)


#: Per-term scale factors; installed by `calibrate()`.
SCALE = {"compute": 1.0, "memory": 1.0, "collective": 1.0}


def estimate(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh_shape: Tuple[int, ...],
    plan: Optional[CellPlan] = None,
    scale: Optional[Dict[str, float]] = None,
    hw: Hardware = H100_SXM,
) -> AnalyticTerms:
    scale = scale or SCALE
    plan = plan or CellPlan()
    chips = int(np.prod(mesh_shape))
    n_model = mesh_shape[-1]
    n_data = chips // n_model
    B, S = shape.global_batch, shape.seq_len
    T = B * S if shape.kind != "decode" else B
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers

    n_params = cfg.param_count()
    n_embed = V * d * (1 if cfg.tie_embeddings else 2)
    n_mm = max(n_params - n_embed, 1)
    if cfg.n_experts:
        mult = 3 if cfg.ffn_type == "swiglu" else 2
        n_moe = sum(1 for k in cfg.layer_pattern() if k == BLOCK_MOE)
        n_mm -= n_moe * (cfg.n_experts - cfg.top_k * plan_cap_factor(cfg, plan)) \
            * mult * d * cfg.d_ff

    n_attn = sum(1 for k in cfg.layer_pattern() if k in (BLOCK_ATTN, BLOCK_MOE))
    if cfg.shared_attn_every:
        n_attn += L // cfg.shared_attn_every

    # ---- FLOPs (per device) ----
    train = shape.kind == "train"
    pass_factor = 8.0 if (train and cfg.remat == "block") else (6.0 if train else 2.0)
    f_mm = pass_factor / 2.0 * 2.0 * n_mm * T          # matmul params
    f_head = (6.0 if train else 2.0) * T * d * V
    if shape.kind == "decode":
        f_attn = 4.0 * B * S * cfg.n_heads * cfg.d_head * n_attn
    else:
        # chunked attention computes the full square then masks (×2 vs causal)
        f_attn = (4.5 if train else 1.0) * 4.0 * B * S * S * cfg.n_heads \
            * cfg.d_head * n_attn / 2.0 * 2.0
    flops_dev = (f_mm + f_head + f_attn) / chips

    # ---- bytes (per device) ----
    pbytes = 2.0 * n_params / chips                    # bf16 params, fully sharded
    opt_reads = 3.0 if train else 1.0
    act_elems = T * d * L / chips
    k_act = 24.0 if train else 6.0                     # elementwise-chain factor (f32)
    bytes_dev = opt_reads * pbytes * (3 if train else 1) + 4.0 * k_act * act_elems
    if shape.kind == "decode":
        cache = 2.0 * B * S * cfg.n_kv_heads * cfg.d_head * n_attn * 2.0 / chips
        bytes_dev += cache

    # ---- collective wire bytes (per device), by mesh axis ----
    wire = []
    if n_model > 1:
        fac = 2.0 * (n_model - 1) / n_model
        psums = 2.0 * n_attn * (3.0 if train else 1.0)  # wo + down, fwd/bwd/remat
        wire.append(("model", psums * 4.0 * (T / n_data) * d * fac / plan.n_microbatch
                     * plan.n_microbatch))  # per-microbatch psums sum back to full T
    if train and n_data > 1:
        wire.append(("data", 2.0 * 2.0 * n_params / chips))  # grad reduce + fsdp gather
    if cfg.n_experts and n_model > 1:
        wire.append(("model", 2.0 * (T / chips) * cfg.top_k * d * 2.0
                     * (3.0 if train else 1.0)))
    return AnalyticTerms(
        t_compute=scale["compute"] * flops_dev / hw.peak_flops_bf16,
        t_memory=scale["memory"] * bytes_dev / hw.hbm_bw,
        t_collective=t_collective(wire, hw, scale["collective"]),
    )


def plan_cap_factor(cfg: ModelConfig, plan: CellPlan) -> float:
    return cfg.capacity_factor


def calibrate(results_path: str, mesh_shape: Tuple[int, ...] = (32, 8),
              hw: Hardware = H100_SXM) -> Dict[str, float]:
    """Fit per-term scale factors (median traced/analytic ratio over the
    rows with status "ok") and install them in `SCALE`.  The rows are the
    dry run's (`dryrun.run_cell`) or the verification run's
    (`dryrun.verify_cell`): each names its arch and shape and carries its
    depth, batch, sequence and mesh where they are not the cell's own."""
    from ..configs import get_config
    from ..models import SHAPES_BY_NAME
    from .dryrun import cut_depth
    from .plans import plan_for

    with open(results_path) as f:
        rows = json.load(f)
    ratios = {"compute": [], "memory": [], "collective": []}
    for r in rows:
        if r.get("status") != "ok":
            continue
        cut = r.get("cut") or {}
        cfg = get_config(r["arch"])
        if cut.get("n_layers"):
            cfg = cut_depth(cfg, cut["n_layers"])
        shape = SHAPES_BY_NAME[r["shape"]]
        if cut.get("batch") or cut.get("seq_len"):
            shape = dataclasses.replace(shape, global_batch=cut.get("batch") or
                                        shape.global_batch,
                                        seq_len=cut.get("seq_len") or shape.seq_len)
        mesh = tuple(r.get("mesh_shape") or mesh_shape)
        est = estimate(cfg, shape, mesh, plan_for(r["arch"], shape),
                       scale={"compute": 1, "memory": 1, "collective": 1}, hw=hw)
        rf = r["roofline"]
        for term, est_v, got_v in (
            ("compute", est.t_compute, rf["t_compute_s"]),
            ("memory", est.t_memory, rf["t_memory_s"]),
            ("collective", est.t_collective, rf["t_collective_s"]),
        ):
            if est_v > 1e-9 and got_v > 1e-9:
                ratios[term].append(got_v / est_v)
    for term, vals in ratios.items():
        if vals:
            SCALE[term] = float(np.median(vals))
    return dict(SCALE)
