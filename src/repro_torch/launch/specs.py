"""Per-cell input specifications: tensors on the ``meta`` device (shape and
type, no memory) for every (architecture × input shape) combination; the
port of `repro.launch.specs`, whose ``ShapeDtypeStruct`` trees these
match leaf for leaf.

Cell semantics (as the reference's):
  * train_*:    one optimizer step on (inputs, targets) of (B, S).
  * prefill_*:  build a KV/SSM cache from a (B, S) prompt batch.
  * decode_*:   ONE new token against a cache holding S valid entries.
  * seamless:   encoder frames = S stub embeddings; decoder length = S.
  * qwen2-vl:   256 stub patch embeddings + (S−256) text tokens; 3D M-RoPE
    position ids are part of the input (the frontend computes them).

Skip rules (the reference's): long_500k only for SSM/hybrid archs; no
encoder-only archs are assigned, so decode shapes run everywhere else.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import get_config
from ..models import SHAPES_BY_NAME, ModelConfig, ShapeConfig
from ..models.layers import dtype_of
from ..models.transformer import init_cache

I32 = torch.int32
_SUBQUADRATIC = {"ssm", "hybrid"}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in _SUBQUADRATIC:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is a full-attention arch (skip per assignment)")
    return True, ""


def meta(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the meta device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    cd = dtype_of(cfg.compute_dtype)
    if cfg.family == "vlm":
        P = cfg.vision_stub_patches
        return {
            "inputs": meta((B, S - P), I32),
            "targets": meta((B, S - P), I32),
            "vision_embeds": meta((B, P, cfg.d_model), cd),
            "positions": meta((3, B, S), I32),
        }
    batch = {"inputs": meta((B, S), I32), "targets": meta((B, S), I32)}
    if cfg.n_encoder_layers:
        batch["encoder_embeds"] = meta((B, S, cfg.d_model), cd)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    cd = dtype_of(cfg.compute_dtype)
    if cfg.family == "vlm":
        P = cfg.vision_stub_patches
        return {
            "tokens": meta((B, S - P), I32),
            "vision_embeds": meta((B, P, cfg.d_model), cd),
            "positions": meta((3, B, S), I32),
        }
    batch = {"tokens": meta((B, S), I32)}
    if cfg.n_encoder_layers:
        batch["encoder_embeds"] = meta((B, S, cfg.d_model), cd)
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Any, Any]:
    """(cache, token specs) for one decode step with a cache of seq_len
    valid entries; the cache is the port's `init_cache` on the meta
    device."""
    B, S = shape.global_batch, shape.seq_len
    cross = S if cfg.n_encoder_layers else 0
    cache = init_cache(cfg, B, S, cross_len=cross, device="meta")
    return cache, meta((B, 1), I32)


def cell_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The model inputs of one cell of ``cfg`` and ``shape`` (any batch and
    length): ``batch``, or ``cache`` and ``tokens`` for a decode step."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    cache, tokens = decode_specs(cfg, shape)
    return {"cache": cache, "tokens": tokens}


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Everything the dry run needs to trace this cell (model inputs only;
    the state is built by the step assemblers in `dryrun`)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = cell_supported(cfg, shape)
    out: Dict[str, Any] = {"cfg": cfg, "shape": shape, "supported": ok, "skip_reason": why}
    if ok:
        out.update(cell_specs(cfg, shape))
    return out
