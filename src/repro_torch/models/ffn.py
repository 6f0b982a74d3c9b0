"""Dense feed-forward variants: SwiGLU (Qwen/Granite/DBRX/Kimi), GELU
(Seamless), squared-ReLU (Nemotron-4).

Under a sharding context whose tensor-parallel axis (n ranks) divides
``d_ff``, each rank computes its ``d_ff / n`` hidden columns: ``w_gate``
and ``w_up`` column-parallel, ``w_down`` row-parallel, its partial output
summed over the axis (`parallel.context.reduce_from_tp`), as the
reference's rule table cuts them."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..parallel.context import copy_to_tp, reduce_from_tp, tp_part, tp_rank, tp_size
from .config import ModelConfig
from .layers import apply_linear, dtype_of, init_linear


def relu2(x):
    """Squared ReLU (Nemotron-4 / Primer)."""
    r = F.relu(x)
    return r * r


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # the reference's jax.nn.gelu default


ACTIVATIONS = {"gelu": _gelu, "relu2": relu2, "silu": F.silu}


def init_ffn(generator, cfg: ModelConfig, dtype, d_ff: int = 0, device=None) -> Dict:
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    lin = lambda d_in, d_out, **kw: init_linear(
        generator, d_in, d_out, dtype, bias=cfg.ffn_bias, device=device, **kw)
    p = {}
    if cfg.ffn_type == "swiglu":
        p["w_gate"] = lin(d, d_ff)
    p["w_up"] = lin(d, d_ff)
    p["w_down"] = lin(d_ff, d, scale=d_ff ** -0.5)
    return p


def ffn(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    n = tp_size()
    if n > 1 and cfg.d_ff % n == 0:
        return _ffn_split(params, x, cfg, n)
    if cfg.ffn_type == "swiglu":
        gate = F.silu(apply_linear(params["w_gate"], x, cd))
        up = apply_linear(params["w_up"], x, cd)
        return apply_linear(params["w_down"], gate * up, cd)
    act = ACTIVATIONS["gelu" if cfg.ffn_type == "gelu" else "relu2"]
    h = act(apply_linear(params["w_up"], x, cd))
    return apply_linear(params["w_down"], h, cd)


def _ffn_split(params: Dict, x: torch.Tensor, cfg: ModelConfig, n: int) -> torch.Tensor:
    """`ffn` on this rank's ``d_ff / n`` hidden columns, summed over the
    tensor-parallel axis."""
    cd = dtype_of(cfg.compute_dtype)
    f = cfg.d_ff // n
    lo, hi = tp_rank() * f, (tp_rank() + 1) * f
    x = copy_to_tp(x)
    cols = lambda name: {k: tp_part(v, -1, cfg.d_ff, lo, hi) for k, v in params[name].items()}
    if cfg.ffn_type == "swiglu":
        h = F.silu(apply_linear(cols("w_gate"), x, cd)) * apply_linear(cols("w_up"), x, cd)
    else:
        h = ACTIVATIONS["gelu" if cfg.ffn_type == "gelu" else "relu2"](
            apply_linear(cols("w_up"), x, cd))
    down = params["w_down"]
    y = reduce_from_tp(torch.matmul(h, tp_part(down["w"], 0, cfg.d_ff, lo, hi).to(cd)))
    return y + down["b"].to(cd) if "b" in down else y
