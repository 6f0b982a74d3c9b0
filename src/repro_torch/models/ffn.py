"""Dense feed-forward variants: SwiGLU (Qwen/Granite/DBRX/Kimi), GELU
(Seamless), squared-ReLU (Nemotron-4)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

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
    if cfg.ffn_type == "swiglu":
        gate = F.silu(apply_linear(params["w_gate"], x, cd))
        up = apply_linear(params["w_up"], x, cd)
        return apply_linear(params["w_down"], gate * up, cd)
    act = ACTIVATIONS["gelu" if cfg.ffn_type == "gelu" else "relu2"]
    h = act(apply_linear(params["w_up"], x, cd))
    return apply_linear(params["w_down"], h, cd)
