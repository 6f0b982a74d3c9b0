"""Base layers: norms, embeddings, RoPE / M-RoPE, linear init.

Plain functions on tensors; ``init_*`` builds nested dicts of tensors whose
leaf names equal the reference's (`repro.models.layers`), ``w`` stored
``(d_in, d_out)``.  Random draws take an explicit ``torch.Generator``.
The gelu and squared-ReLU activations live beside their one user, in
`ffn.py`.  `layer_norm` is on no model path, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .config import ModelConfig

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


class _Bf16CotangentBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def bf16_cotangent_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward casts the cotangent to bf16 -- placed on the
    residual stream it stops fp32 gradient chains (born in fp32 softmax/norm
    internals) from running through every matmul of the backward.  No-op
    for non-bf16 inputs (fp32 configs)."""
    return _Bf16CotangentBarrier.apply(x) if x.dtype == torch.bfloat16 else x


def _device_of(generator: Optional[torch.Generator], device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return generator.device if generator is not None else torch.device("cuda")


def _truncated_normal(generator, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverting the CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 1.0 - lo
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.mul_(hi - lo).add_(lo)
    x = torch.erfinv(u.mul_(2.0).sub_(1.0)).mul_(math.sqrt(2.0))
    return x.clamp_(-2.0, 2.0)


# ------------------------------------------------------------------ linear
def init_linear(generator, d_in: int, d_out: int, dtype, bias: bool = False,
                scale: Optional[float] = None, device=None):
    """Truncated-normal fan-in init (LeCun-ish), matching common LM practice."""
    device = _device_of(generator, device)
    if scale is None:
        scale = d_in ** -0.5
    w = (_truncated_normal(generator, (d_in, d_out), device) * scale).to(dtype)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_linear(p, x, compute_dtype):
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# -------------------------------------------------------------------- norm
def init_rmsnorm(d: int, dtype, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(x, scale, eps: float):
    """Plain RMSNorm: fp32 math, output in x's type.  The plain version of
    `repro_torch.kernels.rmsnorm.rms_norm`."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def init_layernorm(d: int, dtype, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layer_norm(x, scale, bias, eps: float):
    """LayerNorm in fp32 math (biased variance), output in x's type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def fused_rms_norm(x, scale, eps: float):
    """What the model calls: the hand-written kernel for a CUDA tensor, the
    plain `rms_norm` for a CPU tensor (see `repro_torch.kernels.ops`)."""
    from repro_torch.kernels import ops as kops
    return kops.rms_norm(x, scale, eps)


# --------------------------------------------------------------- embedding
def init_embedding(generator, vocab: int, d: int, dtype, device=None):
    device = _device_of(generator, device)
    e = torch.randn((vocab, d), generator=generator, device=device,
                    dtype=torch.float32) * d ** -0.5
    return {"embedding": e.to(dtype)}


def embed(p, tokens, compute_dtype):
    return p["embedding"][tokens].to(compute_dtype)


def unembed(p, x, logit_dtype):
    """Multiplies in the operands' common type, casts to ``logit_dtype``
    afterwards (as the reference's einsum does)."""
    e = p["embedding"]
    dt = torch.promote_types(x.dtype, e.dtype)
    return torch.matmul(x.to(dt), e.to(dt).t()).to(logit_dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Split-half
    rotation: element i pairs with element i + Dh/2."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (..., S, Dh/2)
    return _rotate(x, torch.cos(angles), torch.sin(angles))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x (..., S, H, Dh) by (..., S, Dh/2) tables."""
    cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mrope_angles(positions_thw: torch.Tensor, freqs: torch.Tensor, sections) -> torch.Tensor:
    """(3, ..., S) position ids -> (..., S, Dh/2) angles: the frequency slots
    fall into consecutive (temporal, height, width) sections, each rotated by
    its own axis's id.  Sliced with Python ints, so no index tensor is made
    on the device (which would wait for it) in every layer."""
    parts, start = [], 0
    for axis, n in enumerate(sections):
        parts.append(positions_thw[axis][..., None].float() * freqs[start:start + n])
        start += n
    return torch.cat(parts, dim=-1)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the Dh/2 frequency slots are partitioned into
    (temporal, height, width) sections, each rotated by its own position id
    (``positions_thw``: (3, ..., S)).  Text tokens use identical t/h/w ids,
    recovering standard RoPE."""
    d_head = x.shape[-1]
    if sum(sections) != d_head // 2:
        raise ValueError(f"mrope sections {sections} must sum to d_head/2={d_head // 2}")
    angles = _mrope_angles(positions_thw, rope_freqs(d_head, theta, x.device), sections)
    return _rotate(x, torch.cos(angles), torch.sin(angles))


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """(cos, sin) rotation tables, (B, S, Dh/2) fp32, computed once a forward
    for every layer (``cfg.hoist_rope``); ``positions`` is (B, S), or
    (3, B, S) under M-RoPE."""
    freqs = rope_freqs(cfg.d_head, cfg.rope_theta, positions.device)
    if cfg.mrope:
        angles = _mrope_angles(positions, freqs, cfg.mrope_sections)
    else:
        angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope_tables(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (B, S, H, Dh); tables from `rope_tables`."""
    return _rotate(x, *tables)


def positions_for(cfg: ModelConfig, batch: int, seq: int, offset=0,
                  device=None) -> torch.Tensor:
    """(batch, seq) int32 positions, or (3, batch, seq) under M-RoPE with the
    same id on all three axes (text); ``offset`` is an int, a 0-d tensor or
    a per-row ``(batch,)`` tensor."""
    if isinstance(offset, torch.Tensor) and device is None:
        device = offset.device
    off = torch.as_tensor(offset, device=device)
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos + (off[:, None] if off.ndim else off)   # per-row offsets allowed
    pos = pos.expand(batch, seq).to(torch.int32)
    if cfg.mrope:
        return pos[None].expand(3, batch, seq)
    return pos
