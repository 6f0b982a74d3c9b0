"""Plain PyTorch pieces of the reference models, computed in float32.

Written from the models' published descriptions, independently of the
program: no import of the port, its kernels, its plain versions or its
tests.  Every matrix product goes through a `Precision`, so that the same
code, computed in float8 (the control: the nearest precision below the
bfloat16 the configurations state), stands in for the program to show
that the comparison fails it.  TF32 is switched off where the reference
runs (`no_tf32`).  Attention is taken a block of queries at a time and
each block is recomputed in the backward (`torch.utils.checkpoint`), so
the reference fits on the card at the cells' sizes."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale for the whole tensor (its
    largest magnitude to the format's largest), back in x's type."""
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands in e4m3 and, in the backward, the output's
    gradient in e5m2, as float8 training does."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn, E4M3_MAX), _fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    """How the reference multiplies: ``float32``, or ``float8`` (the
    control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "float8":
            return _Fp8MatMul.apply(a, b)
        return a @ b


def layer_leaves(params, cfg, i: int):
    """Layer ``i``'s leaves under their names inside its block: the
    layers of each full period are stacked (``blocks.pos<j>.<name>[<n>]``
    holds layer n * period + j), the rest are ``tail.<t>.<name>``."""
    per = cfg.get("shared_attn_every") or 1
    n_full = cfg["n_layers"] // per
    if i < n_full * per:
        pre, post = f"blocks.pos{i % per}.", f"[{i // per}]"
    else:
        pre, post = f"tail.{i - n_full * per}.", ""
    return {k[len(pre):len(k) - len(post)]: v for k, v in params.items()
            if k.startswith(pre) and k.endswith(post)}


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """Rotary positions 0..S-1 on x (B, S, H, D), the two halves of each
    head rotated as a pair (element i with element i + D/2)."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


#: Queries a block of the reference's attention.
Q_BLOCK = 1024


def _attend_block(q, k, v, i0: int, prec: Precision):
    """Causal softmax attention of queries [i0, i0 + n) (B, H, n, D)
    against every key (B, H, S, D)."""
    n, S, D = q.shape[2], k.shape[2], q.shape[-1]
    s = prec.mm(q, k.transpose(-1, -2)) * D ** -0.5
    qpos = torch.arange(i0, i0 + n, device=q.device)[:, None]
    s = s.masked_fill(qpos < torch.arange(S, device=q.device), -math.inf)
    return prec.mm(torch.softmax(s, dim=-1), v)


def causal_attention(q, k, v, prec: Precision):
    """q (B, S, Hq, D), k and v (B, S, Hkv, D): query head h reads kv head
    h // (Hq / Hkv).  Returns (B, S, Hq * D)."""
    B, S, Hq, D = q.shape
    g = Hq // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    blocks = [checkpoint(_attend_block, q[:, :, i:i + Q_BLOCK], k, v, i, prec,
                         use_reentrant=False) for i in range(0, S, Q_BLOCK)]
    return torch.cat(blocks, dim=2).transpose(1, 2).reshape(B, S, Hq * D)


def attention_block(p, x, cfg, prec: Precision):
    """Pre-norm self-attention (RoPE, causal, grouped kv heads) and
    feed-forward, each added to the residual stream."""
    B, S, d = x.shape
    dh, eps = cfg["d_head"], cfg["norm_eps"]
    h = rms_norm(x, p["norm1.scale"], eps)
    q = prec.mm(h, p["attn.wq.w"]).view(B, S, cfg["n_heads"], dh)
    k = prec.mm(h, p["attn.wk.w"]).view(B, S, cfg["n_kv_heads"], dh)
    v = prec.mm(h, p["attn.wv.w"]).view(B, S, cfg["n_kv_heads"], dh)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    x = x + prec.mm(causal_attention(q, k, v, prec), p["attn.wo.w"])
    h = rms_norm(x, p["norm2.scale"], eps)
    if cfg["ffn_type"] == "swiglu":
        f = F.silu(prec.mm(h, p["ffn.w_gate.w"])) * prec.mm(h, p["ffn.w_up.w"])
    else:  # gelu, the tanh form
        f = F.gelu(prec.mm(h, p["ffn.w_up.w"]), approximate="tanh")
    return x + prec.mm(f, p["ffn.w_down.w"])


#: Positions a block of the reference's loss.
LOSS_BLOCK = 1024


def _ce_sum(h, head, targets, prec: Precision):
    logits = prec.mm(h, head)
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten(), reduction="sum")


def mean_cross_entropy(h, head, targets, prec: Precision):
    """The mean over every position of -log softmax(h @ head)[target], a
    block of positions at a time, each recomputed in the backward."""
    B, S, _ = h.shape
    total = sum(checkpoint(_ce_sum, h[:, i:i + LOSS_BLOCK], head, targets[:, i:i + LOSS_BLOCK],
                           prec, use_reentrant=False) for i in range(0, S, LOSS_BLOCK))
    return total / (B * S)
