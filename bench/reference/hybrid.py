"""The Mamba2 hybrid (zamba2-7b as the port builds it), plain float32:
token embedding; Mamba2 layers, each a pre-norm mixer added to the
residual stream; one attention block whose weights every application
shares (the dense family's block, GELU feed-forward), applied before
each layer whose index is a multiple of ``shared_attn_every``; a final
RMSNorm, an untied head and mean cross-entropy.

The Mamba2 mixer (Dao and Gu 2024): one input projection to (z, x, B, C,
dt); a depthwise causal conv over (x, B, C) and SiLU; dt = softplus(dt +
dt_bias); per head the state space S_t = exp(A dt_t) S_{t-1} + dt_t x_t
B_t^T, y_t = S_t C_t + D x_t with A = -exp(A_log) and B and C shared by
the heads; y gated by SiLU(z) and RMS-normalised; an output projection.
The recurrence is computed in its chunked form (exact for any chunk): a
quadratic form inside each chunk and the states carried from chunk to
chunk.  Each layer is recomputed in the backward."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import (Precision, attention_block, layer_leaves, mean_cross_entropy,
                              rms_norm)

#: The reference's own chunk length (any length gives the same values).
CHUNK = 64


def _segsum_exp(a: torch.Tensor) -> torch.Tensor:
    """exp(a_{j+1} + ... + a_i) for j <= i, else 0, over the last axis of
    ``a`` (..., L): (..., L, L), rows i, columns j."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    keep = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return torch.exp(diff.masked_fill(~keep, -float("inf")))


def ssd(x, dt, A, Bm, Cm, chunk: int = CHUNK):
    """x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N) -> y (B,
    S, H, P) of the recurrence from a zero state (without the D term)."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    nc, L = S // chunk, chunk
    xc = (x * dt[..., None]).view(b, nc, L, H, P)
    Bc, Cc = Bm.view(b, nc, L, N), Cm.view(b, nc, L, N)
    a = (dt * A).view(b, nc, L, H).permute(0, 1, 3, 2)                 # (b, c, H, L)
    decay = _segsum_exp(a)                                            # (b, c, H, L, L)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bcij,bchij,bcjhp->bcihp", scores, decay, xc)
    # Each chunk's state from its own inputs, decayed to the chunk's end.
    cum = torch.cumsum(a, dim=-1)                                     # (b, c, H, L)
    to_end = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bchj,bcjhp,bcjn->bchpn", to_end, xc, Bc)
    # The state at each chunk's start: the earlier chunks' states, carried.
    # carry[c, d] = exp(T_{d+1} + ... + T_{c-1}) for d < c, T a chunk's decay.
    ends = F.pad(cum[..., -1].transpose(1, 2), (1, 0))                # (b, H, c + 1)
    carry = _segsum_exp(ends)[..., :-1, 1:]                           # (b, H, c, c)
    start = torch.einsum("bhcd,bdhpn->bchpn", carry, states)
    y = y + torch.einsum("bcin,bchpn,bchi->bcihp", Cc, start, torch.exp(cum))
    return y.reshape(b, S, H, P)


def mixer(p, h, cfg, prec: Precision):
    b, S, _ = h.shape
    di = cfg["ssm_expand"] * cfg["d_model"]
    P, N = cfg["mamba_headdim"], cfg["ssm_state"]
    H = di // P
    z, xs, Bm, Cm, dt = torch.split(prec.mm(h, p["mixer.in_proj.w"]), [di, di, N, N, H], dim=-1)
    w = p["mixer.conv_w"]                                             # (width, channels)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1).transpose(1, 2)
    conv = F.conv1d(F.pad(conv_in, (w.shape[0] - 1, 0)), w.t()[:, None, :],
                    p["mixer.conv_b"], groups=w.shape[1])
    xs, Bm, Cm = torch.split(F.silu(conv.transpose(1, 2)), [di, N, N], dim=-1)
    dt = F.softplus(dt + p["mixer.dt_bias"])
    x = xs.reshape(b, S, H, P)
    y = ssd(x, dt, -torch.exp(p["mixer.A_log"]), Bm, Cm) + x * p["mixer.D"][:, None]
    y = rms_norm(y.reshape(b, S, di) * F.silu(z), p["mixer.norm_scale"], cfg["norm_eps"])
    return prec.mm(y, p["mixer.out_proj.w"])


def mamba_layer(p, x, cfg, prec: Precision):
    return x + mixer(p, rms_norm(x, p["norm1.scale"], cfg["norm_eps"]), cfg, prec)


def loss(params, inputs, targets, cfg, prec: Precision):
    shared = {k[len("shared_attn."):]: v for k, v in params.items()
              if k.startswith("shared_attn.")}
    x = params["embed.embedding"][inputs]
    for i in range(cfg["n_layers"]):
        if i % cfg["shared_attn_every"] == 0:
            x = checkpoint(attention_block, shared, x, cfg, prec, use_reentrant=False)
        x = checkpoint(mamba_layer, layer_leaves(params, cfg, i), x, cfg, prec,
                       use_reentrant=False)
    h = rms_norm(x, params["final_norm.scale"], cfg["norm_eps"])
    return mean_cross_entropy(h, params["unembed.w"], targets, prec)
