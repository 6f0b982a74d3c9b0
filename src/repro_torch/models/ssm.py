"""Mamba2 (SSD -- state-space duality) blocks for zamba2-7b / hybrid stacks.

Selective state space per head p with state size N:

    S_t = exp(A·dt_t)·S_{t-1} + dt_t · x_t ⊗ B_t          (S: P×N)
    y_t = C_t · S_t + D · x_t

The port of `repro.models.ssm`, with its leaf names, shapes, types and
routes.  Training and prefill use the chunked algorithm (intra-chunk
quadratic form, inter-chunk state recurrence as a Python loop over the
chunks); decode carries (conv window, state) and steps in O(P·N).
`ssd_chunked` is the plain version of the hand-written `ssm_scan` kernel
(`repro_torch.kernels.ssm_scan`), which `mamba2_block` reaches through
`repro_torch.kernels.ops` on its cache-less route.

With a cache, `mamba2_block` writes the new conv window and state IN PLACE
into the cache's tensors (the reference returns fresh arrays).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dtype_of, fused_rms_norm, init_linear


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.mamba_headdim
    return d_inner, n_heads, cfg.ssm_state


def _log_uniform(generator, n: int, lo: float, hi: float, device) -> torch.Tensor:
    u = torch.rand((n,), generator=generator, device=device, dtype=torch.float32)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def init_mamba2(generator, cfg: ModelConfig, dtype, device=None) -> Dict:
    d_inner, H, N = _dims(cfg)
    d = cfg.d_model
    device = generator.device if device is None else device
    conv_ch = d_inner + 2 * N  # conv over (x, B, C)
    # A in [1, 16] log-init (Mamba2 default), dt bias = softplus^-1(1e-3 ... 1e-1).
    a_init = _log_uniform(generator, H, 1.0, 16.0, device)
    dt0 = _log_uniform(generator, H, 1e-3, 1e-1, device)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=generator, device=device,
                         dtype=torch.float32) * 0.1
    return {
        "in_proj": init_linear(generator, d, 2 * d_inner + 2 * N + H, dtype, device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(a_init),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": init_linear(generator, d_inner, d, dtype, scale=d_inner ** -0.5,
                                device=device),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B,S,C), w: (W,C).  ``state`` is the
    trailing W-1 inputs from the previous call (decode); returns new state."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, xp[:, -(W - 1):]


def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P)
    Bm: torch.Tensor,       # (B, S, N)
    Cm: torch.Tensor,       # (B, S, N)
    dt: torch.Tensor,       # (B, S, H)  (post-softplus)
    A_log: torch.Tensor,    # (H,)
    D: torch.Tensor,        # (H,)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B,S,H,P) fp32, final_state (B,H,P,N)
    fp32).  The plain version of the `ssm_scan` kernel."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(B, nc, chunk, H, P).to(f32)
    Bc = Bm.reshape(B, nc, chunk, N).to(f32)
    Cc = Cm.reshape(B, nc, chunk, N).to(f32)
    dtc = dt.reshape(B, nc, chunk, H).to(f32)
    la = -torch.exp(A_log.to(f32)) * dtc                        # (B,nc,L,H) log decay
    cum = torch.cumsum(la, dim=2)                               # inclusive cumsum

    # Intra-chunk quadratic term: w[i,j] = exp(cum_i - cum_j)·dt_j for j <= i.
    # The exponent is masked BEFORE exp (the reference masks after): the
    # values are the same, but exp of a masked cum_i - cum_j > 88 would be
    # inf, and its gradient 0 * inf = nan.
    li = cum[:, :, :, None, :]                                  # (B,nc,L,1,H)
    lj = cum[:, :, None, :, :]                                  # (B,nc,1,L,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    w = torch.exp((li - lj).masked_fill(~tri[None, None, :, :, None], -math.inf))
    w = w * dtc[:, :, None, :, :]                               # (B,nc,i,j,H)
    g = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                 # (B,nc,i,j)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", g[..., None] * w, xc)

    # Inter-chunk: carry the states across chunks.
    decay_end = torch.exp(cum[:, :, -1])                        # (B,nc,H)
    # Contribution of step j to the chunk-final state: exp(cum_L - cum_j)·dt_j.
    wL = torch.exp(cum[:, :, -1:, :] - cum) * dtc               # (B,nc,L,H)
    chunk_state = torch.einsum("bclh,bclhp,bcln->bchpn", wL, xc, Bc)

    state = (init_state.to(f32) if init_state is not None
             else torch.zeros((B, H, P, N), dtype=f32, device=x.device))
    # Unbound once: the backward of indexing [:, c] would allocate a zero
    # tensor of the whole (B,nc,H,P,N) chunk_state for each chunk; unbind's
    # stacks the chunks' gradients once.
    starts = []
    for dec, cs in zip(decay_end.unbind(1), chunk_state.unbind(1)):
        starts.append(state)                                    # state at chunk start
        state = state * dec[:, :, None, None] + cs
    S_starts = torch.stack(starts, dim=1)                       # (B,nc,H,P,N)
    # y_inter_i = exp(cum_i) · C_i · S_start
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cc, torch.exp(cum), S_starts)
    y = y_intra + y_inter + xc * D.to(f32)[None, None, None, :, None]
    return y.reshape(B, S, H, P), state


def ssd_reference(x, Bm, Cm, dt, A_log, D, init_state=None):
    """Step-by-step scan (O(S) sequential): the oracle of the chunked path,
    and the decode step's exact one-step recurrence."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    A = -torch.exp(A_log.to(f32))
    state = (init_state.to(f32) if init_state is not None
             else torch.zeros((B, H, P, N), dtype=f32, device=x.device))
    ys = []
    for t in range(S):
        xt, bt, ct, dtt = x[:, t].to(f32), Bm[:, t].to(f32), Cm[:, t].to(f32), dt[:, t].to(f32)
        dec = torch.exp(A[None] * dtt)                          # (B,H)
        state = state * dec[..., None, None] + torch.einsum("bhp,bn,bh->bhpn", xt, bt, dtt)
        ys.append(torch.einsum("bhpn,bn->bhp", state, ct))
    y = torch.stack(ys, dim=1) + x.to(f32) * D.to(f32)[None, None, :, None]
    return y, state


def init_ssm_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """conv window in the compute type; the recurrent state fp32 always."""
    d_inner, H, N = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * N),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
        "state": torch.zeros((batch, H, cfg.mamba_headdim, N), dtype=torch.float32,
                             device=device),
    }


def mamba2_block(
    params: Dict,
    x: torch.Tensor,                 # (B, S, d) -- pre-normed input
    cfg: ModelConfig,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 mixer.  With ``cache`` (decode) S may be 1; state is carried,
    and the cache's ``conv`` and ``state`` are updated in place.

    Routes, as the reference's: S == 1 takes the exact recurrence
    `ssd_reference`; no cache and ``S % ssm_chunk == 0`` takes the
    `ssm_scan` kernel (its plain version for a CPU tensor); anything else
    the chunked scan `ssd_chunked` (``chunk=1`` when S does not divide).
    ``cfg.ssm_impl`` is not consulted."""
    d_inner, H, N = _dims(cfg)
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    proj = torch.matmul(x.to(cd), params["in_proj"]["w"].to(cd))
    z, xs, Bm, Cm, dt_raw = torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, conv_state = causal_conv(
        conv_in, params["conv_w"].to(cd), params["conv_b"].to(cd),
        None if cache is None else cache["conv"],
    )
    conv_out = F.silu(conv_out)
    # Views of conv_out: the kernel reads them at its row stride, uncopied.
    xs, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"][None, None])
    xh = xs.reshape(B, S, H, cfg.mamba_headdim)

    init_state = None if cache is None else cache["state"]
    if S == 1:
        # Decode: exact single-step recurrence.
        y, state = ssd_reference(xh, Bm, Cm, dt, params["A_log"], params["D"],
                                 init_state=init_state)
    elif S % cfg.ssm_chunk == 0 and init_state is None:
        from repro_torch.kernels import ops as kops
        y, state = kops.ssm_scan(xh, Bm, Cm, dt, params["A_log"], params["D"],
                                 chunk=cfg.ssm_chunk)
    else:
        # Prefill into a cache (state carried), or S not a multiple of the chunk.
        chunk = cfg.ssm_chunk if S % cfg.ssm_chunk == 0 else 1
        y, state = ssd_chunked(xh, Bm, Cm, dt, params["A_log"], params["D"], chunk,
                               init_state=init_state)
    new_cache = None
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)
        new_cache = cache

    y = y.reshape(B, S, d_inner).to(cd)
    y = fused_rms_norm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"]["w"].to(cd))
    return out, new_cache
