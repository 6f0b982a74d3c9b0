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

Under a sharding context whose tensor-parallel axis has n > 1 ranks that
divide the heads, each rank computes its H/n heads, as the reference's
rule table cuts the mixer's leaves over "model": its heads' columns of
z, x and dt, and B and C (N columns each, which every head reads) whole;
the conv over its x channels and B and C; the scan over its heads; the
gated norm over the whole d_inner from the ranks' summed sums of squares
(two launches of the `rms_norm` kernel around a (B, S) fp32 all-reduce);
its rows of ``out_proj``, the partial products summed over the axis.  Its
cache holds its conv channels (d_inner/n + 2N) and its heads' states.
Where the heads do not divide, every rank computes the whole mixer from
its gathered leaves.  Outside a context, and on an axis of one rank, the
mixer runs one packed ``in_proj`` product as it always has.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.context import (copy_to_tp, reduce_from_tp, sum_over_tp, tp_heads, tp_slices,
                                tp_whole_tree)
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


def param_shapes(cfg: ModelConfig) -> Dict:
    """The whole shape of each leaf of one layer's `init_mamba2`."""
    d_inner, H, N = _dims(cfg)
    conv_ch = d_inner + 2 * N
    return {"in_proj": {"w": (cfg.d_model, 2 * d_inner + 2 * N + H)},
            "conv_w": (cfg.ssm_conv, conv_ch), "conv_b": (conv_ch,), "A_log": (H,), "D": (H,),
            "dt_bias": (H,), "norm_scale": (d_inner,), "out_proj": {"w": (d_inner, cfg.d_model)}}


def cache_spans(cfg: ModelConfig, rank: int, n: int) -> Dict:
    """Where rank ``rank`` of ``n`` (heads split) holds its cache: for each
    leaf, (the dim, from the end, that is cut; its whole size; the spans
    ``[lo, hi)`` of the whole that the rank's part concatenates); None
    where the heads do not divide and every rank holds the whole cache."""
    d_inner, H, N = _dims(cfg)
    if H % n:
        return None
    c, h = d_inner // n, H // n
    return {"conv": (-1, d_inner + 2 * N, [(rank * c, (rank + 1) * c), (d_inner, d_inner + 2 * N)]),
            "state": (-3, H, [(rank * h, (rank + 1) * h)])}


def init_ssm_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """conv window in the compute type; the recurrent state fp32 always.
    Under a context that splits the heads, the rank's conv channels and
    heads' states."""
    d_inner, H, N = _dims(cfg)
    split = tp_heads(H)
    n = 1 if split is None else split[0]
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner // n + 2 * N),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
        "state": torch.zeros((batch, H // n, cfg.mamba_headdim, N), dtype=torch.float32,
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
    ``cfg.ssm_impl`` is not consulted.  Under a context that splits the
    heads the rank computes its own (see the module's docstring)."""
    d_inner, H, N = _dims(cfg)
    split = tp_heads(H)
    if split is not None:
        return _mamba2_part(params, x, cfg, cache, *split)
    params = tp_whole_tree(params, param_shapes(cfg))
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    proj = torch.matmul(x.to(cd), params["in_proj"]["w"].to(cd))
    z, xs, Bm, Cm, dt_raw = torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)
    y, new_cache = _conv_and_scan(xs, Bm, Cm, dt_raw, cfg, cache, params["conv_w"],
                                  params["conv_b"], params["dt_bias"], params["A_log"],
                                  params["D"])
    y = fused_rms_norm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"]["w"].to(cd))
    return out, new_cache


def _conv_and_scan(xs, Bm, Cm, dt_raw, cfg, cache, conv_w, conv_b, dt_bias, A_log, D):
    """The conv over (x, B, C), the gates and the scan of the heads whose
    channels ``xs`` holds; writes the cache.  Returns (y (B, S, channels)
    in the compute type, the cache)."""
    cd = dtype_of(cfg.compute_dtype)
    B, S, channels = xs.shape
    N = Bm.shape[-1]
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, conv_state = causal_conv(
        conv_in, conv_w.to(cd), conv_b.to(cd), None if cache is None else cache["conv"])
    conv_out = F.silu(conv_out)
    # Views of conv_out: the kernel reads them at its row stride, uncopied.
    xs, Bm, Cm = torch.split(conv_out, [channels, N, N], dim=-1)
    dt = F.softplus(dt_raw.to(torch.float32) + dt_bias[None, None])
    xh = xs.reshape(B, S, channels // cfg.mamba_headdim, cfg.mamba_headdim)

    init_state = None if cache is None else cache["state"]
    if S == 1:
        # Decode: exact single-step recurrence.
        y, state = ssd_reference(xh, Bm, Cm, dt, A_log, D, init_state=init_state)
    elif S % cfg.ssm_chunk == 0 and init_state is None:
        from repro_torch.kernels import ops as kops
        y, state = kops.ssm_scan(xh, Bm, Cm, dt, A_log, D, chunk=cfg.ssm_chunk)
    else:
        # Prefill into a cache (state carried), or S not a multiple of the chunk.
        chunk = cfg.ssm_chunk if S % cfg.ssm_chunk == 0 else 1
        y, state = ssd_chunked(xh, Bm, Cm, dt, A_log, D, chunk, init_state=init_state)
    new_cache = None
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)
        new_cache = cache
    return y.reshape(B, S, channels).to(cd), new_cache


def _mamba2_part(params, x, cfg: ModelConfig, cache, n: int, r: int):
    """`mamba2_block` on rank ``r`` of ``n``: its H/n heads (see the
    module's docstring).  The packed leaves are taken segment by segment
    (`tp_slices`), each gradient summed over the axis: B's and C's, which
    every rank's heads read, are partial sums over each rank's heads."""
    from repro_torch.kernels import ops as kops

    d_inner, H, N = _dims(cfg)
    shapes = param_shapes(cfg)
    c, h = d_inner // n, H // n
    cd = dtype_of(cfg.compute_dtype)
    mine = lambda base, width: (base + r * width, base + (r + 1) * width)
    bc = (2 * d_inner, 2 * d_inner + 2 * N)
    w = tp_slices(params["in_proj"]["w"], shapes["in_proj"]["w"], -1,
                  [mine(0, c), mine(d_inner, c), bc, mine(2 * d_inner + 2 * N, h)])
    proj = torch.matmul(copy_to_tp(x).to(cd), w.to(cd))
    z, xs, Bm, Cm, dt_raw = torch.split(proj, [c, c, N, N, h], dim=-1)
    conv = [mine(0, c), (d_inner, d_inner + 2 * N)]
    heads = lambda k: tp_slices(params[k], shapes[k], 0, [mine(0, h)])
    y, new_cache = _conv_and_scan(
        xs, Bm, Cm, dt_raw, cfg, cache,
        tp_slices(params["conv_w"], shapes["conv_w"], -1, conv),
        tp_slices(params["conv_b"], shapes["conv_b"], 0, conv),
        heads("dt_bias"), heads("A_log"), heads("D"))
    # The gated norm over the whole d_inner: each row's sum of squares
    # over the rank's channels, summed over the axis.
    scale = tp_slices(params["norm_scale"], shapes["norm_scale"], 0, [mine(0, c)])
    y = kops.split_rms_norm(y * F.silu(z), scale, cfg.norm_eps, d_inner, sum_over_tp)
    w_out = tp_slices(params["out_proj"]["w"], shapes["out_proj"]["w"], 0, [mine(0, c)])
    return reduce_from_tp(torch.matmul(y, w_out.to(cd))), new_cache
