"""xLSTM blocks (xlstm-1.3b): mLSTM (matrix memory, parallelizable) and
sLSTM (scalar memory with recurrent connections), both with exponential
gating and max-stabilizers, per Beck et al. 2024.

The port of `repro.models.xlstm`, with its leaf names, shapes, types and
routes.  The stack follows the paper's [7:1] ratio: every 8th block is
sLSTM, the rest mLSTM (`repro_torch.configs.xlstm_1_3b`).  Both
recurrences run in fp32 whatever the compute type, as do the gate
projections and the sLSTM recurrent weights; where the reference scans
with `jax.lax.scan`, a Python loop runs over the sequence (mLSTM's chunked
form over the chunks).  mLSTM state is (C: P×P matrix, n: P, m: scalar)
per head, sLSTM state is (c, n, h, m) vectors per head.  sLSTM is
inherently sequential (recurrent weights on h): there is no parallel form.

Both mixer norms go through `layers.fused_rms_norm`, the hand-written
`rms_norm` kernel for a CUDA tensor.  With a cache, the blocks write the
new conv window and states IN PLACE into the cache's tensors (the
reference returns fresh arrays).

Under a sharding context whose tensor-parallel axis has n > 1 ranks that
divide the heads, each rank computes its H/n heads, as the reference's
rule table cuts the mixers' leaves over "model".  mLSTM: its heads'
channels of x and z (``up_proj`` taken segment by segment), the conv, and
the block-diagonal q/k/v by the blocks inside its heads; the input and
forget gates read all of x, so each rank multiplies its channels' rows of
``w_gates`` and the (B, S, 2H) partial sums are summed over the axis; the
recurrence over its heads; the norm over the whole d_inner from the
ranks' summed sums of squares; its rows of ``down_proj``, summed over the
axis.  sLSTM: its channels of the input projection and conv, then every
channel gathered (each gate reads them all) for its heads' columns of the
four gates; the token loop over its heads with its blocks of
``r_gates``; the norm as mLSTM's; the up/down FFN by its columns and rows
where the axis divides the FFN's width, else whole on every rank.  Where
the heads do not divide, every rank computes the whole mixer from its
gathered leaves; outside a context, and on an axis of one rank, the
mixers run as they always have.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.context import (copy_to_tp, gather_tp, reduce_from_tp, sum_over_tp,
                                tp_gather_whole, tp_heads, tp_slices, tp_whole_tree)
from .config import ModelConfig
from .ffn import _gelu
from .layers import dtype_of, fused_rms_norm, init_linear
from .ssm import causal_conv


def _head_dims(cfg: ModelConfig) -> Tuple[int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.n_heads


def _slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    d_inner = cfg.slstm_expand * cfg.d_model
    return d_inner, d_inner // cfg.n_heads


def _randn(generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def init_blockdiag(generator, d: int, block: int, dtype, device=None) -> Dict:
    """Block-diagonal linear (xLSTM q/k/v, blocksize 4): (d/bs, bs, bs)."""
    device = generator.device if device is None else device
    w = _randn(generator, (d // block, block, block), device) * block ** -0.5
    return {"w": w.to(dtype)}


def apply_blockdiag(p, x, cd):
    nb, bs, _ = p["w"].shape
    xb = x.reshape(*x.shape[:-1], nb, bs).to(cd)
    y = torch.einsum("...np,npq->...nq", xb, p["w"].to(cd))
    return y.reshape(x.shape)


# =============================================================== mLSTM ====
def init_mlstm(generator, cfg: ModelConfig, dtype, device=None) -> Dict:
    d, (d_inner, P) = cfg.d_model, _head_dims(cfg)
    H = cfg.n_heads
    device = generator.device if device is None else device
    lin = lambda d_in, d_out, dt=dtype, **kw: init_linear(generator, d_in, d_out, dt,
                                                          device=device, **kw)
    up_proj = lin(d, 2 * d_inner)
    conv_w = (_randn(generator, (cfg.ssm_conv, d_inner), device) * 0.1).to(dtype)
    blockdiag = lambda: init_blockdiag(generator, d_inner, cfg.qkv_block, dtype, device)
    wq, wk, wv = blockdiag(), blockdiag(), blockdiag()
    return {
        "up_proj": up_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "wq": wq,
        "wk": wk,
        "wv": wv,
        "w_gates": lin(d_inner, 2 * H, torch.float32),      # ĩ, f̃ per head
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "down_proj": lin(d_inner, d, scale=d_inner ** -0.5),
    }


def mlstm_recurrence(q, k, v, igate, fgate, init=None):
    """Stabilized mLSTM scan.  q,k,v: (B,S,H,P); gates: (B,S,H) pre-act.
    Returns (h (B,S,H,P) fp32, (C,n,m) final)."""
    B, S, H, P = q.shape
    f32 = torch.float32
    q, k, v = (t.to(f32) for t in (q, k, v))
    k = k / (P ** 0.5)
    lf = F.logsigmoid(fgate.to(f32))                # log forget gate
    li = igate.to(f32)                              # log input gate (i = exp(ĩ))
    if init is None:
        init = (torch.zeros((B, H, P, P), dtype=f32, device=q.device),
                torch.zeros((B, H, P), dtype=f32, device=q.device),
                torch.zeros((B, H), dtype=f32, device=q.device))
    C, n, m = init                                  # (B,H,P,P), (B,H,P), (B,H)
    hs = []
    for qt, kt, vt, lft, lit in zip(*(t.unbind(1) for t in (q, k, v, lf, li))):
        m_new = torch.maximum(lft + m, lit)
        fp = torch.exp(lft + m - m_new)             # stabilized gates
        ip = torch.exp(lit - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])    # v ⊗ k
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhpq,bhq->bhp", C, qt)
        den = torch.abs(torch.einsum("bhp,bhp->bh", n, qt))
        den = torch.maximum(den, torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_chunked(q, k, v, igate, fgate, chunk: int, init=None):
    """Chunkwise-parallel stabilized mLSTM (the xLSTM paper's training form).
    Same math as `mlstm_recurrence`, but the matrix memory C materializes
    only at chunk boundaries, so the backward keeps one (P×P) state a chunk
    instead of one a token.

    q,k,v: (B,S,H,P); gates: (B,S,H) pre-activation.  Returns
    (h (B,S,H,P) fp32, (C,n,m) final)."""
    B, S, H, P = q.shape
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    nc, L = S // chunk, chunk
    f32 = torch.float32
    qs = q.reshape(B, nc, L, H, P).to(f32)
    ks = k.reshape(B, nc, L, H, P).to(f32) / (P ** 0.5)
    vs = v.reshape(B, nc, L, H, P).to(f32)
    lf = F.logsigmoid(fgate.to(f32)).reshape(B, nc, L, H)
    li = igate.to(f32).reshape(B, nc, L, H)
    b = torch.cumsum(lf, dim=2)                     # (B,nc,L,H) inclusive
    btot = b[:, :, -1]                              # (B,nc,H)
    # Intra-chunk log weights D_ij = b_i − b_j + ĩ_j (j ≤ i), masked to −inf
    # before the exp, as the reference masks them.
    D = b[:, :, :, None, :] - b[:, :, None, :, :] + li[:, :, None, :, :]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    D = D.masked_fill(~tri[None, None, :, :, None], -torch.inf)
    m_intra = D.amax(dim=3)                         # (B,nc,L,H)
    # Chunk-final state ingredients.
    wstate = btot[:, :, None, :] - b + li           # (B,nc,L,H)
    m_state = wstate.amax(dim=2)                    # (B,nc,H)
    s = torch.einsum("bclhp,bcjhp->bchlj", qs, ks)  # (B,nc,H,L,L)

    if init is None:
        init = (torch.zeros((B, H, P, P), dtype=f32, device=q.device),
                torch.zeros((B, H, P), dtype=f32, device=q.device),
                torch.zeros((B, H), dtype=f32, device=q.device))
    C, n, m = init                                  # (B,H,P,P),(B,H,P),(B,H)
    hs = []
    # Unbound once: the backward of indexing [:, c] would allocate a zero
    # tensor of the whole input for each chunk; unbind's stacks them once.
    per_chunk = (t.unbind(1) for t in (qs, ks, vs, b, D, m_intra, s, btot, wstate, m_state))
    for q_c, k_c, v_c, b_c, D_c, mi_c, s_c, bt_c, ws_c, ms_c in zip(*per_chunk):
        m_i = torch.maximum(mi_c, b_c + m[:, None])                  # (B,L,H)
        Pij = torch.exp(D_c - m_i[:, :, None])                       # (B,L,L,H)
        W = s_c * Pij.permute(0, 3, 1, 2)                            # (B,H,i,j)
        num = torch.einsum("bhij,bjhp->bihp", W, v_c)                # intra numerator
        den = W.sum(dim=-1).transpose(1, 2)                          # (B,i,H)
        w_inter = torch.exp(b_c + m[:, None] - m_i)                  # (B,L,H)
        num = num + w_inter[..., None] * torch.einsum("bhvk,blhk->blhv", C, q_c)
        den = den + w_inter * torch.einsum("bhk,blhk->blh", n, q_c)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_i))[..., None])
        # Advance the carry.
        m_new = torch.maximum(bt_c + m, ms_c)                        # (B,H)
        wS = torch.exp(ws_c - m_new[:, None])                        # (B,L,H)
        decay = torch.exp(bt_c + m - m_new)
        C = decay[..., None, None] * C + torch.einsum("blhv,blhk->bhvk",
                                                      wS[..., None] * v_c, k_c)
        n = decay[..., None] * n + torch.einsum("blh,blhk->bhk", wS, k_c)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, H, P)
    return h, (C, n, m)


def mlstm_split(cfg: ModelConfig) -> Optional[Tuple[int, int]]:
    """(ranks, this rank) where the mLSTM mixer's heads split over the
    tensor-parallel axis (and a rank's channels hold whole q/k/v blocks);
    None where every rank computes it whole."""
    split = tp_heads(cfg.n_heads)
    if split is None or mlstm_cache_spans(cfg, *split[::-1]) is None:
        return None
    return split


def mlstm_param_shapes(cfg: ModelConfig) -> Dict:
    """The whole shape of each leaf of one layer's `init_mlstm`."""
    d, (d_inner, _) = cfg.d_model, _head_dims(cfg)
    blocks = (d_inner // cfg.qkv_block, cfg.qkv_block, cfg.qkv_block)
    return {"up_proj": {"w": (d, 2 * d_inner)}, "conv_w": (cfg.ssm_conv, d_inner),
            "conv_b": (d_inner,), "wq": {"w": blocks}, "wk": {"w": blocks}, "wv": {"w": blocks},
            "w_gates": {"w": (d_inner, 2 * cfg.n_heads)}, "norm_scale": (d_inner,),
            "down_proj": {"w": (d_inner, d)}}


def slstm_param_shapes(cfg: ModelConfig) -> Dict:
    """The whole shape of each leaf of one layer's `init_slstm`."""
    d, (d_inner, P) = cfg.d_model, _slstm_dims(cfg)
    ff = int(d_inner * 4 / 3)
    return {"in_proj": {"w": (d, d_inner)}, "conv_w": (cfg.ssm_conv, d_inner),
            "conv_b": (d_inner,), "w_gates": {"w": (d_inner, 4 * d_inner)},
            "r_gates": (4, cfg.n_heads, P, P), "norm_scale": (d_inner,),
            "w_up": {"w": (d_inner, 2 * ff)}, "w_down": {"w": (ff, d)}}


def _state_spans(d_inner: int, H: int, rank: int, n: int, vectors) -> Dict:
    """`cache_spans` of a mixer whose cache is a conv window over d_inner
    channels and per-head states: ``vectors`` maps each state leaf to the
    dim, from the end, of its heads."""
    c, h = d_inner // n, H // n
    spans = {"conv": (-1, d_inner, [(rank * c, (rank + 1) * c)])}
    spans.update({k: (dim, H, [(rank * h, (rank + 1) * h)]) for k, dim in vectors.items()})
    return spans


def mlstm_cache_spans(cfg: ModelConfig, rank: int, n: int) -> Optional[Dict]:
    """Where rank ``rank`` of ``n`` holds its mLSTM cache (see
    `repro_torch.models.ssm.cache_spans`); None where it is whole."""
    d_inner = _head_dims(cfg)[0]
    if cfg.n_heads % n or (d_inner // n) % cfg.qkv_block:
        return None
    return _state_spans(d_inner, cfg.n_heads, rank, n, {"C": -3, "n": -2, "m": -1})


def slstm_cache_spans(cfg: ModelConfig, rank: int, n: int) -> Optional[Dict]:
    """Where rank ``rank`` of ``n`` holds its sLSTM cache; None where it is
    whole."""
    if cfg.n_heads % n:
        return None
    return _state_spans(_slstm_dims(cfg)[0], cfg.n_heads, rank, n,
                        {k: -2 for k in ("c", "n", "h", "m")})


def init_mlstm_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """conv window in the compute type; the states fp32 always.  Under a
    context that splits the heads, the rank's channels and heads."""
    d_inner, P = _head_dims(cfg)
    split = mlstm_split(cfg)
    n = 1 if split is None else split[0]
    H = cfg.n_heads // n
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner // n),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
        "C": torch.zeros((batch, H, P, P), dtype=f32, device=device),
        "n": torch.zeros((batch, H, P), dtype=f32, device=device),
        "m": torch.zeros((batch, H), dtype=f32, device=device),
    }


def _write(cache: Optional[Dict], new: Dict) -> Optional[Dict]:
    """Copies ``new``'s tensors into the cache's, IN PLACE; returns the cache."""
    if cache is not None:
        for key, t in new.items():
            cache[key].copy_(t)
    return cache


def mlstm_block(params, x, cfg: ModelConfig, cache: Optional[Dict] = None):
    """x: (B,S,d) pre-normed -> (out, cache).  Routes, as the reference's:
    the chunked form when ``S > 1`` and S is a multiple of
    ``min(mlstm_chunk, S)``, else the step-by-step recurrence (decode).
    Under a context that splits the heads the rank computes its own (see
    the module's docstring)."""
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    d_inner, P = _head_dims(cfg)
    H = cfg.n_heads
    split = mlstm_split(cfg)
    if split is not None:
        return _mlstm_part(params, x, cfg, cache, *split)
    params = tp_whole_tree(params, mlstm_param_shapes(cfg))
    up = torch.matmul(x.to(cd), params["up_proj"]["w"].to(cd))
    xm, z = up.chunk(2, dim=-1)
    conv_out, conv_state = causal_conv(
        xm, params["conv_w"].to(cd), params["conv_b"].to(cd),
        None if cache is None else cache["conv"])
    xc = F.silu(conv_out)
    q = apply_blockdiag(params["wq"], xc, cd).reshape(B, S, H, P)
    k = apply_blockdiag(params["wk"], xc, cd).reshape(B, S, H, P)
    v = apply_blockdiag(params["wv"], xm, cd).reshape(B, S, H, P)
    gates = torch.matmul(xm.to(torch.float32), params["w_gates"]["w"])
    igate, fgate = gates.chunk(2, dim=-1)
    h, new = _mlstm_cell(q, k, v, igate, fgate, cfg, cache)
    h = h.reshape(B, S, d_inner).to(cd)
    h = fused_rms_norm(h, params["norm_scale"], cfg.norm_eps) * F.silu(z)
    out = torch.matmul(h, params["down_proj"]["w"].to(cd))
    return out, _write(cache, dict(new, conv=conv_state))


def _mlstm_cell(q, k, v, igate, fgate, cfg: ModelConfig, cache):
    """The recurrence over the heads of q, k, v from the cache's states:
    (h (B, S, heads, P) fp32, the new C, n and m)."""
    S = q.shape[1]
    init = None if cache is None else (cache["C"], cache["n"], cache["m"])
    chunk = min(cfg.mlstm_chunk, S)
    if S > 1 and S % chunk == 0:
        h, (C, n, m) = mlstm_chunked(q, k, v, igate, fgate, chunk, init)
    else:
        h, (C, n, m) = mlstm_recurrence(q, k, v, igate, fgate, init)
    return h, {"C": C, "n": n, "m": m}


def _mlstm_part(params, x, cfg: ModelConfig, cache, n: int, r: int):
    """`mlstm_block` on rank ``r`` of ``n``: its H/n heads (see the
    module's docstring)."""
    from repro_torch.kernels import ops as kops

    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    d_inner, P = _head_dims(cfg)
    H, shapes = cfg.n_heads, mlstm_param_shapes(cfg)
    c, h = d_inner // n, H // n
    mine = lambda base, width: (base + r * width, base + (r + 1) * width)
    w_up = tp_slices(params["up_proj"]["w"], shapes["up_proj"]["w"], -1,
                     [mine(0, c), mine(d_inner, c)])
    xm, z = torch.matmul(copy_to_tp(x).to(cd), w_up.to(cd)).chunk(2, dim=-1)
    conv = lambda k: tp_slices(params[k], shapes[k], -1, [mine(0, c)])
    conv_out, conv_state = causal_conv(
        xm, conv("conv_w").to(cd), conv("conv_b").to(cd), None if cache is None else cache["conv"])
    xc = F.silu(conv_out)
    nb = c // cfg.qkv_block
    blocks = lambda k: {"w": tp_slices(params[k]["w"], shapes[k]["w"], 0, [mine(0, nb)])}
    q = apply_blockdiag(blocks("wq"), xc, cd).reshape(B, S, h, P)
    k = apply_blockdiag(blocks("wk"), xc, cd).reshape(B, S, h, P)
    v = apply_blockdiag(blocks("wv"), xm, cd).reshape(B, S, h, P)
    # Every head's gates read all of x: the rank's channels' rows of
    # w_gates, summed over the axis, then its heads' columns.
    w_gates = tp_slices(params["w_gates"]["w"], shapes["w_gates"]["w"], 0, [mine(0, c)])
    gates = sum_over_tp(torch.matmul(xm.to(torch.float32), w_gates))
    igate, fgate = gates[..., slice(*mine(0, h))], gates[..., slice(*mine(H, h))]
    hs, new = _mlstm_cell(q, k, v, igate, fgate, cfg, cache)
    scale = tp_slices(params["norm_scale"], shapes["norm_scale"], 0, [mine(0, c)])
    hs = kops.split_rms_norm(hs.reshape(B, S, c).to(cd), scale, cfg.norm_eps, d_inner,
                             sum_over_tp) * F.silu(z)
    w_down = tp_slices(params["down_proj"]["w"], shapes["down_proj"]["w"], 0, [mine(0, c)])
    out = reduce_from_tp(torch.matmul(hs, w_down.to(cd)))
    return out, _write(cache, dict(new, conv=conv_state))


# =============================================================== sLSTM ====
def init_slstm(generator, cfg: ModelConfig, dtype, device=None) -> Dict:
    d, (d_inner, P) = cfg.d_model, _slstm_dims(cfg)
    H = cfg.n_heads
    device = generator.device if device is None else device
    lin = lambda d_in, d_out, dt=dtype, **kw: init_linear(generator, d_in, d_out, dt,
                                                          device=device, **kw)
    # Input weights for 4 gates (z,i,f,o) + block-diag recurrent weights.
    in_proj = lin(d, d_inner)
    r = _randn(generator, (4, H, P, P), device) * P ** -0.5
    conv_w = (_randn(generator, (cfg.ssm_conv, d_inner), device) * 0.1).to(dtype)
    w_gates = lin(d_inner, 4 * d_inner, torch.float32)
    ff = int(d_inner * 4 / 3)
    w_up = lin(d_inner, 2 * ff)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "w_gates": w_gates,
        "r_gates": r,
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "w_up": w_up,
        "w_down": lin(ff, d, scale=ff ** -0.5),
    }


def make_slstm_step(r):
    """One sLSTM time step.  ``r``: (4,H,P,P) block-diagonal recurrent
    weights for (z,i,f,o).  Carry: (c,n,h,m) each (B,H,P); input gx:
    (B,4,H,P) -- this step's input-weight contributions to the gates.

    ``r`` is laid out as (H, 4P, P) once, here, so that each step's
    recurrent product is one `torch.bmm` over the heads that keeps a view
    of that one tensor for its backward (a copy a step would be 16 MB a
    step at xlstm-1.3b's widths)."""
    G, H, P, _ = r.shape
    r_heads = r.permute(1, 0, 2, 3).reshape(H, G * P, P)

    def step(carry, gx):
        c, n, h, m = carry
        B = h.shape[0]
        rec = torch.bmm(r_heads, h.permute(1, 2, 0))               # (H, 4P, B)
        pre = gx + rec.view(H, G, P, B).permute(3, 1, 0, 2)         # (B,4,H,P)
        zt = torch.tanh(pre[:, 0])
        lit = pre[:, 1]                             # log input gate (i = exp)
        lft = F.logsigmoid(pre[:, 2])
        ot = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(lft + m, lit)
        ip = torch.exp(lit - m_new)
        fp = torch.exp(lft + m - m_new)
        c_new = fp * c + ip * zt
        n_new = fp * n + ip
        h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
        return (c_new, n_new, h_new, m_new), h_new

    return step


def slstm_block(params, x, cfg: ModelConfig, cache: Optional[Dict] = None):
    """x: (B,S,d) pre-normed -> (out, cache); one `make_slstm_step` a
    token, in a Python loop.  Under a context that splits the heads the
    rank computes its own (see the module's docstring)."""
    split = tp_heads(cfg.n_heads)
    if split is not None:
        return _slstm_part(params, x, cfg, cache, *split)
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    d_inner, P = _slstm_dims(cfg)
    H = cfg.n_heads
    params = tp_whole_tree(params, slstm_param_shapes(cfg))
    xi = torch.matmul(x.to(cd), params["in_proj"]["w"].to(cd))
    conv_out, conv_state = causal_conv(
        xi, params["conv_w"].to(cd), params["conv_b"].to(cd),
        None if cache is None else cache["conv"])
    xc = F.silu(conv_out)
    gx = torch.matmul(xc.to(torch.float32), params["w_gates"]["w"])
    h, carry = _slstm_loop(gx.reshape(B, S, 4, H, P), params["r_gates"], cache)
    h = h.reshape(B, S, d_inner).to(cd)
    h = fused_rms_norm(h, params["norm_scale"], cfg.norm_eps)
    a, b = torch.matmul(h, params["w_up"]["w"].to(cd)).chunk(2, dim=-1)
    out = torch.matmul(_gelu(a) * b, params["w_down"]["w"].to(cd))
    c, n, h_last, m = carry
    return out, _write(cache, {"conv": conv_state, "c": c, "n": n, "h": h_last, "m": m})


def _slstm_loop(gx, r_gates, cache):
    """The token loop over the heads of ``gx`` (B, S, 4, heads, P) from
    the cache's carry: (h (B, S, heads, P) fp32, the final carry)."""
    B, S, _, H, P = gx.shape
    step = make_slstm_step(r_gates)
    if cache is None:
        carry = tuple(torch.zeros((B, H, P), dtype=torch.float32, device=gx.device)
                      for _ in range(4))
    else:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    hs = []
    for gx_t in gx.unbind(1):
        carry, h_t = step(carry, gx_t)
        hs.append(h_t)
    return torch.stack(hs, dim=1), carry


def _slstm_part(params, x, cfg: ModelConfig, cache, n: int, r: int):
    """`slstm_block` on rank ``r`` of ``n``: its H/n heads (see the
    module's docstring)."""
    from repro_torch.kernels import ops as kops

    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    d_inner, P = _slstm_dims(cfg)
    H, shapes = cfg.n_heads, slstm_param_shapes(cfg)
    c, h = d_inner // n, H // n
    mine = lambda base, width: (base + r * width, base + (r + 1) * width)
    w_in = tp_slices(params["in_proj"]["w"], shapes["in_proj"]["w"], -1, [mine(0, c)])
    xi = torch.matmul(copy_to_tp(x).to(cd), w_in.to(cd))
    conv = lambda k: tp_slices(params[k], shapes[k], -1, [mine(0, c)])
    conv_out, conv_state = causal_conv(
        xi, conv("conv_w").to(cd), conv("conv_b").to(cd), None if cache is None else cache["conv"])
    # Each gate reads every channel: the ranks' channels gathered, times
    # the rank's heads' columns of each of the four gates.
    xc = gather_tp(F.silu(conv_out), -1)
    w_gates = tp_slices(params["w_gates"]["w"], shapes["w_gates"]["w"], -1,
                        [mine(g * d_inner, c) for g in range(4)])
    gx = torch.matmul(xc.to(torch.float32), w_gates).reshape(B, S, 4, h, P)
    r_gates = tp_slices(params["r_gates"], shapes["r_gates"], 1, [mine(0, h)])
    hs, carry = _slstm_loop(gx, r_gates, cache)
    scale = tp_slices(params["norm_scale"], shapes["norm_scale"], 0, [mine(0, c)])
    hs = kops.split_rms_norm(hs.reshape(B, S, c).to(cd), scale, cfg.norm_eps, d_inner,
                             sum_over_tp)
    ff = shapes["w_down"]["w"][0]
    if ff % n == 0:
        # Megatron's FFN over the gathered channels: the rank's columns of
        # a and b, its rows of w_down, the partial products summed.
        f = ff // n
        w_up = tp_slices(params["w_up"]["w"], shapes["w_up"]["w"], -1, [mine(0, f), mine(ff, f)])
        a, b = torch.matmul(gather_tp(hs, -1), w_up.to(cd)).chunk(2, dim=-1)
        w_down = tp_slices(params["w_down"]["w"], shapes["w_down"]["w"], 0, [mine(0, f)])
        out = reduce_from_tp(torch.matmul(_gelu(a) * b, w_down.to(cd)))
    else:
        # The FFN's width does not divide: every rank computes it whole.
        ffn = tp_whole_tree({k: params[k] for k in ("w_up", "w_down")},
                            {k: shapes[k] for k in ("w_up", "w_down")})
        a, b = torch.matmul(tp_gather_whole(hs, -1), ffn["w_up"]["w"].to(cd)).chunk(2, dim=-1)
        out = torch.matmul(_gelu(a) * b, ffn["w_down"]["w"].to(cd))
    c_, n_, h_last, m = carry
    return out, _write(cache, {"conv": conv_state, "c": c_, "n": n_, "h": h_last, "m": m})


def init_slstm_cache(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """Under a context that splits the heads, the rank's channels and
    heads."""
    d_inner, P = _slstm_dims(cfg)
    split = tp_heads(cfg.n_heads)
    n = 1 if split is None else split[0]
    H = cfg.n_heads // n
    vec = lambda: torch.zeros((batch, H, P), dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner // n),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
        "c": vec(), "n": vec(), "h": vec(), "m": vec(),
    }
