"""Grouped-query attention with RoPE / M-RoPE, a KV cache, and
cross-attention.

`gqa_reference` is the plain implementation (fp32 softmax).  Two paths go
through hand-written CUDA kernels when the tensors lie on the card:

* single-token decode against the cache: `repro_torch.kernels.ops
  .decode_attention`;
* full-sequence attention of training, the encoder and prefill without a
  cache: `flash_attention_jnp`, an autograd Function whose forward is
  `repro_torch.kernels.ops.flash_attention` and whose backward is the port
  of the reference's `_flash_bwd_rule` (recomputes each block's
  probabilities from the saved log-sum-exp).

The full-sequence causal self-attention is `flash_attention_jnp` on either
device: on a CPU tensor its forward is the plain online softmax
`_flash_fwd_math`, so the CPU tests run the card's route at any length.
Prefill into a cache, non-causal attention (the encoder's) and
cross-attention stay on `_self_attention_math`, which routes as the
reference's ``attn_impl="ref"`` does: `gqa_reference` below
`CHUNKED_ATTN_THRESHOLD`, `flash_attention_jnp` or `chunked_attention`
above it.

The cache is written IN PLACE: `attention` returns the same ``k``/``v``
tensors it was given, updated (the reference returns fresh arrays).

Under a sharding context whose tensor-parallel axis has n > 1 ranks the
heads split over it (`local_heads`), as the reference's rule table cuts
``wq``/``wk``/``wv`` by columns and ``wo`` by rows: each rank projects
its ``n_heads / n`` query heads and the kv heads they read, attends over
them (the kernels run at the local head counts), and its part of ``wo``'s
product is summed over the axis (`parallel.context.reduce_from_tp`).
Where ``n_kv_heads`` does not divide by n but n divides by it, several
ranks share a kv head: each projects that whole head (`tp_part` gathers
the columns it needs where the rule's cut falls inside a head).  Where the
query heads do not divide, every rank computes the whole attention, as
the reference does where its guard leaves the heads whole.  A KV cache
made under the context (`init_kv_cache`) holds the rank's kv heads.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..parallel.context import copy_to_tp, reduce_from_tp, tp_part, tp_rank, tp_size, tp_whole
from .config import ModelConfig
from .layers import apply_linear, apply_mrope, apply_rope, apply_rope_tables, dtype_of, init_linear

NEG_INF = -1e30


def init_attention(generator, cfg: ModelConfig, dtype, cross: bool = False,
                   device=None) -> Dict:
    d, dh = cfg.d_model, cfg.d_head
    lin = lambda d_in, d_out, **kw: init_linear(generator, d_in, d_out, dtype,
                                                device=device, **kw)
    return {
        "wq": lin(d, cfg.n_heads * dh, bias=cfg.qkv_bias),
        "wk": lin(d, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        "wv": lin(d, cfg.n_kv_heads * dh, bias=cfg.qkv_bias),
        "wo": lin(cfg.n_heads * dh, d, scale=(cfg.n_heads * dh) ** -0.5),
    }


@dataclasses.dataclass(frozen=True)
class Heads:
    """The attention heads this rank computes: ``n_q`` query heads from
    global head ``q0`` and ``n_kv`` kv heads from ``kv0``; ``split`` where
    they are a part of the layer's (tensor parallelism)."""
    n_q: int
    n_kv: int
    q0: int = 0
    kv0: int = 0
    split: bool = False


def local_heads(cfg: ModelConfig) -> Heads:
    """This rank's heads under the active context (all of them outside one,
    or where the query heads, or the kv heads' sharing, do not divide over
    the tensor-parallel axis)."""
    return heads_of(cfg, tp_rank(), tp_size())


def heads_of(cfg: ModelConfig, r: int, n: int) -> Heads:
    """The heads of rank ``r`` of a tensor-parallel axis of ``n`` ranks."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    if n == 1 or hq % n or (hkv % n and n % hkv):
        return Heads(hq, hkv)
    q = hq // n
    if hkv % n == 0:
        return Heads(q, hkv // n, r * q, r * (hkv // n), True)
    return Heads(q, 1, r * q, r * q // (hq // hkv), True)   # n / hkv ranks share a kv head


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device="cuda") -> Dict:
    shape = (batch, max_len, local_heads(cfg).n_kv, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _split_heads(x, n_heads, d_head):
    return x.reshape(*x.shape[:-1], n_heads, d_head)


def _columns(p: Dict, x: torch.Tensor, cd, whole: int, h0: int, nh: int, d_head: int,
             split: bool) -> torch.Tensor:
    """``x`` times the columns of heads ``[h0, h0 + nh)`` of the linear
    ``p`` (``whole`` columns), plus their bias: the rank's part of a
    column-parallel product where ``split``, else the whole product (a
    chunk the rule cut gathered, every rank computing it alike)."""
    if not split:
        return apply_linear({k: tp_whole(v, -1, whole) for k, v in p.items()}, x, cd)
    lo, hi = h0 * d_head, (h0 + nh) * d_head
    return apply_linear({k: tp_part(v, -1, whole, lo, hi) for k, v in p.items()}, x, cd)


def project_q(params: Dict, x, cfg: ModelConfig, heads: Heads) -> torch.Tensor:
    """(B, S, n_q, Dh) queries of this rank's heads; ``x`` as `copy_to_tp`
    passed it where the heads split."""
    cd = dtype_of(cfg.compute_dtype)
    q = _columns(params["wq"], x, cd, cfg.n_heads * cfg.d_head, heads.q0, heads.n_q,
                 cfg.d_head, heads.split)
    return _split_heads(q, heads.n_q, cfg.d_head)


def project_kv(params: Dict, src, cfg: ModelConfig, heads: Heads):
    """(B, S, n_kv, Dh) keys and values of this rank's kv heads."""
    cd = dtype_of(cfg.compute_dtype)
    whole = cfg.n_kv_heads * cfg.d_head
    k, v = (_columns(params[w], src, cd, whole, heads.kv0, heads.n_kv, cfg.d_head, heads.split)
            for w in ("wk", "wv"))
    return _split_heads(k, heads.n_kv, cfg.d_head), _split_heads(v, heads.n_kv, cfg.d_head)


def project_out(params: Dict, out, cfg: ModelConfig, heads: Heads) -> torch.Tensor:
    """``out`` (B, S, n_q * Dh) through ``wo``: where the heads split, the
    rank's rows of it, the partial products summed over the
    tensor-parallel axis, then the bias once."""
    cd = dtype_of(cfg.compute_dtype)
    p, whole = params["wo"], cfg.n_heads * cfg.d_head
    if not heads.split:
        return apply_linear(dict(p, w=tp_whole(p["w"], 0, whole)), out, cd)
    lo, hi = heads.q0 * cfg.d_head, (heads.q0 + heads.n_q) * cfg.d_head
    y = reduce_from_tp(torch.matmul(out.to(cd), tp_part(p["w"], 0, whole, lo, hi).to(cd)))
    return y + p["b"].to(cd) if "b" in p else y


def _rope(cfg: ModelConfig, x, positions, rope_cache=None):
    if rope_cache is not None:
        return apply_rope_tables(x, rope_cache)
    if positions is None:
        return x
    if cfg.mrope:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _per_row(value, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(value, device=device).expand(batch)


def gqa_reference(
    q: torch.Tensor,            # (B, Sq, Hq, Dh)
    k: torch.Tensor,            # (B, Sk, Hkv, Dh)
    v: torch.Tensor,            # (B, Sk, Hkv, Dh)
    causal: bool,
    q_offset=0,                 # absolute position of q[0]; int, 0-d or (B,)
    kv_len=None,                # #valid cache entries; int, 0-d or (B,)
) -> torch.Tensor:
    """Plain GQA attention; fp32 softmax.  The kernels are held against it."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / (Dh ** 0.5)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = None  # broadcastable to (B, Sq, Sk); offsets/lengths may be per-row
    if causal:
        if isinstance(q_offset, int):      # no device tensor, so no wait on the host
            mask = ((qpos[:, None] + q_offset) >= kpos[None, :])[None]
        else:
            qoff = _per_row(q_offset, B, q.device)
            mask = (qoff[:, None, None] + qpos[None, :, None]) >= kpos[None, None, :]
    if kv_len is not None:
        kvl = _per_row(kv_len, B, q.device)
        valid = kpos[None, None, :] < kvl[:, None, None]
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, Sq, Hq, Dh).to(q.dtype)


def _q_rows(t: torch.Tensor, i0: int, n: int, n_kv: int) -> torch.Tensor:
    """Rows ``[i0, i0+n)`` of a ``(B, S, Hq, D)`` tensor as fp32
    ``(B, Hkv, G*n, D)``: the G query heads of a kv head stacked, so that one
    batched product serves the whole group."""
    B, _, Hq, D = t.shape
    blk = t[:, i0:i0 + n].float().reshape(B, n, n_kv, Hq // n_kv, D)
    return blk.permute(0, 2, 3, 1, 4).reshape(B, n_kv, Hq // n_kv * n, D)


def _kv_rows(t: torch.Tensor, j0: int, n: int) -> torch.Tensor:
    """Rows ``[j0, j0+n)`` of a ``(B, S, Hkv, D)`` tensor as fp32 ``(B, Hkv, n, D)``."""
    return t[:, j0:j0 + n].float().permute(0, 2, 1, 3)


def _visible(i0: int, qc: int, j0: int, kc: int, causal: bool, q_offset, kv_len,
             device) -> Optional[torch.Tensor]:
    """Which (query, key) pairs of a block pair are seen, broadcastable to
    ``(B, Hkv, G, qc, kc)``; None when all are.  ``q_offset`` and ``kv_len``
    may be ints, 0-d or per-row ``(B,)`` tensors."""
    # An int offset or length stays a Python number: a device tensor made
    # from it is a host-to-device copy, which makes the host wait.
    as_rows = lambda t: t if isinstance(t, int) else torch.as_tensor(
        t, device=device).reshape(-1, 1, 1)
    kpos = torch.arange(j0, j0 + kc, device=device)
    mask = None
    if causal:
        qpos = torch.arange(i0, i0 + qc, device=device)[:, None]
        mask = (as_rows(q_offset) + qpos) >= kpos
    if kv_len is not None:
        valid = kpos < as_rows(kv_len)
        mask = valid if mask is None else mask & valid
    if mask is None:
        return None
    while mask.ndim < 3:                   # (rows, qc or 1, kc)
        mask = mask[None]
    return mask[:, None, None]


def _flash_fwd_math(q, k, v, causal, q_offset, kv_len, q_chunk, k_chunk):
    """Online-softmax forward, block by block.  q: (B,Sq,Hq,D) -> (out in q's
    type, lse (B,Hkv,G,Sq) fp32).  The plain counterpart of the CUDA
    `flash_attention` kernel; a ragged last block is masked, so the chunks
    need not divide the lengths."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    outs, lses = [], []
    for i0 in range(0, Sq, q_chunk):
        qc = min(q_chunk, Sq - i0)
        qb = _q_rows(q, i0, qc, Hkv)                              # (B,kv,G*qc,D)
        m = torch.full((B, Hkv, G * qc), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for j0 in range(0, Sk, k_chunk):
            kc = min(k_chunk, Sk - j0)
            s = (qb @ _kv_rows(k, j0, kc).transpose(-1, -2)) * scale
            mask = _visible(i0, qc, j0, kc, causal, q_offset, kv_len, q.device)
            if mask is not None:
                s = s.view(B, Hkv, G, qc, kc).masked_fill(~mask, NEG_INF).view(s.shape)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ _kv_rows(v, j0, kc)
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append((acc / l[..., None]).view(B, Hkv, G, qc, D))
        lses.append((m + torch.log(l)).view(B, Hkv, G, qc))
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype), torch.cat(lses, dim=3)


def chunked_attention(q, k, v, *, causal, q_offset=0, kv_len=None,
                      q_chunk: int = 1024, k_chunk: int = 1024):
    """Online-softmax attention for the prefill paths, which may carry
    offsets and lengths (training uses `flash_attention_jnp`)."""
    q_chunk = min(q_chunk, q.shape[1])
    k_chunk = min(k_chunk, k.shape[1])
    if q.shape[1] % q_chunk or k.shape[1] % k_chunk:
        return gqa_reference(q, k, v, causal, q_offset, kv_len)
    out, _ = _flash_fwd_math(q, k, v, causal, q_offset, kv_len, q_chunk, k_chunk)
    return out


# ---------------------------------------------------------- flash (train) --
def _flash_bwd_rule(causal, q_chunk, k_chunk, res, dout):
    """The reference's flash backward: a dq pass (over q blocks, each summing
    over k blocks) and a dk/dv pass (over k blocks, each summing over q
    blocks), every block's probabilities recomputed from the saved
    log-sum-exp.  At most one block pair's ``(B, Hkv, G*qc, kc)`` fp32
    scores and their gradient live at a time.  Block pairs wholly above the
    causal diagonal contribute exact zeros and are skipped."""
    q, k, v, out, lse = res
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    # D_i = sum_d dout * out, per query row: (B, Hkv, G, Sq).
    delta = (dout.float() * out.float()).sum(-1).view(B, Sq, Hkv, G).permute(0, 2, 3, 1)
    qs = [(i0, min(q_chunk, Sq - i0)) for i0 in range(0, Sq, q_chunk)]
    ks = [(j0, min(k_chunk, Sk - j0)) for j0 in range(0, Sk, k_chunk)]
    qb = [_q_rows(q, i0, qc, Hkv) for i0, qc in qs]
    dob = [_q_rows(dout, i0, qc, Hkv) for i0, qc in qs]
    lseb = [lse[..., i0:i0 + qc].reshape(B, Hkv, G * qc, 1) for i0, qc in qs]
    dlb = [delta[..., i0:i0 + qc].reshape(B, Hkv, G * qc, 1) for i0, qc in qs]
    kb = [_kv_rows(k, j0, kc) for j0, kc in ks]
    vb = [_kv_rows(v, j0, kc) for j0, kc in ks]

    def pairs(a, b):
        """(p, ds) of q block a against k block b, or None above the diagonal."""
        (i0, qc), (j0, kc) = qs[a], ks[b]
        if causal and j0 > i0 + qc - 1:
            return None
        s = torch.matmul(qb[a], kb[b].transpose(-1, -2)).mul_(scale)
        if causal:
            mask = _visible(i0, qc, j0, kc, True, 0, None, q.device)
            s.view(B, Hkv, G, qc, kc).masked_fill_(~mask, NEG_INF)
        p = s.sub_(lseb[a]).exp_()
        ds = (dob[a] @ vb[b].transpose(-1, -2)).sub_(dlb[a]).mul_(p)
        return p, ds

    # Pass 1 -- dq: for each q block, sum over the k blocks.
    dq = torch.empty_like(q)
    for a, (i0, qc) in enumerate(qs):
        acc = torch.zeros_like(qb[a])
        for b in range(len(ks)):
            pd = pairs(a, b)
            if pd is not None:
                acc += (pd[1] @ kb[b]) * scale
        dq[:, i0:i0 + qc] = acc.view(B, Hkv, G, qc, D).permute(0, 3, 1, 2, 4).reshape(
            B, qc, Hq, D)

    # Pass 2 -- dk/dv: for each k block, sum over the q blocks.
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b, (j0, kc) in enumerate(ks):
        dk_acc, dv_acc = torch.zeros_like(kb[b]), torch.zeros_like(vb[b])
        for a in range(len(qs)):
            pd = pairs(a, b)
            if pd is not None:
                p, ds = pd
                dv_acc += p.transpose(-1, -2) @ dob[a]
                dk_acc += (ds.transpose(-1, -2) @ qb[a]) * scale
        dk[:, j0:j0 + kc] = dk_acc.permute(0, 2, 1, 3)
        dv[:, j0:j0 + kc] = dv_acc.permute(0, 2, 1, 3)
    return dq, dk, dv


class FlashSaver:
    """The flash forwards' (out, lse) of one region that ``remat="dots"``
    checkpoints: kept from its forward (``active(replay=False)``) and
    handed back, in the same order, when the backward recomputes the region
    (``active(replay=True)``), so that the recomputation does not run the
    forward again, as `jax.checkpoint_policies.dots_saveable` keeps the
    reference's products.  ``computing`` is true while a recorded forward
    runs, so that the selective-checkpoint policy leaves that forward's own
    ops unsaved."""

    def __init__(self):
        self.saved: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.replay = False
        self.computing = False
        self.next = 0

    @contextlib.contextmanager
    def active(self, replay: bool):
        """Record (``replay`` False) or replay, for the length of the block."""
        global _SAVER
        before, _SAVER = _SAVER, self
        self.replay, self.next = replay, 0
        try:
            yield
        finally:
            _SAVER = before


#: The active `FlashSaver` (process-wide: the recomputation runs on
#: autograd's thread for a CUDA device), or None.
_SAVER: Optional[FlashSaver] = None


def flash_forward_computing() -> bool:
    """Whether a flash forward that a `FlashSaver` records is running."""
    return _SAVER is not None and _SAVER.computing


class _FlashAttention(torch.autograd.Function):
    """Forward: the CUDA `flash_attention` kernel for a CUDA tensor (its
    plain version under `kernels.ops.use_plain()`) and for a tensor on the
    ``meta`` device (where the kernel's wrapper runs its plain version, so
    that a traced program takes the card's route), `_flash_fwd_math` for a
    CPU tensor; both give (out, lse).  Under an active `FlashSaver` the
    forward's (out, lse) are recorded, or replayed in the recomputation.
    Backward: the `flash_attention_bwd` kernels for a CUDA tensor (and the
    card's route for a meta one), `_flash_bwd_rule` for a CPU tensor and
    under `kernels.ops.use_plain()`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, k_chunk):
        saver = _SAVER
        if saver is not None and saver.replay:
            out, lse = saver.saved[saver.next]
            saver.next += 1
        else:
            if saver is not None:
                saver.computing = True
            try:
                if q.is_cuda or q.is_meta:
                    from repro_torch.kernels import ops as kops
                    out, lse = kops.flash_attention(q.contiguous(), k.contiguous(),
                                                    v.contiguous(), causal)
                else:
                    out, lse = _flash_fwd_math(q, k, v, causal, 0, None, q_chunk, k_chunk)
            finally:
                if saver is not None:
                    saver.computing = False
            if saver is not None:
                saver.saved.append((out, lse))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.config = (causal, q_chunk, k_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import ops as kops
        causal, q_chunk, k_chunk = ctx.config
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:                  # the kernels take contiguous rows
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        dq, dk, dv = kops.flash_attention_bwd(q, k, v, out, lse, dout, causal, q_chunk, k_chunk)
        return dq, dk, dv, None, None, None


def flash_attention_jnp(q, k, v, causal: bool, q_chunk: int, k_chunk: int):
    """Flash attention with a flash *backward* (the reference's name): the
    backward recomputes each block's probabilities from the saved
    log-sum-exp instead of storing them."""
    return _FlashAttention.apply(q, k, v, causal, q_chunk, k_chunk)


#: Sequences at or above this length use the online-softmax path.
CHUNKED_ATTN_THRESHOLD = 2048
_Q_CHUNK = 1024
_K_CHUNK = 1024


def _self_attention_math(q, k, v, causal, q_offset=0, kv_len=None):
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq < CHUNKED_ATTN_THRESHOLD and Sk <= 2 * CHUNKED_ATTN_THRESHOLD:
        return gqa_reference(q, k, v, causal, q_offset, kv_len)
    qc, kc = min(_Q_CHUNK, Sq), min(_K_CHUNK, Sk)
    static_extras = isinstance(q_offset, int) and kv_len is None
    if static_extras and q_offset == 0 and Sq % qc == 0 and Sk % kc == 0:
        return flash_attention_jnp(q, k, v, causal, qc, kc)
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, q_chunk=qc, k_chunk=kc)


def _write_cache(cache_t: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """Write ``new`` (B,S,Hkv,Dh) into ``cache_t`` (B,L,Hkv,Dh) at sequence
    offset ``idx`` (0-d, or (B,) per row), in place.  The start is clamped to
    ``[0, L - S]`` exactly as `jax.lax.dynamic_update_slice` clamps it, so a
    row whose index has run past the end overwrites the last ``S`` entries."""
    B, S = new.shape[:2]
    start = idx.clamp(0, cache_t.shape[1] - S).long()
    steps = torch.arange(S, device=new.device)
    new = new.to(cache_t.dtype)
    if idx.ndim == 0:
        cache_t.index_copy_(1, start + steps, new)
    else:
        rows = torch.arange(B, device=new.device)[:, None]
        cache_t[rows, start[:, None] + steps[None, :]] = new


def attention(
    params: Dict,
    x: torch.Tensor,                      # (B, S, d)
    cfg: ModelConfig,
    positions: Optional[torch.Tensor],    # (B, S), or (3, B, S) under M-RoPE
    *,
    causal: bool = True,
    kv_input: Optional[torch.Tensor] = None,   # cross-attention memory (B, Sk, d)
    cache: Optional[Dict] = None,
    cache_index=None,                     # 0-d or (B,) int32 write offset
    impl: Optional[str] = None,
    rope_cache=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- or cross-attention with optional KV cache.

    Modes:
      * train/prefill: ``cache=None``, full-sequence causal, through
        `flash_attention_jnp` (on the card, the CUDA flash kernel forward).
      * decode / prefill-into-cache: ``cache`` + ``cache_index`` given: write
        this step's k/v at ``cache_index`` (in place) and attend over the
        valid prefix.  With S == 1 this is `kernels.ops.decode_attention`.
      * cross: ``kv_input`` given: k/v from the memory, no RoPE, no causal
        mask (`_self_attention_math`).

    ``impl`` / ``cfg.attn_impl`` are accepted for parity with the reference
    and not consulted: the kernel is chosen by the tensor's device.
    """
    B, S, _ = x.shape
    heads = local_heads(cfg)
    if heads.split:
        x = copy_to_tp(x)
        kv_input = None if kv_input is None else copy_to_tp(kv_input)
    kv_src = x if kv_input is None else kv_input
    q = project_q(params, x, cfg, heads)
    k, v = project_kv(params, kv_src, cfg, heads)
    if kv_input is None:  # RoPE only applies to self-attention
        q = _rope(cfg, q, positions, rope_cache)
        k = _rope(cfg, k, positions, rope_cache)

    new_cache = None
    if cache is not None:
        # Scatter this step's k/v at the write offset: a scalar in lockstep
        # decode, or per-row (B,) under continuous batching.
        idx = torch.as_tensor(cache_index, device=x.device)
        k_cache, v_cache = cache["k"], cache["v"]
        _write_cache(k_cache, k, idx)
        _write_cache(v_cache, v, idx)
        new_cache = {"k": k_cache, "v": v_cache}
        kv_len = idx + S
        if S == 1:
            from repro_torch.kernels import ops as kops
            out = kops.decode_attention(q, k_cache, v_cache, kv_len)
        else:
            # Prefill-into-cache: causal with absolute offset.
            out = _self_attention_math(q, k_cache, v_cache, causal=True,
                                       q_offset=idx, kv_len=kv_len)
    elif causal and kv_input is None:
        # Training / full-sequence: `flash_attention_jnp` on either device
        # (its forward is the CUDA kernel on the card), chunks of at most
        # _Q_CHUNK for the backward (a ragged last chunk is masked).
        chunk = min(_Q_CHUNK, S)
        out = flash_attention_jnp(q, k, v, True, chunk, chunk)
    else:
        out = _self_attention_math(q, k, v, causal=False)

    out = out.reshape(B, S, heads.n_q * cfg.d_head)
    return project_out(params, out, cfg, heads), new_cache


def prefill_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, max_len: int) -> Dict:
    """Extend prefill-computed k/v to a full-size cache (right-padded)."""
    pad = (0, 0, 0, 0, 0, max_len - k.shape[1])
    return {"k": torch.nn.functional.pad(k, pad), "v": torch.nn.functional.pad(v, pad)}
