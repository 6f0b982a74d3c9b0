"""Decoder-LM assembly for all ten architecture families.

Layer stacks are grouped into their minimal repeating *period*; the params
and caches of the period's layers carry a leading ``(n_full,)`` axis, as in
`repro.models.transformer`, so converted weights and per-slot cache slices
(``x[:, slot]``) carry over leaf for leaf.  Where the reference scans that
axis with `jax.lax.scan`, `forward` runs a Python loop over it.

The families: stacks of attention + FFN blocks (the dense family: granite,
qwen1.5, nemotron), of attention + MoE-FFN blocks (dbrx, kimi-k2; their
aux losses summed over the layers), of Mamba2 mixers with zamba2's
weight-shared attention block, applied at the start of each period of
``shared_attn_every`` layers and before each tail layer whose index is a
multiple of it (its KV caches are per depth: ``shared`` stacked over the
periods, ``tail_shared`` a list), of xLSTM's mLSTM and sLSTM mixers
(xlstm-1.3b: periods of 7 mLSTM and 1 sLSTM), the encoder-decoder
(seamless: a bidirectional encoder, `encode`, over stub frame embeddings,
and a cross-attention in every decoder block, whose projected memory a
cache holds as ``cross``) and the VLM (qwen2-vl: a stub patch-embedding
prefix and M-RoPE's (3, B, S) position ids).  ``remat="block"``
recomputes each period in the backward; ``remat="dots"`` keeps the
period's matrix products and flash forwards and recomputes the rest
(`_checkpoint`).

`forward` covers full-sequence and cached (prefill-into-cache, decode) runs
via the optional cache, and runs under autograd when grad is enabled (the
serving steps turn it off); `lm_loss` is the training loss.  The cache's K
and V (the cross-attention's too), conv windows and SSM and xLSTM states
are updated IN PLACE.  Each stacked parameter leaf is unbound once a
forward (`torch.unbind`, whose backward stacks the layers' gradients in
one allocation) instead of being indexed layer by layer.

Under a sharded train step or serving step the parameters are DTensors:
each block's are gathered over the data-parallel mesh dims where the
block runs (`parallel.context.gather_params`), inside each remat'd
period, so that one period's parameters are gathered at a time; outside a
sharding context the gather returns its input.  Each rank keeps its shard
along the tensor-parallel axis ("model") and computes its own share of
the step: its attention heads (`attention`), FFN columns (`ffn`) and
experts (`moe_ffn`), the heads of its Mamba2 and xLSTM mixers
(`mamba2_block`, `mlstm_block`, `slstm_block`) and, where the axis divides
the vocabulary, its vocab slice of the lookup, the logits and the loss
(`lm_loss`'s vocab-parallel cross-entropy).  The block norms every rank
along the axis computes alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .._tree import tree_map, tree_stack
from ..parallel.context import (
    copy_to_tp,
    gather_params,
    max_over_tp,
    reduce_from_tp,
    tp_part,
    tp_whole,
)
from .attention import (
    FlashSaver,
    _self_attention_math,
    attention,
    flash_forward_computing,
    init_attention,
    heads_of,
    init_kv_cache,
    local_heads,
    project_kv,
    project_out,
    project_q,
)
from .config import BLOCK_ATTN, BLOCK_MAMBA2, BLOCK_MLSTM, BLOCK_MOE, BLOCK_SLSTM, ModelConfig
from .ffn import ffn, init_ffn
from .layers import (
    apply_linear,
    bf16_cotangent_barrier,
    dtype_of,
    embed,
    fused_rms_norm,
    init_embedding,
    init_linear,
    init_rmsnorm,
    positions_for,
    rope_tables,
    unembed,
    vocab_part,
)
from .moe import init_moe, moe_ffn
from .ssm import cache_spans as ssm_cache_spans
from .ssm import init_mamba2, init_ssm_cache, mamba2_block
from .xlstm import (
    init_mlstm,
    init_mlstm_cache,
    init_slstm,
    init_slstm_cache,
    mlstm_block,
    mlstm_cache_spans,
    slstm_block,
    slstm_cache_spans,
)


# ---------------------------------------------------------------- layout --
@dataclasses.dataclass(frozen=True)
class StackLayout:
    kinds: Tuple[str, ...]       # full layer pattern
    period: int
    n_full: int                  # stacked periods
    tail: Tuple[str, ...]        # unstacked remainder kinds
    shared_attn: bool

    @property
    def period_kinds(self) -> Tuple[str, ...]:
        return self.kinds[: self.period]


def _minimal_period(pattern: Tuple[str, ...]) -> int:
    for p in range(1, len(pattern) + 1):
        if all(pattern[i] == pattern[i % p] for i in range(len(pattern))):
            return p
    return len(pattern)


def stack_layout(cfg: ModelConfig) -> StackLayout:
    pattern = cfg.layer_pattern()
    p = _minimal_period(pattern)
    if cfg.shared_attn_every:
        p = max(p, cfg.shared_attn_every)
    if not cfg.scan_layers:
        p = len(pattern)
    n_full = len(pattern) // p
    tail = pattern[n_full * p:]
    return StackLayout(pattern, p, n_full, tail, bool(cfg.shared_attn_every))


# Each mixer kind: its init, its cache's init and its block.
_MIXERS = {
    BLOCK_MAMBA2: (init_mamba2, init_ssm_cache, mamba2_block),
    BLOCK_MLSTM: (init_mlstm, init_mlstm_cache, mlstm_block),
    BLOCK_SLSTM: (init_slstm, init_slstm_cache, slstm_block),
}


# ------------------------------------------------------------------ init --
def _init_attn_block(generator, cfg: ModelConfig, dtype, device, moe: bool = False,
                     cross: bool = False) -> Dict:
    """An attention block; its FFN is ``moe`` (router and stacked experts)
    for the MoE kind, else ``ffn``; with ``cross``, also the decoder's
    ``norm_cross`` and cross-attention ``cross``."""
    d = cfg.d_model
    p = {
        "norm1": init_rmsnorm(d, dtype, device),
        "attn": init_attention(generator, cfg, dtype, device=device),
        "norm2": init_rmsnorm(d, dtype, device),
    }
    if moe:
        p["moe"] = init_moe(generator, cfg, dtype, device=device)
    else:
        p["ffn"] = init_ffn(generator, cfg, dtype, device=device)
    if cross:
        p["norm_cross"] = init_rmsnorm(d, dtype, device)
        p["cross"] = init_attention(generator, cfg, dtype, cross=True, device=device)
    return p


def init_block(generator, cfg: ModelConfig, kind: str, dtype, cross: bool = False,
               device=None) -> Dict:
    device = generator.device if device is None else device
    if kind in _MIXERS:
        return {"norm1": init_rmsnorm(cfg.d_model, dtype, device),
                "mixer": _MIXERS[kind][0](generator, cfg, dtype, device=device)}
    if kind in (BLOCK_ATTN, BLOCK_MOE):
        return _init_attn_block(generator, cfg, dtype, device, moe=kind == BLOCK_MOE,
                                cross=cross)
    raise ValueError(kind)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     cross_len: int = 0, device="cuda") -> Dict:
    if kind in _MIXERS:
        return {"mixer": _MIXERS[kind][1](cfg, batch, device)}
    if kind in (BLOCK_ATTN, BLOCK_MOE):
        cd = dtype_of(cfg.compute_dtype)
        c = {"attn": init_kv_cache(cfg, batch, max_len, cd, device)}
        if cross_len:
            c["cross"] = init_kv_cache(cfg, batch, cross_len, cd, device)
        return c
    raise ValueError(kind)


_CACHE_SPANS = {BLOCK_MAMBA2: ssm_cache_spans, BLOCK_MLSTM: mlstm_cache_spans,
                BLOCK_SLSTM: slstm_cache_spans}


def block_cache_spans(cfg: ModelConfig, kind: str, rank: int, n: int) -> Dict:
    """Where rank ``rank`` of a tensor-parallel axis of ``n`` ranks holds
    its part of a ``kind`` block's cache: for each leaf that a split cuts
    (by `ssm.cache_spans`'s convention; the K/V of the rank's kv heads,
    which ranks sharing a kv head hold alike), (dim from the end, whole
    size, spans); an empty dict where the rank holds the whole cache."""
    if kind in _CACHE_SPANS:
        spans = _CACHE_SPANS[kind](cfg, rank, n) if n > 1 else None
        return {} if spans is None else {"mixer": spans}
    heads = heads_of(cfg, rank, n)
    if not heads.split:
        return {}
    kv = (-2, cfg.n_kv_heads, [(heads.kv0, heads.kv0 + heads.n_kv)])
    return {"attn": {"k": kv, "v": kv}, "cross": {"k": kv, "v": kv}}


def init_lm(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict:
    """Full parameter tree.  Stacked period params carry a leading
    (n_full,) axis; tail layers and the shared attention block are
    unstacked; an encoder-decoder's ``encoder`` holds its blocks stacked
    over its ``n_encoder_layers`` and its final norm.  ``device`` defaults
    to the generator's."""
    dtype = dtype_of(cfg.param_dtype)
    layout = stack_layout(cfg)
    device = generator.device if device is None else torch.device(device)
    cross = cfg.n_encoder_layers > 0
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype, device)}
    blocks = {}
    for j, kind in enumerate(layout.period_kinds):
        blocks[f"pos{j}"] = tree_stack(
            layout.n_full, lambda: init_block(generator, cfg, kind, dtype, cross, device))
    params["blocks"] = blocks
    params["tail"] = [init_block(generator, cfg, kind, dtype, cross, device)
                      for kind in layout.tail]
    if layout.shared_attn:
        params["shared_attn"] = _init_attn_block(generator, cfg, dtype, device)
    if cross:
        params["encoder"] = {
            "blocks": tree_stack(cfg.n_encoder_layers,
                                 lambda: _init_attn_block(generator, cfg, dtype, device)),
            "final_norm": init_rmsnorm(cfg.d_model, dtype, device)}
    params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["unembed"] = init_linear(generator, cfg.d_model, cfg.vocab_size,
                                        dtype, device=device)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, cross_len: int = 0,
               per_slot_index: bool = False, device="cuda") -> Dict:
    layout = stack_layout(cfg)
    idx = torch.zeros((batch,) if per_slot_index else (), dtype=torch.int32,
                      device=device)
    cache: Dict[str, Any] = {"blocks": {}, "tail": [], "index": idx}
    for j, kind in enumerate(layout.period_kinds):
        cache["blocks"][f"pos{j}"] = tree_stack(
            layout.n_full, lambda: init_block_cache(cfg, kind, batch, max_len, cross_len, device))
    cache["tail"] = [init_block_cache(cfg, kind, batch, max_len, cross_len, device)
                     for kind in layout.tail]
    if layout.shared_attn:
        cache["shared"] = tree_stack(
            layout.n_full, lambda: init_block_cache(cfg, BLOCK_ATTN, batch, max_len, device=device))
        cache["tail_shared"] = [init_block_cache(cfg, BLOCK_ATTN, batch, max_len, device=device)
                                for _ in range(len(_tail_shared_at(cfg, layout)))]
    return cache


def _tail_shared_at(cfg: ModelConfig, layout: StackLayout) -> List[int]:
    """The tail positions that the shared block runs before: those whose
    layer index is a multiple of ``shared_attn_every``."""
    if not layout.shared_attn:
        return []
    return [t for t in range(len(layout.tail))
            if (layout.n_full * layout.period + t) % cfg.shared_attn_every == 0]


def reset_slot(cache: Dict, slot) -> Dict:
    """Zero one batch slot across the whole cache, IN PLACE, and return the
    cache (continuous batching: recurrent SSM states carry no positional
    mask, so a freed slot is wiped before a new request is admitted; the
    index must be per-slot).  A decoder block's cross K/V lie under
    ``blocks`` / ``tail`` and are zeroed with them."""
    cache["index"][slot] = 0
    tree_map(lambda x: x[:, slot].zero_(), cache["blocks"])
    tree_map(lambda x: x[slot].zero_(), cache["tail"])
    if "shared" in cache:
        tree_map(lambda x: x[:, slot].zero_(), cache["shared"])
    if "tail_shared" in cache:
        tree_map(lambda x: x[slot].zero_(), cache["tail_shared"])
    return cache


# --------------------------------------------------------------- forward --
def _bar(x, cfg):
    return bf16_cotangent_barrier(x) if cfg.bf16_cotangent else x


def _cross_memory(bp, cfg, cache, encoder_out, heads):
    """The cross-attention's K and V of this rank's kv heads, (B, S_enc,
    n_kv, Dh): projected from ``encoder_out`` (training, prefill) and, with
    a cache, written into its ``cross`` in place; else read back from the
    cache (decode)."""
    if encoder_out is None:
        if cache is None or "cross" not in cache:
            raise ValueError("decode without encoder_out needs a cross cache")
        return cache["cross"]["k"], cache["cross"]["v"]
    if heads.split:
        encoder_out = copy_to_tp(encoder_out)
    ck, cv = project_kv(bp["cross"], encoder_out, cfg, heads)
    if cache is not None:
        cross_len = cache["cross"]["k"].shape[1] if "cross" in cache else 0
        if cross_len != ck.shape[1]:
            raise ValueError(f"the cache's cross_len {cross_len} differs from the "
                             f"encoder's length {ck.shape[1]}")
        cache["cross"]["k"].copy_(ck)
        cache["cross"]["v"].copy_(cv)
    return ck, cv


def _attn_block(bp, x, cfg, positions, cache, index, encoder_out, kind,
                rope_cache=None):
    h = _bar(fused_rms_norm(x, bp["norm1"]["scale"], cfg.norm_eps), cfg)
    a, attn_cache = attention(
        bp["attn"], h, cfg, positions, causal=True,
        cache=None if cache is None else cache["attn"],
        cache_index=None if cache is None else index,
        rope_cache=rope_cache,
    )
    x = x + a
    new_cache = None if cache is None else dict(cache, attn=attn_cache)
    if "cross" in bp:
        heads = local_heads(cfg)
        hc = _bar(fused_rms_norm(x, bp["norm_cross"]["scale"], cfg.norm_eps), cfg)
        ck, cv = _cross_memory(bp, cfg, cache, encoder_out, heads)
        q = project_q(bp["cross"], copy_to_tp(hc) if heads.split else hc, cfg, heads)
        o = _self_attention_math(q, ck, cv, causal=False)
        x = x + project_out(bp["cross"], o.reshape(*hc.shape[:-1], -1), cfg, heads)
    h2 = _bar(fused_rms_norm(x, bp["norm2"]["scale"], cfg.norm_eps), cfg)
    if kind == BLOCK_MOE:
        f, aux, _ = moe_ffn(bp["moe"], h2, cfg)
        return x + f, new_cache, aux
    return x + ffn(bp["ffn"], h2, cfg), new_cache, None


def _add(total, aux):
    """``total + aux``, where None stands for no aux loss (every kind but
    MoE)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def apply_block(kind, bp, x, cfg, *, positions, cache, index, encoder_out=None,
                rope_cache=None):
    """One layer: an attention + FFN or MoE-FFN block (zamba2's shared
    block too, with its own per-depth KV cache; an encoder-decoder's
    decoder block with its cross-attention over ``encoder_out`` or the
    cache's ``cross``), or a mixer block (Mamba2, mLSTM, sLSTM): ``norm1``,
    the mixer, the residual add.  Returns (x, aux loss or None).  The
    cache, if any, is updated in place."""
    if kind in (BLOCK_ATTN, BLOCK_MOE):
        x, _, aux = _attn_block(bp, x, cfg, positions, cache, index, encoder_out, kind,
                                rope_cache)
        return x, aux
    h = _bar(fused_rms_norm(x, bp["norm1"]["scale"], cfg.norm_eps), cfg)
    m, _ = _MIXERS[kind][2](bp["mixer"], h, cfg, None if cache is None else cache["mixer"])
    return x + m, None


def _period(x, bp, shared, cfg, kinds, positions, cslice, shared_cache, index,
            encoder_out=None, rope_cache=None):
    """One period of the stack (the reference's scanned ``period_fn``): the
    shared attention block first, when the stack has one, then the
    period's layers.  Returns (x, the layers' aux loss or None)."""
    if cfg.bf16_cotangent:
        x = bf16_cotangent_barrier(x)
    bp, shared = gather_params(bp), gather_params(shared)
    if shared is not None:
        x, _ = apply_block(BLOCK_ATTN, shared, x, cfg, positions=positions,
                           cache=shared_cache, index=index, rope_cache=rope_cache)
    aux = None
    for j, kind in enumerate(kinds):
        cj = None if cslice is None else cslice[f"pos{j}"]
        x, a = apply_block(kind, bp[f"pos{j}"], x, cfg, positions=positions, cache=cj,
                           index=index, encoder_out=encoder_out, rope_cache=rope_cache)
        aux = _add(aux, a)
    return x, aux


def _unstack(tree, n: int) -> List[Any]:
    """A tree of stacked ``(n, ...)`` leaves as n trees of per-layer views,
    each leaf unbound once."""
    parts = []

    def unbind(t):
        parts.append(t.unbind(0))
        return len(parts) - 1

    where = tree_map(unbind, tree)
    return [tree_map(lambda k: parts[k][i], where) for i in range(n)]


_aten = torch.ops.aten
#: The matrix products that ``remat="dots"`` keeps (`dots_saveable`'s
#: dot_generals).
_DOTS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm)
REMATS = ("none", "block", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep a matrix product's output, recompute everything else; a flash
    forward is kept whole by its `FlashSaver`, so its own ops are not."""
    if getattr(op, "_overloadpacket", None) in _DOTS and not flash_forward_computing():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _dots_contexts():
    """The forward's and the recomputation's contexts of one ``"dots"``
    region: the selective-checkpoint caches of its products, and a
    `FlashSaver` for its flash forwards."""
    saver = FlashSaver()
    forward_ctx, recompute_ctx = create_selective_checkpoint_contexts(_dots_policy)
    return (_both(forward_ctx, saver.active(replay=False)),
            _both(recompute_ctx, saver.active(replay=True)))


def _checkpoint(cfg: ModelConfig):
    """How a remat'd region runs: None where nothing is recomputed (``remat
    ="none"``, or no gradient is taken), else `torch.utils.checkpoint`,
    recomputing the region whole (``"block"``) or all but its matrix
    products and flash forwards (``"dots"``, the reference's
    `jax.checkpoint_policies.dots_saveable`)."""
    if cfg.remat not in REMATS:
        raise ValueError(f"remat={cfg.remat!r}: one of {REMATS}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return None
    if cfg.remat == "block":
        return functools.partial(checkpoint, use_reentrant=False)
    return functools.partial(checkpoint, use_reentrant=False, context_fn=_dots_contexts)


def forward(
    params: Dict,
    tokens: Optional[torch.Tensor],       # (B, S) int; None if embeds given
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
    encoder_out: Optional[torch.Tensor] = None,
    vision_embeds: Optional[torch.Tensor] = None,  # (B, P, d) prefix stub
    input_embeds: Optional[torch.Tensor] = None,   # bypass the embedding
    decoding: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (hidden (B,S,d) -- NOT logits; see `logits_fn` --, new_cache,
    aux_loss).  Runs under autograd when grad is enabled.

    ``vision_embeds`` is put before the token embeddings (S counts it);
    ``encoder_out`` is an encoder-decoder's memory (`encode`), which a cache
    with a cross part takes in (prefill); without it the decoder blocks
    read the cache's (decode).  ``new_cache`` shares its K/V, conv-window
    and SSM-state tensors with ``cache``: they are written in place; only
    ``index`` is a new tensor.  ``remat="block"`` checkpoints each period
    (`torch.utils.checkpoint`, recomputed in the backward) and
    ``bf16_cotangent`` places the reference's barriers; both shape the
    backward only.  ``hoist_rope`` computes the RoPE tables once a forward.
    ``psum_barrier`` is accepted and ignored (it shapes the reference's
    compiled tensor-parallel program).  ``remat="dots"`` checkpoints each
    period keeping its matrix products and flash forwards (`_checkpoint`).
    """
    remat = _checkpoint(cfg)
    cd = dtype_of(cfg.compute_dtype)
    layout = stack_layout(cfg)
    if input_embeds is not None:
        x = input_embeds.to(cd)
    else:
        x = embed(gather_params(params["embed"]), tokens, cd, cfg.vocab_size)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(cd), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        offset = cache["index"] if cache is not None else 0
        positions = positions_for(cfg, B, S, offset, device=x.device)
    index = cache["index"] if cache is not None else None
    rope_cache = rope_tables(cfg, positions) if cfg.hoist_rope else None

    aux = None
    shared = params.get("shared_attn") if layout.shared_attn else None
    layers = _unstack(params["blocks"], layout.n_full)
    for i, bp in enumerate(layers):
        cslice = sc = None
        if cache is not None:
            cslice = tree_map(lambda t: t[i], cache["blocks"])
            if shared is not None:
                sc = tree_map(lambda t: t[i], cache["shared"])
        args = (x, bp, shared, cfg, layout.period_kinds, positions, cslice, sc, index,
                encoder_out, rope_cache)
        x, a = remat(_period, *args) if remat else _period(*args)
        aux = _add(aux, a)
    shared_at = _tail_shared_at(cfg, layout)
    if layout.tail:
        shared = gather_params(shared)
    for t, kind in enumerate(layout.tail):
        if t in shared_at:
            # The reference applies the tail's shared blocks without the
            # hoisted tables (RoPE from the positions).
            sc = None if cache is None else cache["tail_shared"][shared_at.index(t)]
            x, _ = apply_block(BLOCK_ATTN, shared, x, cfg, positions=positions, cache=sc,
                               index=index)
        cj = None if cache is None else cache["tail"][t]
        x, a = apply_block(kind, gather_params(params["tail"][t]), x, cfg, positions=positions,
                           cache=cj, index=index, encoder_out=encoder_out,
                           rope_cache=rope_cache)
        aux = _add(aux, a)

    x = _bar(x, cfg)
    x = fused_rms_norm(x, gather_params(params["final_norm"])["scale"], cfg.norm_eps)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache, index=cache["index"] + S)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, new_cache, aux


def _head_logits(params: Dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits of this rank's vocab slice (`layers.vocab_part`; all of
    them where the vocabulary is whole on every rank)."""
    if cfg.tie_embeddings:
        return unembed(params["embed"], hidden, dtype_of(cfg.logit_dtype), cfg.vocab_size)
    p, part = params["unembed"], vocab_part(cfg.vocab_size)
    if part is not None:
        lo, hi = part[0], part[0] + part[1]
        p = {k: tp_part(v, -1, cfg.vocab_size, lo, hi) for k, v in p.items()}
        hidden = copy_to_tp(hidden)
    return apply_linear(p, hidden, dtype_of(cfg.logit_dtype))


def logits_fn(params: Dict, hidden: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits over the whole vocabulary (a vocab-parallel head's slices
    gathered over the tensor-parallel axis)."""
    return tp_whole(_head_logits(params, hidden, cfg), -1, cfg.vocab_size)


def _cross_entropy(lg: torch.Tensor, targets: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The sum over the positions of -log softmax(logits)[target], from
    ``lg``, this rank's vocab slice of the logits: where the vocabulary
    splits, the maximum and the sum of exponentials are reduced over the
    tensor-parallel axis and the gold logit comes from the rank that
    holds it."""
    part = vocab_part(cfg.vocab_size)
    if part is None:
        gold = torch.gather(lg, -1, targets[..., None])[..., 0]
        return (torch.logsumexp(lg, dim=-1) - gold).sum()
    lo, v = part
    m = max_over_tp(lg.amax(-1))
    total = reduce_from_tp(torch.exp(lg - m[..., None]).sum(-1))
    ids = targets - lo
    inside = (ids >= 0) & (ids < v)
    gold = torch.gather(lg, -1, ids.clamp(0, v - 1)[..., None])[..., 0]
    gold = reduce_from_tp(torch.where(inside, gold, torch.zeros((), dtype=gold.dtype,
                                                                 device=gold.device)))
    return (torch.log(total) + m - gold).sum()


# --------------------------------------------------------------- encoder --
def _encoder_block(x, block, cfg, positions):
    """One bidirectional encoder block (the reference's scanned ``body``)."""
    block = gather_params(block)
    h = fused_rms_norm(x, block["norm1"]["scale"], cfg.norm_eps)
    a, _ = attention(block["attn"], h, cfg, positions, causal=False)
    x = x + a
    h2 = fused_rms_norm(x, block["norm2"]["scale"], cfg.norm_eps)
    return x + ffn(block["ffn"], h2, cfg)


def encode(params: Dict, input_embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional encoder over stub frontend embeddings (B, S_enc, d):
    a loop over the stacked encoder blocks, each checkpointed as ``remat``
    says (`_checkpoint`) when grad is on, then the encoder's final norm."""
    remat = _checkpoint(cfg)
    x = input_embeds.to(dtype_of(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    for block in _unstack(params["encoder"]["blocks"], cfg.n_encoder_layers):
        args = (x, block, cfg, positions)
        x = remat(_encoder_block, *args) if remat else _encoder_block(*args)
    return fused_rms_norm(x, gather_params(params["encoder"]["final_norm"])["scale"],
                          cfg.norm_eps)


# ------------------------------------------------------------------ loss --
def lm_loss(
    params: Dict,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    loss_chunk: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE.  batch: inputs/targets (B,S) [+ encoder_embeds /
    vision_embeds / positions]; with a vision prefix the loss runs over the
    text suffix.  ``loss_chunk`` bounds the logits materialised at once to
    (B, chunk, V) (its vocab slice, on a rank of a vocab-parallel head)."""
    encoder_out = None
    if cfg.n_encoder_layers:
        encoder_out = encode(params, batch["encoder_embeds"], cfg)
    # The head is gathered once: a tied embedding serves the lookup too.
    key = "embed" if cfg.tie_embeddings else "unembed"
    head = gather_params({key: params[key]})
    hidden, _, aux = forward(dict(params, **head) if cfg.tie_embeddings else params,
                             batch["inputs"], cfg,
                             positions=batch.get("positions"),
                             encoder_out=encoder_out,
                             vision_embeds=batch.get("vision_embeds"))
    targets = batch["targets"].long()
    if hidden.shape[1] != targets.shape[1]:
        hidden = hidden[:, hidden.shape[1] - targets.shape[1]:]

    def ce(h_chunk, t_chunk):
        return _cross_entropy(_head_logits(head, h_chunk, cfg), t_chunk, cfg)

    B, S, _ = hidden.shape
    if loss_chunk and S % loss_chunk == 0 and S > loss_chunk:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(0, S, loss_chunk):
            total = total + ce(hidden[:, c:c + loss_chunk], targets[:, c:c + loss_chunk])
    else:
        total = ce(hidden, targets)
    ce_mean = total / float(B * S)
    loss = ce_mean + aux
    return loss, {"loss": loss, "ce": ce_mean, "aux": aux}


# ---------------------------------------------------------------- module --
class _Tree(nn.Module):
    """One level of the parameter tree: dict keys (or list positions) become
    child modules or frozen parameters, so `state_dict()` keys are the
    dotted leaf paths."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        items = enumerate(tree) if self._is_list else tree.items()
        for k, v in items:
            if isinstance(v, (dict, list, tuple)):
                self.add_module(str(k), _Tree(v))
            else:
                self.register_parameter(str(k), nn.Parameter(v, requires_grad=False))

    def as_tree(self):
        out = {k: m.as_tree() for k, m in self._modules.items()}
        out.update({k: p.data for k, p in self._parameters.items()})
        if self._is_list:
            return [out[str(i)] for i in range(len(out))]
        return out


class DecoderLM(_Tree):
    """Thin module around the functional model: registers the parameter
    tree (``.to(device)``, ``state_dict()`` keyed by the reference's leaf
    paths) and forwards to `forward` / `logits_fn`."""

    def __init__(self, cfg: ModelConfig, params: Optional[Dict] = None, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        if params is None:
            if generator is None:
                generator = torch.Generator(device).manual_seed(0)
            params = init_lm(generator, cfg, device=device)
        super().__init__(params)
        self.cfg = cfg

    @property
    def params(self) -> Dict:
        """The nested dict of tensors that the functional API takes."""
        return self.as_tree()

    def forward(self, tokens, cache=None, positions=None):
        hidden, cache, _ = forward(self.params, tokens, self.cfg,
                                   positions=positions, cache=cache)
        return hidden, cache

    def logits(self, hidden):
        return logits_fn(self.params, hidden, self.cfg)
