"""Grouped-query self-attention with RoPE and a KV cache.

`gqa_reference` is the plain implementation (fp32 softmax).  Single-token
decode against the cache goes through `repro_torch.kernels.ops
.decode_attention`, which launches the hand-written CUDA kernel for a CUDA
tensor and runs the plain version for a CPU tensor.

The cache is written IN PLACE: `attention` returns the same ``k``/``v``
tensors it was given, updated (the reference returns fresh arrays).

Still to port from `repro.models.attention`: cross-attention
(``kv_input``), M-RoPE, `prefill_cache`, and the chunked / flash branch of
`_self_attention_math` (ROADMAP Queue 2 item 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import apply_linear, apply_rope, dtype_of, init_linear

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


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device="cuda") -> Dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _split_heads(x, n_heads, d_head):
    return x.reshape(*x.shape[:-1], n_heads, d_head)


def _rope(cfg: ModelConfig, x, positions, rope_cache=None):
    if rope_cache is not None:
        raise NotImplementedError("hoisted RoPE tables: ROADMAP Queue 1 item 2")
    if positions is None:
        return x
    if cfg.mrope:
        raise NotImplementedError("M-RoPE: ROADMAP Queue 1 item 13")
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


#: Sequences at or above this length need the online-softmax path.
CHUNKED_ATTN_THRESHOLD = 2048


def _self_attention_math(q, k, v, causal, q_offset=0, kv_len=None):
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq < CHUNKED_ATTN_THRESHOLD and Sk <= 2 * CHUNKED_ATTN_THRESHOLD:
        return gqa_reference(q, k, v, causal, q_offset, kv_len)
    raise NotImplementedError(
        f"attention over Sq={Sq}, Sk={Sk} needs the chunked / flash path, "
        "which is still to port (ROADMAP Queue 2 item 3: flash_attention)")


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
    positions: Optional[torch.Tensor],    # (B, S)
    *,
    causal: bool = True,
    kv_input: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
    cache_index=None,                     # 0-d or (B,) int32 write offset
    impl: Optional[str] = None,
    rope_cache=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention with optional KV cache.

    Modes:
      * train/prefill: ``cache=None``, full-sequence causal.
      * decode / prefill-into-cache: ``cache`` + ``cache_index`` given: write
        this step's k/v at ``cache_index`` (in place) and attend over the
        valid prefix.  With S == 1 this is `kernels.ops.decode_attention`.

    ``impl`` / ``cfg.attn_impl`` are accepted for parity with the reference
    and not consulted: the kernel is chosen by the tensor's device.
    """
    if kv_input is not None:
        raise NotImplementedError("cross-attention: ROADMAP Queue 1 item 13")
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    q = _split_heads(apply_linear(params["wq"], x, cd), cfg.n_heads, cfg.d_head)
    k = _split_heads(apply_linear(params["wk"], x, cd), cfg.n_kv_heads, cfg.d_head)
    v = _split_heads(apply_linear(params["wv"], x, cd), cfg.n_kv_heads, cfg.d_head)
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
    else:
        out = _self_attention_math(q, k, v, causal=causal)

    out = out.reshape(B, S, cfg.n_heads * cfg.d_head)
    return apply_linear(params["wo"], out, cd), new_cache
