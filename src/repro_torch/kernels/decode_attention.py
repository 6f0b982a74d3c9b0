"""Single-token decode attention: wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas kernel `repro.kernels.decode_attention
.decode_attention`.  Bound by bytes on an H100: the valid prefix of K and V
read once, ``2 * sum_b kv_len[b] * Hkv * D * itemsize`` over 3.35 TB/s.
The kernel reads the caches in their native ``(B, Sk, Hkv, D)`` layout (no
transposed copy), splits ``Sk`` over blocks so that ``B * Hkv`` small
problems still fill the card, and merges the splits' partial softmax states
in a second kernel.  The number of splits comes from the shapes alone, so a
row's result is the same whatever else is in the batch.  d_head 32, 64 and
128 run exact instances; any other multiple of the 16-byte vector up to
128 (zamba2-7b's 112) runs one padded to 128.

Plain version: `decode_attention_plain`, which is `gqa_reference` with the
prefix mask, and zeros where ``kv_len == 0`` (as both kernels give).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.attention import gqa_reference

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GROUP = 8
_SPLIT_ALIGN = 64      # keys; a split is a multiple of this
_MIN_SPLIT = 256       # keys; shorter splits are not worth a block
_MAX_SPLITS = 128
_WAVES = 4             # blocks aimed at, per SM


def _kv_len_rows(kv_len, batch: int, device) -> torch.Tensor:
    t = torch.as_tensor(kv_len, device=device)
    return t.to(torch.int32).reshape(-1).expand(batch).contiguous()


def decode_attention_plain(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """The same function in plain PyTorch (fp32 softmax)."""
    B, Sk = k_cache.shape[0], k_cache.shape[1]
    lens = _kv_len_rows(kv_len, B, q.device).clamp(0, Sk)
    out = gqa_reference(q, k_cache, v_cache, causal=False, kv_len=lens)
    return out.masked_fill((lens == 0)[:, None, None, None], 0)


def split_plan(batch: int, sk: int, n_kv_heads: int, n_sms: int = 132) -> Tuple[int, int]:
    """(keys per split, number of splits) for a cache of ``sk`` keys: enough
    blocks for `_WAVES` on each SM, from the shapes alone (never kv_len)."""
    want = -(-_WAVES * n_sms // (batch * n_kv_heads))
    most = max(1, sk // _MIN_SPLIT)
    n = max(1, min(want, most, _MAX_SPLITS))
    chunk = -(-sk // n)
    chunk = -(-chunk // _SPLIT_ALIGN) * _SPLIT_ALIGN
    return chunk, -(-sk // chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len) -> torch.Tensor:
    """q ``(B, 1, Hq, D)`` against caches ``(B, Sk, Hkv, D)``; ``kv_len`` the
    valid prefix, an int, 0-d or ``(B,)`` integer tensor (clamped to
    ``[0, Sk]``; 0 gives zeros).  Returns ``(B, 1, Hq, D)`` in q's type.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernels
    (on the current stream, without synchronising) or raises."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, not {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: q is {q.dtype}, caches are "
                        f"{k_cache.dtype} / {v_cache.dtype}")
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    B, _, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k_cache.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit caches "
                         f"{tuple(k_cache.shape)}")
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, kv_len)

    _build.check_head_dim("decode_attention", D, q.dtype)
    if Hq // Hkv > _MAX_GROUP:
        raise ValueError(f"decode_attention: group {Hq // Hkv} not supported "
                         f"(at most {_MAX_GROUP})")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("decode_attention: q and the caches lie on different devices")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and the caches must be contiguous")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: q and the caches must be 16-byte aligned")
    lens = _kv_len_rows(kv_len, B, q.device)
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, n_splits = split_plan(B, Sk, Hkv, n_sms)
    out = torch.empty_like(q)
    if n_splits > 1:
        G = Hq // Hkv
        part_ml = torch.empty((2, B, Hkv, n_splits, G), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((B, Hkv, n_splits, G, D), dtype=torch.float32, device=q.device)
        pm, pl, pa = part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr()
    else:
        pm = pl = pa = None
    with torch.cuda.device(q.device):
        code = _build.library().repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            out.data_ptr(), pm, pl, pa, B, Sk, Hq, Hkv, D, chunk, n_splits,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


#: Times the kernel was launched (never counts the plain version).
decode_attention.launches = 0
