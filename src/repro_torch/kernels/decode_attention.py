"""Single-token decode attention: wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas kernel `repro.kernels.decode_attention
.decode_attention`.  Bound by bytes on an H100: the valid prefix of K and V
read once, ``2 * sum_b kv_len[b] * Hkv * D * itemsize`` over 3.35 TB/s.
The kernels read the caches in their native ``(B, Sk, Hkv, D)`` layout (no
transposed copy) and split ``Sk`` over blocks so that ``B * Hkv`` small
problems still fill the card; in the same launch the last block of a row
to finish merges the splits' partial softmax states, in split order,
counted on a counter of the stream's (`_stream_counters`).  The number of
splits comes from the shapes alone, so a row's result is the same whatever
else is in the batch.  bf16 groups of `_TC_MIN_GROUP` or more query heads
a kv head run on the tensor cores (``decode_bf16_tc_kernel``); fp32, and
bf16 groups of one or two, run the SIMT ``decode_partial_kernel``.  The
choice is made here and passed to the launcher, which refuses a choice it
has no instance for.  d_head 32, 64 and 128 run exact instances;
any other multiple of the 16-byte vector up to 128 (zamba2-7b's and
kimi-k2's 112) runs one padded to 128.

Plain version: `decode_attention_plain`, which is `gqa_reference` with the
prefix mask, and zeros where ``kv_len == 0`` (as both kernels give).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.models.attention import gqa_reference

from . import _build
from .scope import kernel_scope

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GROUP = 8
_TC_MIN_GROUP = 3      # bf16 groups this large run on the tensor cores
_SPLIT_ALIGN = 64      # keys; a split is a multiple of this
_MIN_SPLIT = 256       # keys; shorter splits are not worth a block
_MAX_SPLITS = 64       # the launcher refuses more (kMaxSplits in the .cu)
_WAVES = 4             # SIMT instances: blocks aimed at, per SM
_TC_BLOCKS_PER_SM = 2  # tensor-core instance: blocks aimed at, per SM (one wave at D 128)


def _kv_len_rows(kv_len, batch: int, device) -> torch.Tensor:
    t = torch.as_tensor(kv_len, device=device)
    return t.to(torch.int32).reshape(-1).expand(batch).contiguous()


def decode_attention_plain(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """The same function in plain PyTorch (fp32 softmax)."""
    B, Sk = k_cache.shape[0], k_cache.shape[1]
    lens = _kv_len_rows(kv_len, B, q.device).clamp(0, Sk)
    out = gqa_reference(q, k_cache, v_cache, causal=False, kv_len=lens)
    return out.masked_fill((lens == 0)[:, None, None, None], 0)


@functools.lru_cache(maxsize=None)
def split_plan(batch: int, sk: int, n_kv_heads: int, n_sms: int = 132,
               tensor_cores: bool = False) -> Tuple[int, int]:
    """(keys per split, number of splits) for a cache of ``sk`` keys, from
    the shapes alone (never kv_len).  The SIMT instances: enough blocks for
    `_WAVES` on each SM.  The tensor-core instance: at most one wave of
    `_TC_BLOCKS_PER_SM` blocks an SM; on an H100 a second wave cost more
    than it hid (PERF.md)."""
    pairs = batch * n_kv_heads
    want = _TC_BLOCKS_PER_SM * n_sms // pairs if tensor_cores else -(-_WAVES * n_sms // pairs)
    most = max(1, sk // _MIN_SPLIT)
    n = max(1, min(want, most, _MAX_SPLITS))
    chunk = -(-sk // n)
    chunk = -(-chunk // _SPLIT_ALIGN) * _SPLIT_ALIGN
    return chunk, -(-sk // chunk)


def _on_tensor_cores(dtype: torch.dtype, group: int) -> bool:
    return dtype == torch.bfloat16 and group >= _TC_MIN_GROUP


def kernel_instance(dtype: torch.dtype, group: int, d_head: int) -> str:
    """The kernel instance a CUDA call with these types and shapes launches,
    named as the build lists it (``_build.kernel_resources``)."""
    width = d_head if d_head in (32, 64, 128) else 128
    pad = "false" if width == d_head else "true"
    if _on_tensor_cores(dtype, group):
        return f"decode_bf16_tc_kernel<{width}, {pad}>"
    gmax = group if group <= 2 else (4 if group <= 4 else 8)
    elem = "__nv_bfloat16" if dtype == torch.bfloat16 else "float"
    return f"decode_partial_kernel<{elem}, {width}, {gmax}, {pad}>"


#: (device index, stream) -> int32 counters, one a (b, kv head): zero when
#: made, and every launch leaves them zero; launches on one stream are
#: ordered, so no two share them at once.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _stream_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _COUNTERS.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[(device.index, stream)] = torch.zeros(n, dtype=torch.int32,
                                                              device=device)
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launch_plan(B: int, Sk: int, Hq: int, Hkv: int, D: int, dtype: torch.dtype,
                 device_index: int) -> Tuple[int, int, int]:
    """(keys per split, splits, fp32 scratch values) for one call's shapes:
    the checks that depend on shapes alone, done once a shape."""
    _build.check_head_dim("decode_attention", D, dtype)
    if Hq // Hkv > _MAX_GROUP:
        raise ValueError(f"decode_attention: group {Hq // Hkv} not supported "
                         f"(at most {_MAX_GROUP})")
    chunk, n_splits = split_plan(B, Sk, Hkv, _sm_count(device_index),
                                 _on_tensor_cores(dtype, Hq // Hkv))
    # part_m and part_l (B, Hkv, n, G) each, part_acc (B, Hkv, n, G, D)
    scratch = B * Hq * n_splits * (D + 2) if n_splits > 1 else 0
    return chunk, n_splits, scratch


def work(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, kv_len
         ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one call: the valid prefix of K and V read once,
    q read and the output written once, the (B,) int32 lengths read;
    q.k and p.v a multiply-add each over the valid keys.  Where the
    lengths are not known (tensors on the ``meta`` device) every slot is
    taken as full."""
    B, Sk, Hkv, D = k_cache.shape
    Hq = q.shape[2]
    if isinstance(kv_len, torch.Tensor) and kv_len.is_meta:
        valid = B * Sk
    else:
        valid = int(torch.as_tensor(kv_len).reshape(-1).expand(B).clamp(0, Sk).sum())
    itemsize = q.element_size()
    nbytes = 2 * valid * Hkv * D * itemsize + 2 * q.numel() * itemsize + B * 4
    return 4 * valid * Hq * D, nbytes


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
    peak = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    with kernel_scope("decode_attention", lambda: work(q, k_cache, v_cache, kv_len), peak):
        return _run(q, k_cache, v_cache, kv_len)


def _run(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    B, _, Hq, D = q.shape
    Sk, Hkv = k_cache.shape[1], k_cache.shape[2]
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, kv_len)

    device = q.device
    chunk, n_splits, n_scratch = _launch_plan(B, Sk, Hq, Hkv, D, q.dtype, device.index)
    if k_cache.device != device or v_cache.device != device:
        raise ValueError("decode_attention: q and the caches lie on different devices")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and the caches must be contiguous")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: q and the caches must be 16-byte aligned")
    lens = _kv_len_rows(kv_len, B, device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(device).cuda_stream
    if n_scratch:                  # one allocation: part_acc, then part_m and part_l
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=device)
        pa = scratch.data_ptr()
        pm = pa + 4 * B * Hq * n_splits * D                 # bytes
        pl = pm + 4 * B * Hq * n_splits
        counters = _stream_counters(device, stream, B * Hkv).data_ptr()
    else:
        pm = pl = pa = counters = None
    with torch.cuda.device(device):
        code = _build.library().repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            out.data_ptr(), pm, pl, pa, counters, B, Sk, Hq, Hkv, D, chunk, n_splits,
            int(q.dtype == torch.bfloat16), int(_on_tensor_cores(q.dtype, Hq // Hkv)), stream)
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


#: Times the kernel was launched (never counts the plain version).
decode_attention.launches = 0
