"""GQA flash-attention forward: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel `repro.kernels.flash_attention.flash_attention`,
and returns what `repro.models.attention._flash_fwd_math` returns: the
output and the fp32 log-sum-exp laid out ``(B, Hkv, G, Sq)``, which the
training backward reads instead of storing probabilities.  At the training
shape (B 2, S 4096, Hq 32 over Hkv 8, D 64, bf16, causal) it is bound by
operations on an H100: ``4 * B * Hq * D * S**2 / 2`` = 1.37e11, 0.139 ms at
the bf16 dense peak, against about 85 MB moved (0.025 ms).  The kernel
reads q, k and v in their native ``(B, S, H, D)`` layout, masks ragged
edges instead of asking the lengths to divide the blocks, and skips key
tiles wholly above the causal diagonal.  bf16 runs on Hopper's warpgroup
products: a block of 128 query rows has one warpgroup that streams K and
V tiles of `KEY_TILE` keys by TMA into a ring in shared memory and two
that compute (``wgmma``, Q Kᵀ from shared memory, P·V with P in
registers, split into bf16 hi + lo); d_head up to 64 runs the 64
instance, up to 128 the 128 instance, the columns past d_head zero.
Being bound by operations, it does 1.5 times `work()`'s products (the
split doubles P·V), so it can reach at most 2/3 of the bound.  fp32
keeps both products on the fp32 cores (d_head 32, 64 and 128 exact,
other multiples of 4 padded to 128), for the 2e-5 checks.  See the
source's note.

Plain version: `flash_attention_plain`, which is `gqa_reference` plus the
log-sum-exp of the same masked scores.

The gradient, `flash_attention_bwd`, wraps ``csrc/flash_attention_bwd.cu``:
the reference's `custom_vjp` rule (`_flash_bwd_rule`) as two kernels, a dq
pass (a block per query tile and head, which also writes each row's delta
= sum(dout * out)) and a dk/dv pass, without unordered atomics, so two
calls agree bit for bit.  Bound by operations: five products over the
visible pairs (`work_bwd`, 2.5 times the forward's FLOPs).  bf16 runs on
wgmma from a TMA ring: P rounded once to bf16 for dV, dS rounded once for
dQ and split into bf16 hi + lo for dK (a K bias's gradient cancels, a Q
bias's does not); with S and dP recomputed by both passes that is 8
products, so the kernels can reach at most 5/8 of the bound.  The dk/dv
pass's items are pieces of key blocks (`dkdv_items`, cut under
`dkdv_cap`), so that the long causal key blocks of few kv heads spread
over the SMs; a block cut into pieces sums them in piece order through an
fp32 scratch, its last piece (by a ticket) adding and storing.  fp32 runs
on the fp32 cores.  One call is two launches, both counted in
`flash_attention_bwd.launches`.  Plain version: `flash_attention_bwd_plain`,
the rule itself.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from repro_torch.models.attention import NEG_INF, _flash_bwd_rule, gqa_reference

from . import _build
from .scope import kernel_scope
from .ssm_scan import _sync_buffer

_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: (out in q's type, fp32 lse
    ``(B, Hkv, G, Sq)``)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = gqa_reference(q, k, v, causal)
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / (D ** 0.5)
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)
        scores = scores.masked_fill(~mask, NEG_INF)
    return out, torch.logsumexp(scores, dim=-1)


#: Keys a tile of the bf16 kernel (both instances).
KEY_TILE = 128


def kernel_instance(d: int) -> str:
    """The bf16 kernel instance that a launch at d_head ``d`` runs, by the
    name the build's resources give it."""
    return f"flash_fwd_wgmma_kernel<{64 if d <= 64 else 128}>"


def _pairs(q: torch.Tensor, k: torch.Tensor, causal: bool) -> int:
    """The (query, key) pairs of one head that the mask lets through
    (causal: key j for query i when ``j <= i``), over the batch."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    if causal:
        seen = min(Sq, Sk)                  # queries below Sk see keys 0..i
        return B * (seen * (seen + 1) // 2 + (Sq - seen) * Sk)
    return B * Sq * Sk


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
         ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one call: q.k and p.v, a multiply-add each, over
    the (query, key) pairs the mask lets through (the kernel skipping tiles
    above the diagonal); q, k and v read once, the output (q's size) and
    the fp32 lse written once."""
    B, Sq, Hq, D = q.shape
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + B * Hq * Sq * 4
    return 4 * _pairs(q, k, causal) * Hq * D, nbytes


def work_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
             ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one gradient call: the five products of the rule
    (S = q.k, dP = dout.v, dq, dk and dv), a multiply-add each, over the
    pairs `work` counts, 2.5 times its FLOPs; q, k, v, out and dout read
    once, dq, dk and dv written once, the fp32 lse read and delta written
    once a row."""
    B, Sq, Hq, D = q.shape
    nbytes = ((4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * q.element_size()
              + 2 * B * Hq * Sq * 4)
    return 10 * _pairs(q, k, causal) * Hq * D, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q ``(B, Sq, Hq, D)`` against k, v ``(B, Sk, Hkv, D)``; returns (out
    ``(B, Sq, Hq, D)`` in q's type, lse ``(B, Hkv, Hq // Hkv, Sq)`` fp32).
    Causal means key j is seen by query i when ``j <= i``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (on the
    current stream, without synchronising) or raises."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q is {q.dtype}, k / v are {k.dtype} / {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv or Sk == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k / v "
                         f"{tuple(k.shape)}")
    peak = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    with kernel_scope("flash_attention", lambda: work(q, k, v, causal), peak):
        return _run(q, k, v, causal)


def _run(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)

    _build.check_head_dim("flash_attention", D, q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v lie on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((B, Hkv, Hq // Hkv, Sq), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        code = _build.library().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Sk, Hq, Hkv, D, int(causal), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


#: Times the kernel was launched (never counts the plain version).
flash_attention.launches = 0


# ------------------------------------------------------------- gradient --
#: Rows of the scratch that the dq kernel writes for the dk/dv kernel, a
#: (batch, head): Sq rounded up to a multiple of this (``SQ_PAD`` of the
#: source).
BWD_SQ_PAD = 128
#: Keys a dk/dv key block and queries a Q / dO tile of the bf16 dk/dv
#: kernel (``KV_BK``, ``KV_BQ``), and keys a K / V tile of its dq kernel
#: (``DQ_BK``).
KV_KEY_BLOCK, KV_QUERY_TILE, DQ_KEY_TILE = 128, 64, 64
#: The dk/dv key blocks are cut into pieces of at most ``cap`` query tiles
#: where the longest block holds more than half of an SM's even share of
#: the pass (under causality the first key blocks of few kv heads, as
#: qwen2-vl-2b's, whose longest block is 32 times its shortest and twice an
#: SM's share): ``cap`` is then the larger of `MIN_PIECE` and the pass's
#: tiles over `PIECE_WAVES` times the SMs.  Elsewhere the blocks, taken
#: longest first, balance as they are.
MIN_PIECE, PIECE_WAVES = 16, 4


def bwd_kernel_instances(d: int) -> Tuple[str, str]:
    """The bf16 gradient kernels' instances that a launch at d_head ``d``
    runs, by the names the build's resources give them."""
    n = 64 if d <= 64 else 128
    return f"flash_bwd_dq_wgmma_kernel<{n}>", f"flash_bwd_dkdv_wgmma_kernel<{n}>"


def _kv_tiles(z: int, n_qt: int, G: int, causal: bool) -> int:
    """Query tiles that key block ``z`` visits, every head of its group."""
    return G * (n_qt - (min(z * (KV_KEY_BLOCK // KV_QUERY_TILE), n_qt) if causal else 0))


def dkdv_cap(B: int, Sq: int, Sk: int, Hkv: int, G: int, causal: bool, n_sm: int) -> int:
    """The piece cap of the bf16 dk/dv kernel on a card of ``n_sm`` SMs (the
    longest block's tiles where no block is cut)."""
    n_qt, n_kb = -(-Sq // KV_QUERY_TILE), -(-Sk // KV_KEY_BLOCK)
    tiles = [_kv_tiles(z, n_qt, G, causal) for z in range(n_kb)]
    total = B * Hkv * sum(tiles)
    if 2 * max(tiles) * n_sm <= total:
        return max(1, max(tiles))
    return max(MIN_PIECE, -(-total // (PIECE_WAVES * n_sm)))


def dkdv_items(Sq: int, Sk: int, G: int, causal: bool, cap: int
               ) -> List[Tuple[int, int, int, int, int]]:
    """The bf16 dk/dv kernel's items of one (kv head, batch), in launch
    order (``kv_item`` of the source): (key block z, first tile, one past
    the last, piece, pieces of the block).  Block z's tiles are its query
    tiles head by head (tile t: head ``t // per_head``, query tile ``qt0 +
    t % per_head``); it is cut into ``ceil(tiles / cap)`` pieces (at least
    one) of near-equal length.  A block cut in more than one piece sums
    its pieces in piece order; those items come first."""
    n_qt, n_kb = -(-Sq // KV_QUERY_TILE), -(-Sk // KV_KEY_BLOCK)
    out = []
    for z in range(n_kb):
        w = _kv_tiles(z, n_qt, G, causal)
        n = max(1, -(-w // cap))
        out += [(z, w * p // n, w * (p + 1) // n, p, n) for p in range(n)]
    return out


@functools.lru_cache(maxsize=None)
def _dkdv_plan(B: int, Sq: int, Sk: int, Hkv: int, G: int, causal: bool, index: int
               ) -> Tuple[int, int, int]:
    """(cap, items, cut items) of the bf16 dk/dv launch on card ``index``."""
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    cap = dkdv_cap(B, Sq, Sk, Hkv, G, causal, n_sm)
    items = dkdv_items(Sq, Sk, G, causal, cap)
    return cap, len(items), sum(1 for it in items if it[4] > 1)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = True,
                              q_chunk: int = 1024, k_chunk: int = 1024
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same gradient in plain PyTorch: `_flash_bwd_rule` over blocks of
    ``q_chunk`` queries and ``k_chunk`` keys (a ragged last block is
    masked); (dq, dk, dv) in q's type."""
    return _flash_bwd_rule(causal, q_chunk, k_chunk, (q, k, v, out, lse), dout)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                        q_chunk: int = 1024, k_chunk: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` (q, k, v, causal) for the output's
    gradient ``dout``, given its output ``out`` and lse; each in q's type.
    A CPU (or meta) tensor takes the plain version, over blocks of
    ``q_chunk`` x ``k_chunk``; a CUDA tensor launches the two kernels (on
    the current stream, without synchronising) or raises."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_bwd takes float32 or bfloat16, not {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, out, dout)) or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: q is {q.dtype}, k / v / out / dout are "
                        f"{k.dtype} / {v.dtype} / {out.dtype} / {dout.dtype}, lse {lse.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv or Sk == 0:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} does not fit k / v "
                         f"{tuple(k.shape)}")
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B, Hkv, Hq // Hkv, Sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    peak = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    with kernel_scope("flash_attention_bwd", lambda: work_bwd(q, k, v, causal), peak):
        if not q.is_cuda:
            return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, q_chunk, k_chunk)
        return _run_bwd(q, k, v, out, lse, dout.contiguous(), causal)


def _run_bwd(q, k, v, out, lse, dout, causal: bool):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _build.check_head_dim("flash_attention_bwd", D, q.dtype)
    tensors = (q, k, v, out, lse, dout)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention_bwd: the tensors lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_bwd: q, k, v, out and lse must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention_bwd: the tensors must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    sq_pad = -(-Sq // BWD_SQ_PAD) * BWD_SQ_PAD
    scratch = torch.empty(2 * B * Hq * sq_pad, dtype=torch.float32, device=q.device)
    parts = count = None
    cap = items = n_split = 0
    if q.dtype == torch.bfloat16:
        cap, items, n_split = _dkdv_plan(B, Sq, Sk, Hkv, Hq // Hkv, causal, q.device.index)
        width = 64 if D <= 64 else 128                     # the instance's d_head
        parts = torch.empty(B * Hkv * n_split * 2 * KV_KEY_BLOCK * width, dtype=torch.float32,
                            device=q.device)
        count = _sync_buffer(_TICKETS, q.device, B * Hkv * -(-Sk // KV_KEY_BLOCK))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        code = _build.library().repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
            ptr(parts), ptr(count), B, Sq, Sk, Hq, Hkv, D, int(causal), cap, items, n_split,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 2               # the dq and the dk/dv kernel
    return dq, dk, dv


#: The bf16 dk/dv kernel's tickets, a key block each, on each device
#: (`ssm_scan._sync_buffer`: the call's last piece of a block puts its
#: ticket back to 0, so a call launches no zeroing).
_TICKETS: dict = {}


#: Kernel launches, two a call (never counts the plain version).
flash_attention_bwd.launches = 0
