"""Kernel entry points that the model calls.

Each entry hands its tensors to the kernel's wrapper, which picks by the
tensor's device: a CUDA tensor launches the hand-written kernel (or raises),
a CPU tensor runs the plain PyTorch version.  `use_plain()` forces the plain
versions for the length of a ``with`` block, so that a check can run the
same path twice and compare; nothing in the package calls it.
"""

from __future__ import annotations

import contextlib

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import rmsnorm as _rmsnorm
from . import ssm_scan as _ssm

_force_plain = False


@contextlib.contextmanager
def use_plain():
    """Within the block every entry below runs its plain version."""
    global _force_plain
    before, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = before


def rms_norm(x, scale, eps: float = 1e-5):
    if _force_plain:
        return _rmsnorm.rms_norm_plain(x, scale, eps)
    return _rmsnorm.rms_norm(x, scale, eps)


def split_rms_norm(x, scale, eps: float, d_norm: int, reduce):
    """RMSNorm of a row split over ranks: see
    `repro_torch.kernels.rmsnorm.split_rms_norm`."""
    return _rmsnorm.split_rms_norm(x, scale, eps, d_norm, reduce, plain=_force_plain)


def decode_attention(q, k_cache, v_cache, kv_len):
    if _force_plain:
        return _decode.decode_attention_plain(q, k_cache, v_cache, kv_len)
    return _decode.decode_attention(q, k_cache, v_cache, kv_len)


def flash_attention(q, k, v, causal: bool = True):
    """(out, lse): see `repro_torch.kernels.flash_attention`."""
    if _force_plain:
        return _flash.flash_attention_plain(q, k, v, causal)
    return _flash.flash_attention(q, k, v, causal)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True, q_chunk: int = 1024,
                        k_chunk: int = 1024):
    """(dq, dk, dv): see `repro_torch.kernels.flash_attention`."""
    if _force_plain:
        return _flash.flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, q_chunk, k_chunk)
    return _flash.flash_attention_bwd(q, k, v, out, lse, dout, causal, q_chunk, k_chunk)


def ssm_scan(x, Bm, Cm, dt, A_log, D, chunk: int = 64):
    """(y, final state): see `repro_torch.kernels.ssm_scan`."""
    if _force_plain:
        return _ssm.ssm_scan_plain(x, Bm, Cm, dt, A_log, D, chunk)
    return _ssm.ssm_scan(x, Bm, Cm, dt, A_log, D, chunk)
