"""Fused RMSNorm: wrapper of the CUDA kernel in ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel `repro.kernels.rmsnorm.rms_norm`.  Bound by
bytes on an H100: x read once, out written once (2 * rows * d * itemsize
over 3.35 TB/s); at the decode step's (8, 1, 2048) bf16 that is 64 KB, so
the launch, not the memory, sets its time.  The kernel keeps each row in
registers between the sum of squares and the scaled write, and masks the
ragged tail instead of padding the rows as the TPU wrapper does.

The gradient is `_RMSNormFn`'s backward, plain PyTorch in fp32 (the
reference differentiates its jnp `rms_norm`; there is no Pallas backward).
It is taken only where autograd needs it: a call with no gradient to track
launches the kernel alone, so serving is untouched.

Plain version: `repro_torch.models.layers.rms_norm`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import rms_norm as rms_norm_plain

from . import _build
from .scope import kernel_scope

_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_MAX_VECTORS = 256 * 8      # 16-byte vectors a row: MAX_TPR * MAXV of the kernel


def work(x: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int]:
    """(FLOPs, bytes) of one call: x read and out written once, scale read
    once, in x's type; four fp32 operations an element (square, sum,
    normalise, scale), which run on the fp32 cores."""
    itemsize = x.element_size()
    return 4 * x.numel(), (2 * x.numel() + scale.numel()) * itemsize


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    with kernel_scope("rms_norm", lambda: work(x, scale), "float32"):
        return _run(x, scale, eps)


def _run(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return rms_norm_plain(x, scale, eps)
    if scale.device != x.device:
        raise ValueError(f"rms_norm: x on {x.device}, scale on {scale.device}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rms_norm: x and scale must be contiguous")
    d = x.shape[-1]
    vec = 16 // _ITEMSIZE[x.dtype]
    if d % vec or d > _MAX_VECTORS * vec:
        raise ValueError(f"rms_norm: d={d} must be a multiple of {vec} and at most "
                         f"{_MAX_VECTORS * vec} for {x.dtype}")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    if x.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("rms_norm: x and scale must be 16-byte aligned")
    with torch.cuda.device(x.device):
        code = _build.library().repro_rms_norm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "rms_norm")
    rms_norm.launches += 1
    return out


class _RMSNormFn(torch.autograd.Function):
    """Forward: `_forward`.  Backward, in fp32 with xhat = x * r and
    r = rsqrt(mean(x^2) + eps):  dscale = sum over rows of dy * xhat;
    dx = r * (dy*scale - xhat * mean(dy*scale*xhat)); each cast to its
    input's type, as the reference's casts make them."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xf = x.float()
        r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = xf * r
        dyf = dy.float()
        dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
        dxhat = dyf * scale.float()
        dx = r * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale``; x ``(..., d)``, scale
    ``(d,)``.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (on the current stream, without synchronising) or raises.
    Differentiable: under autograd the call goes through `_RMSNormFn`."""
    if x.dtype not in _ITEMSIZE:
        raise TypeError(f"rms_norm takes float32 or bfloat16, not {x.dtype}")
    if scale.dtype != x.dtype:
        raise TypeError(f"rms_norm: scale is {scale.dtype}, x is {x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rms_norm: scale {tuple(scale.shape)} does not match d={d}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFn.apply(x, scale, eps)
    return _forward(x, scale, eps)


#: Times the kernel was launched (never counts the plain version).
rms_norm.launches = 0
