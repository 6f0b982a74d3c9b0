"""Fused RMSNorm: wrapper of the CUDA kernel in ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel `repro.kernels.rmsnorm.rms_norm`.  Bound by
bytes on an H100: x read once, out written once (2 * rows * d * itemsize
over 3.35 TB/s); at the decode step's (8, 1, 2048) bf16 that is 64 KB, so
the launch, not the memory, sets its time.  The kernel keeps each row in
registers between the sum of squares and the scaled write, and masks the
ragged tail instead of padding the rows as the TPU wrapper does.

The gradient is `_RMSNormFn`'s backward, `rms_norm_bwd`: for a CUDA
tensor the hand-written `rms_norm_bwd_kernel` (one pass over whole rows:
x and dy read once, dx written once, each block's dscale partials kept in
registers) and `rms_dscale_sum_kernel` (the partials summed over the
blocks in a fixed order), two launches counted in `rms_norm_bwd.launches`;
for a CPU or meta tensor `rms_norm_backward_plain`, the fp32 formula.  The
reference differentiates its jnp `rms_norm`; there is no Pallas backward.
It is taken only where autograd needs it: a call with no gradient to track
launches the forward kernel alone, so serving is untouched.

A call's host path is kept short, since a decode step is host-bound and
makes one call a norm: the device context is entered only where x is not
on the current device, and the stream is the raw handle, with no `Stream`
object built.  `empty_kernel` launches an empty kernel by the same route:
the launch floor the decode-shape times stand on.

A row split over the ranks of a tensor-parallel axis (the Mamba2 and
xLSTM mixers' norms over d_inner, each rank holding its heads' channels)
takes the same kernel through two more entries: `rms_sumsq` (each row's
fp32 sum of squares over the rank's channels) and `rms_norm_sumsq` (the
rank's channels scaled from the whole row's sum, which the caller sums
over the ranks in between; `split_rms_norm` does the three steps, with
the gradient).  Their launches count in `rms_norm.launches`.

Plain versions: `repro_torch.models.layers.rms_norm`,
`rms_norm_backward_plain`, `rms_sumsq_plain`, `rms_norm_sumsq_plain`.
"""

from __future__ import annotations

import contextlib
import functools
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


_NO_CONTEXT = contextlib.nullcontext()


def _device_and_stream(index: int):
    """(the device context to enter for a launch on CUDA device ``index``,
    the raw handle of its current stream): `_NO_CONTEXT` where ``index`` is
    the current device.  The one place the launches take torch's private
    CUDA entry points, which `torch.cuda.current_device` and torch's
    compiled kernels call too (checked with torch 2.11 on the card;
    `tests/test_torch_norm_grad.py` holds their names to torch's stubs)."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        return _NO_CONTEXT, stream
    return torch.cuda.device(index), stream


def _run(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return rms_norm_plain(x, scale, eps)
    if scale.get_device() != x.get_device():
        raise ValueError(f"rms_norm: x on {x.device}, scale on {scale.device}")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rms_norm: x and scale must be contiguous")
    d = x.shape[-1]
    vec = 16 // x.element_size()
    if d % vec or d > _MAX_VECTORS * vec:
        raise ValueError(f"rms_norm: d={d} must be a multiple of {vec} and at most "
                         f"{_MAX_VECTORS * vec} for {x.dtype}")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    xp, sp = x.data_ptr(), scale.data_ptr()
    if xp % 16 or sp % 16:
        raise ValueError("rms_norm: x and scale must be 16-byte aligned")
    context, stream = _device_and_stream(x.get_device())
    with context:
        code = _build.library().repro_rms_norm(xp, sp, out.data_ptr(), rows, d, float(eps),
                                               x.dtype == torch.bfloat16, stream)
    if code:
        _build.check(code, "rms_norm")
    rms_norm.launches += 1
    return out


# ------------------------------------------------------------- gradient --
def rms_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``x * rsqrt(mean(x^2) + eps) * scale`` for the
    output's gradient ``dy``, in fp32 with xhat = x * r and r =
    rsqrt(mean(x^2) + eps): dscale = sum over rows of dy * xhat; dx = r *
    (dy*scale - xhat * mean(dy*scale*xhat)); each cast to its input's type,
    as the reference's casts make them."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.float()
    dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(0)
    dxhat = dyf * scale.float()
    dx = r * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale.to(scale.dtype)


def work_bwd(x: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int]:
    """(FLOPs, bytes) of one gradient call: x and dy read and dx written
    once, scale read and dscale written once, in x's type.  FLOPs as the
    plain version's ops counted in the tally before the kernel took them
    over, none: the tally counts products' FLOPs (and the reference's HLO
    count has none for XLA's fused backward), so its agreement with the
    reference is unchanged.  The kernel's eleven fp32 operations an element
    would take a tenth of its bytes' time on the fp32 cores."""
    return 0, (3 * x.numel() + 2 * scale.numel()) * x.element_size()


#: Persistent blocks of the gradient kernel an SM: its ring's three stages
#: leave room for two at every model's width.
BWD_BLOCKS_PER_SM = 2


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rms_norm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of `rms_norm` (x, scale, eps) for the output's gradient
    ``dy``: `rms_norm_backward_plain` for a CPU or meta tensor; for a CUDA
    tensor the gradient kernel and the dscale sum, two launches on the
    current stream, or raises."""
    with kernel_scope("rms_norm_bwd", lambda: work_bwd(x, scale), "float32"):
        if not x.is_cuda:
            return rms_norm_backward_plain(x, scale, dy, eps)
        dx, partial = _launch_bwd(x, scale, dy, eps)
        if partial is None:                     # no rows
            return dx, torch.zeros_like(scale)
        return dx, _launch_dscale_sum(partial, scale)


def _launch_bwd(x, scale, dy, eps):
    """The gradient kernel: (dx, each block's dscale partials (blocks, d)
    fp32, None where x has no rows)."""
    if x.dtype not in _ITEMSIZE or scale.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"rms_norm_bwd: x {x.dtype}, scale {scale.dtype}, dy {dy.dtype}")
    if dy.shape != x.shape or scale.shape != x.shape[-1:]:
        raise ValueError(f"rms_norm_bwd: x {tuple(x.shape)}, dy {tuple(dy.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if not (scale.get_device() == dy.get_device() == x.get_device()):
        raise ValueError(f"rms_norm_bwd: x on {x.device}, scale on {scale.device}, dy on "
                         f"{dy.device}")
    d = _check_rows(x, "rms_norm_bwd")
    _check_rows(dy, "rms_norm_bwd", "dy")
    if not scale.is_contiguous() or scale.data_ptr() % 16:
        raise ValueError("rms_norm_bwd: scale must be contiguous and 16-byte aligned")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, None
    blocks = min(rows, BWD_BLOCKS_PER_SM * _sm_count(x.get_device()))
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    context, stream = _device_and_stream(x.get_device())
    with context:
        code = _build.library().repro_rms_norm_bwd(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            rows, d, float(eps), blocks, x.dtype == torch.bfloat16, stream)
    if code:
        _build.check(code, "rms_norm_bwd")
    rms_norm_bwd.launches += 1
    return dx, partial


def _launch_dscale_sum(partial: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """dscale in scale's type: the sum of ``partial`` (blocks, d) fp32 over
    its rows, in a fixed order."""
    dscale = torch.empty_like(scale)
    context, stream = _device_and_stream(partial.get_device())
    with context:
        code = _build.library().repro_rms_dscale_sum(
            partial.data_ptr(), dscale.data_ptr(), partial.shape[0], partial.shape[1],
            scale.dtype == torch.bfloat16, stream)
    if code:
        _build.check(code, "rms_dscale_sum")
    rms_norm_bwd.launches += 1
    return dscale


def empty_kernel(device) -> None:
    """Launches the empty kernel on ``device``'s current stream, by the
    route every kernel here takes (the launch floor); raises off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"empty_kernel: {device} is not a CUDA device")
    context, stream = _device_and_stream(torch.cuda.current_device() if device.index is None
                                         else device.index)
    with context:
        code = _build.library().repro_empty(stream)
    if code:
        _build.check(code, "empty")


class _RMSNormFn(torch.autograd.Function):
    """Forward: `_forward`.  Backward: `rms_norm_bwd` (dy made contiguous
    first: autograd may hand in an expanded gradient)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rms_norm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, dscale, None


# ----------------------------------------------------------- split rows --
def rms_sumsq_plain(x: torch.Tensor) -> torch.Tensor:
    """Each row's sum of x^2 in fp32: (...,) of x (..., d)."""
    return x.float().square().sum(dim=-1)


def rms_norm_sumsq_plain(x: torch.Tensor, sumsq: torch.Tensor, scale: torch.Tensor,
                         eps: float, d_norm: int) -> torch.Tensor:
    """``x * rsqrt(sumsq / d_norm + eps) * scale``, fp32 math, output in x's
    type; ``sumsq`` (...,) fp32 the whole row's sum of squares."""
    r = torch.rsqrt(sumsq / d_norm + eps)[..., None]
    return (x.float() * r * scale.float()).to(x.dtype)


def work_sumsq(x: torch.Tensor) -> Tuple[int, int]:
    """(FLOPs, bytes) of `rms_sumsq`: x read once, a fp32 sum a row
    written; two fp32 operations an element (square, sum)."""
    rows = x.numel() // x.shape[-1]
    return 2 * x.numel(), x.numel() * x.element_size() + 4 * rows


def work_norm_sumsq(x: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int]:
    """(FLOPs, bytes) of `rms_norm_sumsq`: x read and out written once,
    the row's sum and scale read once; two fp32 operations an element
    (normalise, scale)."""
    rows = x.numel() // x.shape[-1]
    return 2 * x.numel(), (2 * x.numel() + scale.numel()) * x.element_size() + 4 * rows


def _check_rows(x: torch.Tensor, what: str, name: str = "x") -> int:
    """The row width of a CUDA call's ``x`` (called ``name``); raises where
    the kernel does not take it."""
    if not x.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    d = x.shape[-1]
    vec = 16 // _ITEMSIZE[x.dtype]
    if d % vec or d > _MAX_VECTORS * vec:
        raise ValueError(f"{what}: d={d} must be a multiple of {vec} and at most "
                         f"{_MAX_VECTORS * vec} for {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return d


def rms_sumsq(x: torch.Tensor) -> torch.Tensor:
    """Each row's fp32 sum of squares, (...,) of x (..., d): the plain
    version for a CPU tensor, the kernel for a CUDA tensor.  Not
    differentiable (`split_rms_norm` is)."""
    if x.dtype not in _ITEMSIZE:
        raise TypeError(f"rms_sumsq takes float32 or bfloat16, not {x.dtype}")
    with kernel_scope("rms_norm", lambda: work_sumsq(x), "float32"):
        if not x.is_cuda:
            return rms_sumsq_plain(x)
        d = _check_rows(x, "rms_sumsq")
        out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rows = x.numel() // d
        if rows == 0:
            return out
        context, stream = _device_and_stream(x.get_device())
        with context:
            code = _build.library().repro_rms_sumsq(
                x.data_ptr(), out.data_ptr(), rows, d, x.dtype == torch.bfloat16, stream)
        if code:
            _build.check(code, "rms_sumsq")
        rms_norm.launches += 1
        return out


def rms_norm_sumsq(x: torch.Tensor, sumsq: torch.Tensor, scale: torch.Tensor, eps: float,
                   d_norm: int) -> torch.Tensor:
    """``x * rsqrt(sumsq / d_norm + eps) * scale`` with ``sumsq`` (...,)
    fp32 the whole row's sum of squares, of which x (..., d) holds d of
    the ``d_norm`` channels: the plain version for a CPU tensor, the
    kernel for a CUDA tensor.  Not differentiable (`split_rms_norm` is)."""
    if x.dtype not in _ITEMSIZE or scale.dtype != x.dtype:
        raise TypeError(f"rms_norm_sumsq: x {x.dtype}, scale {scale.dtype}")
    if sumsq.dtype != torch.float32 or sumsq.shape != x.shape[:-1]:
        raise ValueError(f"rms_norm_sumsq: sumsq {sumsq.dtype} {tuple(sumsq.shape)} for x "
                         f"{tuple(x.shape)}")
    if scale.shape != (x.shape[-1],) or d_norm < x.shape[-1]:
        raise ValueError(f"rms_norm_sumsq: scale {tuple(scale.shape)}, d_norm {d_norm} for "
                         f"x {tuple(x.shape)}")
    with kernel_scope("rms_norm", lambda: work_norm_sumsq(x, scale), "float32"):
        if not x.is_cuda:
            return rms_norm_sumsq_plain(x, sumsq, scale, eps, d_norm)
        d = _check_rows(x, "rms_norm_sumsq")
        if scale.device != x.device or sumsq.device != x.device:
            raise ValueError(f"rms_norm_sumsq: x on {x.device}, scale on {scale.device}, "
                             f"sumsq on {sumsq.device}")
        if not (scale.is_contiguous() and sumsq.is_contiguous()) or scale.data_ptr() % 16:
            raise ValueError("rms_norm_sumsq: scale and sumsq must be contiguous, scale "
                             "16-byte aligned")
        out = torch.empty_like(x)
        rows = x.numel() // d
        if rows == 0:
            return out
        context, stream = _device_and_stream(x.get_device())
        with context:
            code = _build.library().repro_rms_norm_sumsq(
                x.data_ptr(), scale.data_ptr(), sumsq.data_ptr(), out.data_ptr(), rows, d,
                d_norm, float(eps), x.dtype == torch.bfloat16, stream)
        if code:
            _build.check(code, "rms_norm_sumsq")
        rms_norm.launches += 1
        return out


class _SumSqFn(torch.autograd.Function):
    """`rms_sumsq`; backward dx = 2 x dsumsq, in fp32."""

    @staticmethod
    def forward(ctx, x, plain):
        ctx.save_for_backward(x)
        return rms_sumsq_plain(x) if plain else rms_sumsq(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (2.0 * x.float() * g[..., None]).to(x.dtype), None


class _NormFromSumSqFn(torch.autograd.Function):
    """`rms_norm_sumsq`; backward in fp32 with r = rsqrt(sumsq/d_norm + eps):
    dx = r * dy * scale, dscale = sum over rows of dy * x * r, dsumsq =
    -r^3 / (2 d_norm) * sum over the channels of dy * scale * x (the rest
    of the whole row's gradient arrives through dsumsq, summed over the
    ranks by the caller's reduction)."""

    @staticmethod
    def forward(ctx, x, sumsq, scale, eps, d_norm, plain):
        ctx.save_for_backward(x, sumsq, scale)
        ctx.eps, ctx.d_norm = eps, d_norm
        if plain:
            return rms_norm_sumsq_plain(x, sumsq, scale, eps, d_norm)
        return rms_norm_sumsq(x, sumsq, scale, eps, d_norm)

    @staticmethod
    def backward(ctx, dy):
        x, sumsq, scale = ctx.saved_tensors
        xf, dyf = x.float(), dy.float()
        r = torch.rsqrt(sumsq / ctx.d_norm + ctx.eps)[..., None]
        dys = dyf * scale.float()
        dx = r * dys
        dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
        dsumsq = (-0.5 / ctx.d_norm) * r[..., 0] ** 3 * (dys * xf).sum(dim=-1)
        return dx.to(x.dtype), dsumsq, dscale.to(scale.dtype), None, None, None


def split_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, d_norm: int,
                   reduce, plain: bool = False) -> torch.Tensor:
    """RMSNorm of rows of ``d_norm`` channels of which ``x`` (..., d) holds
    d, ``scale`` its d channels' scales: ``reduce`` (a differentiable sum
    over the ranks holding the row's parts, with a summed gradient) takes
    each row's sum of squares over the rank's channels to the whole
    row's.  Two kernel launches for a CUDA tensor (``plain``: the plain
    versions, as `ops.use_plain` asks); differentiable."""
    sumsq = reduce(_SumSqFn.apply(x, plain))
    return _NormFromSumSqFn.apply(x, sumsq, scale, eps, d_norm, plain)


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
#: Launches of the gradient's two kernels, one each (never the plain version).
rms_norm_bwd.launches = 0
