"""Mamba2 SSD chunked scan: wrapper of ``csrc/ssm_scan.cu``.

Replaces the Pallas kernel `repro.kernels.ssm_scan.ssm_scan`: per (batch,
head) the chunks in order, the (P, N) fp32 state carried across them, zero
initial state; returns y ``(B, S, H, P)`` in x's type and the final state
``(B, H, P, N)`` fp32.  At zamba2-7b's training shape (B 2, S 4096, H 112,
P 64, N 64, chunk 64, bf16) it is bound by bytes on an H100: x and y 235 MB,
B, C, dt and the state 9.4 MB, 0.073 ms at 3.35 TB/s.  bf16 runs
`KERNEL`, designed for Hopper: each head's sequence split into segments of
`SEGMENT_CHUNKS` chunks, a block each, the carried state passed from
segment to segment by a look-back (the wrapper allocates its scratch:
two fp32 states a head, and a zeroed ticket counter and flags), x, B and C
loaded by TMA, the chunk's products on ``wgmma`` (C·Bᵀ in bf16; W·x, C·Sᵀ
and the state update with their fp32 operand split into bf16 hi + lo,
since one rounding misses the bf16 allowance); one launch a call, and
the same y and state bit for bit from the same inputs.  fp32 keeps its
fp32-core path for the 2e-5 checks (see the source's note).  The kernel
reads x, B and C at their own batch and sequence strides, so the column
slices of the conv output that `mamba2_block` hands it are not copied, and
computes ``-exp(A_log)`` and D per head itself.

The gradient is `_SSMScanFn`'s backward: plain autograd through
`ssd_chunked`, recomputed on detached inputs (the reference trains through
autodiff of its jnp `ssd_chunked`; the Pallas kernel has no backward).  It
is taken only where autograd needs it, so a call with no gradient to track
launches the kernel alone.

Plain version: `repro_torch.models.ssm.ssd_chunked` (y in fp32).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.ssm import ssd_chunked as ssm_scan_plain

from . import _build
from .scope import kernel_scope

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_DIM = 64       # chunk, P and N: the kernel's shared-memory tiles
#: The bf16 kernel's name in the build and in the profiler.
KERNEL = "ssm_scan_wgmma_kernel"
#: Chunks in a segment of the bf16 kernel's split of the sequence
#: (``csrc/ssm_scan.cu``, ``SEG``): a block a segment of one (batch, head).
SEGMENT_CHUNKS = 4
_STATE_TILE = 64 * 64   # fp32 values of a state as the bf16 kernel carries it


def _check(x, Bm, Cm, dt, A_log, D, chunk: int) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssm_scan takes float32 or bfloat16 x, not {x.dtype}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssm_scan: x is {x.dtype}, B / C are {Bm.dtype} / {Cm.dtype}")
    if dt.dtype != torch.float32 or A_log.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError("ssm_scan: dt, A_log and D must be float32")
    if x.ndim != 4 or Bm.ndim != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)}, B {tuple(Bm.shape)}, "
                         f"C {tuple(Cm.shape)}")
    B, S, H, _ = x.shape
    if (Bm.shape[:2] != (B, S) or dt.shape != (B, S, H) or A_log.shape != (H,)
            or D.shape != (H,)):
        raise ValueError(f"ssm_scan: x {tuple(x.shape)} does not fit B {tuple(Bm.shape)}, "
                         f"dt {tuple(dt.shape)}, A_log {tuple(A_log.shape)}, "
                         f"D {tuple(D.shape)}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"ssm_scan: S {S} % chunk {chunk} != 0")


def _launch(x, Bm, Cm, dt, A_log, D, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    for name, n in (("chunk", chunk), ("P", P), ("N", N)):
        if n > _MAX_DIM:
            raise ValueError(f"ssm_scan: {name}={n} is more than {_MAX_DIM}")
    if any(t.device != x.device for t in (Bm, Cm, dt, A_log, D)):
        raise ValueError("ssm_scan: the inputs lie on different devices")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError(f"ssm_scan: x's (H, P) must be contiguous, strides {x.stride()}")
    if Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("ssm_scan: B and C must be contiguous along N")
    if not (dt.is_contiguous() and A_log.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssm_scan: dt, A_log and D must be contiguous")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    bf16 = x.dtype == torch.bfloat16
    carry = sync = None
    if bf16:
        # The look-back's scratch: two carried states a (batch, head), and
        # a ticket counter and each head's count of published segments.
        many = S // chunk > SEGMENT_CHUNKS
        carry = torch.empty((2 * B * H * _STATE_TILE if many else 0,), dtype=torch.float32,
                            device=x.device)
        sync = torch.zeros((1 + B * H,), dtype=torch.int32, device=x.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        code = _build.library().repro_ssm_scan(
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
            D.data_ptr(), y.data_ptr(), state.data_ptr(), ptr(carry), ptr(sync), B, S, H, P,
            N, chunk, x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
            Cm.stride(1), int(bf16), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "ssm_scan")
    ssm_scan.launches += 1
    return y, state


def work(x, Bm, Cm, dt, A_log, D, chunk: int = 64) -> Tuple[int, int]:
    """(FLOPs, bytes) of one call.  FLOPs: per (batch, head, chunk) the
    multiply-adds of C.B^T (L*L*N), W.x (L*L*P), C.S^T (L*P*N) and the
    state update (P*N*L).  Bytes: x read and y written and B and C read in
    x's type, dt, A_log and D read and the final state written in fp32."""
    B, S, H, P = x.shape
    N, L = Bm.shape[-1], chunk
    flops = 2 * (L * L * N + L * L * P + 2 * L * P * N) * B * H * (S // L)
    itemsize = x.element_size()
    nbytes = (2 * x.numel() + Bm.numel() + Cm.numel()) * itemsize + dt.numel() * 4 \
        + (A_log.numel() + D.numel()) * 4 + B * H * P * N * 4
    return flops, nbytes


def _forward(x, Bm, Cm, dt, A_log, D, chunk: int):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    peak = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    with kernel_scope("ssm_scan", lambda: work(x, Bm, Cm, dt, A_log, D, chunk), peak):
        if not x.is_cuda:
            return ssm_scan_plain(x, Bm, Cm, dt, A_log, D, chunk)
        return _launch(x, Bm, Cm, dt, A_log, D, chunk)


class _SSMScanFn(torch.autograd.Function):
    """Forward: `_forward`.  Backward: `ssd_chunked` recomputed under
    autograd on detached copies of the inputs, and its gradients."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A_log, D, chunk):
        ctx.save_for_backward(x, Bm, Cm, dt, A_log, D)
        ctx.chunk = chunk
        return _forward(x, Bm, Cm, dt, A_log, D, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        need = ctx.needs_input_grad[:6]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y, state = ssm_scan_plain(*inputs, ctx.chunk)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad((y, state), wanted,
                                             (dy.to(y.dtype), dstate.to(state.dtype))))
        return (*(next(grads) if n else None for n in need), None)


def ssm_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, dt: torch.Tensor,
             A_log: torch.Tensor, D: torch.Tensor, chunk: int = 64
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``(B, S, H, P)``, Bm / Cm ``(B, S, N)`` in fp32 or bf16; dt ``(B, S,
    H)`` (post-softplus), A_log and D ``(H,)`` in fp32; ``S % chunk == 0``.
    Returns (y ``(B, S, H, P)``, final state ``(B, H, P, N)`` fp32), from a
    zero initial state.  A CPU tensor takes the plain version (y in fp32); a
    CUDA tensor launches the kernel (y in x's type; on the current stream,
    without synchronising) or raises: chunk, P and N at most 64, x's last
    two dims and B / C's last dim contiguous.
    Differentiable: under autograd the call goes through `_SSMScanFn`."""
    _check(x, Bm, Cm, dt, A_log, D, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, Bm, Cm, dt, A_log, D)):
        return _SSMScanFn.apply(x, Bm, Cm, dt, A_log, D, chunk)
    return _forward(x, Bm, Cm, dt, A_log, D, chunk)


#: Times the kernel was launched (never counts the plain version).
ssm_scan.launches = 0
