"""Mamba2 SSD chunked scan: wrapper of ``csrc/ssm_scan.cu``.

Replaces the Pallas kernel `repro.kernels.ssm_scan.ssm_scan`: per (batch,
head) the chunks in order, the (P, N) fp32 state carried across them, zero
initial state; returns y ``(B, S, H, P)`` in x's type and the final state
``(B, H, P, N)`` fp32.  At zamba2-7b's training shape (B 2, S 4096, H 112,
P 64, N 64, chunk 64, bf16) it is bound by bytes on an H100: x and y 235 MB,
B, C, dt and the state 9.4 MB, 0.073 ms at 3.35 TB/s.  bf16 runs
`KERNEL`, designed for Hopper: each head's sequence split into segments of
`SEGMENT_CHUNKS` chunks, a block each, the carried state passed from
segment to segment by a look-back (the wrapper allocates its scratch, two
fp32 states a head, and keeps its ticket counter and flags, which each
call's last block leaves zero), x, B and C
loaded by TMA, the chunk's products on ``wgmma`` (C·Bᵀ in bf16; W·x, C·Sᵀ
and the state update with their fp32 operand split into bf16 hi + lo,
since one rounding misses the bf16 allowance); one launch a call, and
the same y and state bit for bit from the same inputs.  fp32 keeps its
fp32-core path for the 2e-5 checks (see the source's note).  The kernel
reads x, B and C at their own batch and sequence strides, so the column
slices of the conv output that `mamba2_block` hands it are not copied, and
computes ``-exp(A_log)`` and D per head itself.

The gradient is `ssm_scan_bwd`, `_SSMScanFn`'s backward: three launches of
``csrc/ssm_scan_bwd.cu`` on the card (the states and state gradients every
`BWD_STATE_CHUNKS` chunks by two look-back chains; the chunks' gradients,
the states between recomputed on chip, heads grouped in a block of two
consumer warpgroups; the sums over head groups and over (batch,
sequence)), its plain version `ssm_scan_bwd_plain` on the CPU
(on the card only under `ops.use_plain()`, which runs `ssd_chunked` under
autograd in place of the Function).  The reference trains by autodiff of its jnp `ssd_chunked` (the Pallas
kernel has no backward).  It is taken only where autograd needs it, so a
call with no gradient to track launches the forward kernel alone.

Plain version: `repro_torch.models.ssm.ssd_chunked` (y in fp32).
"""

from __future__ import annotations

import math
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
        # The look-back's scratch: two carried states a (batch, head); and
        # its counters (a ticket counter, each head's count of published
        # segments, a count of finished blocks), zero, which the call's
        # last block leaves zero again.
        many = S // chunk > SEGMENT_CHUNKS
        carry = torch.empty((2 * B * H * _STATE_TILE if many else 0,), dtype=torch.float32,
                            device=x.device)
        sync = _sync_buffer(_SYNC_FWD, x.device, 2 + B * H)
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


# ------------------------------------------------------------- gradient --
#: The bf16 gradient kernels' names in the build and in the profiler: the
#: state chains, the chunks' gradients, the sums.
BWD_KERNELS = ("ssm_bwd_state_wgmma_kernel", "ssm_bwd_chunk_wgmma_kernel", "ssm_bwd_sum_kernel")
#: Heads a block of the chunk kernel takes, two consumer warpgroups in turn
#: (``csrc/ssm_scan_bwd.cu``, ``HB``): dB and dC are summed over them in the
#: block, then over the groups by the sum kernel.
BWD_HEAD_GROUP = 16
#: Chunks between two states the state chains keep (``csrc/ssm_scan_bwd.cu``,
#: ``R``): the chunk kernel recomputes the others from them.
BWD_STATE_CHUNKS = 2


def bwd_scratch_floats(B: int, S: int, H: int, N: int, chunk: int) -> Tuple[int, int]:
    """The fp32 scratch of one gradient call (``csrc/ssm_scan_bwd.cu``'s
    launcher): the kept states, a (64, 64) start state and end gradient for
    each group of `BWD_STATE_CHUNKS` chunks of each (batch, head); and the
    sums, dB's and dC's over each head group and each (batch, chunk,
    head)'s for dA_log and dD."""
    nc = S // chunk
    groups = -(-H // BWD_HEAD_GROUP)
    states = 2 * B * (-(-nc // BWD_STATE_CHUNKS)) * H * _STATE_TILE
    return states, 2 * B * S * groups * N + 2 * B * nc * H


def ssm_scan_bwd_plain(x, Bm, Cm, dt, A_log, D, dy, dstate=None, chunk: int = 64,
                       compute=torch.float32):
    """The gradient of `ssm_scan` in plain fp32 PyTorch, closed form, by
    chunks: (dx, dB, dC, ddt, dA_log, dD) for y's gradient ``dy`` and the
    final state's ``dstate`` (None: zero); dx, dB and dC in x's type, the
    others fp32.  Per (batch, head) and chunk of L steps, with cum the
    inclusive sum of A dt (A = -exp(A_log)), w_ij = exp(cum_i - cum_j) dt_j
    (j <= i, the exponent masked before the exp), S_c the state at chunk
    c's start and G_c the gradient of the state at its end (the last
    chunk's is ``dstate``; G_{c-1} = exp(cum_L) G_c + sum_i exp(cum_i)
    dy_i (x) C_i):

        dx_j = sum_{i>=j} (C_i.B_j) w_ij dy_i + wl_j G_c B_j + D dy_j
        dC_i = sum_{j<=i} w_ij (dy_i.x_j) B_j + exp(cum_i) dy_i S_c
        dB_j = sum_{i>=j} w_ij (dy_i.x_j) C_i + wl_j x_j G_c

    with wl_j = exp(cum_L - cum_j) dt_j, dB and dC summed over the heads;
    ddt and dA_log from the gradient of cum, gathered from w, exp(cum_i),
    wl and the decay exp(cum_L), summed in reverse within the chunk.  The
    kernels' math in their order of steps; autograd through `ssd_chunked`
    is its oracle in the tests.  ``compute`` float64 evaluates the same
    closed form in float64 (the card's checks measure roundings against it)
    and returns float64."""
    B, S, H, P = x.shape
    N, L = Bm.shape[-1], chunk
    nc = S // L
    xc = x.reshape(B, nc, L, H, P).to(compute)
    dyc = dy.reshape(B, nc, L, H, P).to(compute)
    Bc = Bm.reshape(B, nc, L, N).to(compute)
    Cc = Cm.reshape(B, nc, L, N).to(compute)
    dtc = dt.reshape(B, nc, L, H).to(compute)
    A = -torch.exp(A_log.to(compute))
    cum = torch.cumsum(A * dtc, dim=2)                                  # (B,nc,L,H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    e = torch.exp((cum[:, :, :, None] - cum[:, :, None]).masked_fill(
        ~tri[None, None, :, :, None], -math.inf))                       # (B,nc,i,j,H)
    w = e * dtc[:, :, None]
    ecum = torch.exp(cum)
    el = torch.exp(cum[:, :, -1:] - cum)                                # exp(cum_L - cum_j)
    wl = el * dtc
    dec = torch.exp(cum[:, :, -1])                                      # (B,nc,H)

    # The states at the chunks' starts, and the state gradients at their ends.
    T = torch.einsum("bclh,bclhp,bcln->bchpn", wl, xc, Bc)
    U = torch.einsum("bclh,bclhp,bcln->bchpn", ecum, dyc, Cc)
    state = torch.zeros((B, H, P, N), dtype=compute, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * dec[:, c, :, None, None] + T[:, c]
    grad = (torch.zeros((B, H, P, N), dtype=compute, device=x.device) if dstate is None
            else dstate.to(compute))
    ends = [grad] * nc
    for c in reversed(range(nc)):
        ends[c] = grad
        grad = grad * dec[:, c, :, None, None] + U[:, c]
    S_c, G_c = torch.stack(starts, 1), torch.stack(ends, 1)             # (B,nc,H,P,N)

    Gm = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    Z = M * w                                                           # dB, dC's weights
    R = Gm[..., None] * M * e
    Uy = torch.einsum("bcihp,bchpn->bcihn", dyc, S_c)                   # dy_i S_c
    V = torch.einsum("bcjn,bchpn->bcjhp", Bc, G_c)                      # G_c B_j
    Y = torch.einsum("bcjhp,bchpn->bcjhn", xc, G_c)                     # x_j G_c
    dx = (wl[..., None] * V + torch.einsum("bcijh,bcihp->bcjhp", Gm[..., None] * w, dyc)
          + D.to(compute)[:, None] * dyc)
    dC = torch.einsum("bcijh,bcjn->bcin", Z, Bc) + torch.einsum("bcih,bcihn->bcin", ecum, Uy)
    dB = torch.einsum("bcijh,bcin->bcjn", Z, Cc) + torch.einsum("bcjh,bcjhn->bcjn", wl, Y)

    # The gradient of cum, summed in reverse within each chunk.
    col = R.sum(2)                                                      # over i: (B,nc,j,H)
    row = (R * dtc[:, :, None]).sum(3)                                  # over j: (B,nc,i,H)
    d_ecum = torch.einsum("bcihn,bcin->bcih", Uy, Cc)
    d_wl = (V * xc).sum(-1)
    d_dec = (S_c * G_c).sum((-2, -1))
    dcum = row - dtc * col + d_ecum * ecum - d_wl * wl
    dcum[:, :, -1] += (d_wl * wl).sum(2) + d_dec * dec
    rc = dcum.flip(2).cumsum(2).flip(2)
    ddt = col + d_wl * el + A * rc
    dA_log = A * (dtc * rc).sum((0, 1, 2))
    dD = (dyc * xc).sum((0, 1, 2, 4))
    if compute == torch.float64:
        return dx.reshape(B, S, H, P), dB.reshape(B, S, N), dC.reshape(B, S, N), \
            ddt.reshape(B, S, H), dA_log, dD
    return (dx.reshape(B, S, H, P).to(x.dtype), dB.reshape(B, S, N).to(Bm.dtype),
            dC.reshape(B, S, N).to(Cm.dtype), ddt.reshape(B, S, H), dA_log, dD)


def work_bwd(x, Bm, Cm, dt, A_log, D, chunk: int = 64, final_grad: bool = False
             ) -> Tuple[int, int]:
    """(FLOPs, bytes) of one gradient call.  FLOPs: per (batch, head,
    chunk) the multiply-adds of ten products: C.B^T, dy.x^T, dx's (C.B^T
    w)^T dy, dC's Z B and dB's Z^T C (L*L*N or L*L*P each), dy S, G B^T,
    x G and the two state chains' updates (L*P*N each).  Bytes: x and dy
    read and dx written, B and C read and dB and dC written, in x's type;
    dt read and ddt written, A_log and D read and their gradients written,
    and the final state's gradient read where there is one (``final_grad``),
    in fp32."""
    B, S, H, P = x.shape
    N, L = Bm.shape[-1], chunk
    flops = 2 * (L * L * (3 * N + 2 * P) + 5 * L * P * N) * B * H * (S // L)
    nbytes = ((3 * x.numel() + 2 * Bm.numel() + 2 * Cm.numel()) * x.element_size()
              + 2 * dt.numel() * 4 + 2 * (A_log.numel() + D.numel()) * 4
              + (B * H * P * N * 4 if final_grad else 0))
    return flops, nbytes


def ssm_scan_bwd(x, Bm, Cm, dt, A_log, D, dy, dstate=None, chunk: int = 64):
    """(dx, dB, dC, ddt, dA_log, dD) of `ssm_scan` (x, Bm, Cm, dt, A_log, D,
    chunk) for y's gradient ``dy`` (x's shape, any float type) and the
    final state's ``dstate`` (``(B, H, P, N)``, or None for zero); dx, dB
    and dC in x's type, the others fp32.  A CPU tensor takes the plain
    version `ssm_scan_bwd_plain`; a CUDA tensor launches the three kernels
    (on the current stream, without synchronising) or raises; a meta tensor
    takes the card's route up to the launch."""
    _check(x, Bm, Cm, dt, A_log, D, chunk)
    if dy.shape != x.shape:
        raise ValueError(f"ssm_scan_bwd: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    B, S, H, P = x.shape
    if dstate is not None and dstate.shape != (B, H, P, Bm.shape[-1]):
        raise ValueError(f"ssm_scan_bwd: dstate {tuple(dstate.shape)} for x {tuple(x.shape)}, "
                         f"N {Bm.shape[-1]}")
    peak = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    work_of = lambda: work_bwd(x, Bm, Cm, dt, A_log, D, chunk, dstate is not None)
    with kernel_scope("ssm_scan_bwd", work_of, peak):
        if x.device.type == "cpu":
            return ssm_scan_bwd_plain(x, Bm, Cm, dt, A_log, D, dy, dstate, chunk)
        return _launch_bwd(x, Bm, Cm, dt, A_log, D, dy, dstate, chunk)


def _sync_buffer(cache: dict, device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` look-back counters on
    ``device``, kept in ``cache`` for later calls: the kernel that takes its
    tickets and flags from it leaves it zero again (the call's last block
    resets what it used), so a call launches no zeroing of its own."""
    key = (device.type, device.index)
    buf = cache.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        cache[key] = buf
    return buf


#: The look-back counters of each device (`_sync_buffer`): the forward's,
#: and the gradient's own.
_SYNC_FWD: dict = {}
_SYNC_BWD: dict = {}


def _launch_bwd(x, Bm, Cm, dt, A_log, D, dy, dstate, chunk: int):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    for name, n in (("chunk", chunk), ("P", P), ("N", N)):
        if n > _MAX_DIM:
            raise ValueError(f"ssm_scan_bwd: {name}={n} is more than {_MAX_DIM}")
    tensors = (Bm, Cm, dt, A_log, D, dy) + (() if dstate is None else (dstate,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssm_scan_bwd: the inputs lie on different devices")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError(f"ssm_scan_bwd: x's (H, P) must be contiguous, strides {x.stride()}")
    if Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("ssm_scan_bwd: B and C must be contiguous along N")
    if not (dt.is_contiguous() and A_log.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssm_scan_bwd: dt, A_log and D must be contiguous")
    dy = dy.to(x.dtype).contiguous()
    if dstate is not None:
        dstate = dstate.to(torch.float32).contiguous()
    dev = x.device
    dx = torch.empty_like(dy)
    dB = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    dC = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    dA_log = torch.empty((H,), dtype=torch.float32, device=dev)
    dD = torch.empty((H,), dtype=torch.float32, device=dev)
    outs = (dx, dB, dC, ddt, dA_log, dD)
    if x.numel() == 0:
        return tuple(t.zero_() for t in outs)
    # Scratch (`bwd_scratch_floats`): the states every other chunk (fp32
    # 64 x 64, as the kernels' accumulators hold them) and the sums.
    n_states, n_parts = bwd_scratch_floats(B, S, H, N, chunk)
    states = torch.empty((n_states,), dtype=torch.float32, device=dev)
    parts = torch.empty((n_parts,), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return outs
    sync = _sync_buffer(_SYNC_BWD, dev, 3 + 2 * B * H)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = _build.library().repro_ssm_scan_bwd(
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
            D.data_ptr(), dy.data_ptr(), ptr(dstate), dx.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ddt.data_ptr(), dA_log.data_ptr(), dD.data_ptr(), states.data_ptr(),
            parts.data_ptr(), sync.data_ptr(), B, S, H, P, N, chunk, x.stride(0), x.stride(1),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "ssm_scan_bwd")
    ssm_scan_bwd.launches += 3                  # the state chains, the chunks, the sums
    return outs


def _forward(x, Bm, Cm, dt, A_log, D, chunk: int):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    peak = "bfloat16" if x.dtype == torch.bfloat16 else "float32"
    with kernel_scope("ssm_scan", lambda: work(x, Bm, Cm, dt, A_log, D, chunk), peak):
        if not x.is_cuda:
            return ssm_scan_plain(x, Bm, Cm, dt, A_log, D, chunk)
        return _launch(x, Bm, Cm, dt, A_log, D, chunk)


class _SSMScanFn(torch.autograd.Function):
    """Forward: `_forward`.  Backward: `ssm_scan_bwd`, the gradient kernels
    (their plain version for a CPU tensor).  Gradients are not
    materialised: an unused final state (training's case) reaches the
    backward as None, and the kernels read no (B, H, P, N) zeros."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A_log, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, Bm, Cm, dt, A_log, D)
        ctx.chunk = chunk
        return _forward(x, Bm, Cm, dt, A_log, D, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors           # unpacked once: remat allows no more
        if dy is None:
            dy = torch.zeros_like(saved[0])
        grads = ssm_scan_bwd(*saved, dy, dstate, ctx.chunk)
        return (*(g if n else None for g, n in zip(grads, ctx.needs_input_grad[:6])), None)


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
#: Kernel launches, three a call (never counts the plain version).
ssm_scan_bwd.launches = 0
