"""The Mamba2 scan's gradient (`kernels.ssm_scan.ssm_scan_bwd`, the backward
of `ssm_scan`'s autograd Function) held on the CPU, where the wrapper runs
its plain version `ssm_scan_bwd_plain`, the closed-form chunked gradient:
against `jax.grad` of the reference's `ssd_chunked` and against autograd
through the port's `ssd_chunked`, fp32 at `GRAD_TOL`'s rule (1e-4 of each
gradient's largest magnitude, at least 1, plus 1e-4 of each element: the
closed form sums in another order than autodiff); finite under a decay
whose exp overflows above the diagonal; the bf16 kernels' arithmetic
emulated in PyTorch (`_tensor_core_scan_bwd`) against the fp32 gradient at
`BWD_BF16_TOL`, with controls that must miss it; `work_bwd` at zamba2-7b's
training shape, the `meta` route's scope, the launcher's signature and the
kernels' names.  Inputs are made by numpy from a seed."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssm_scan as tscan
from repro_torch.launch import dryrun
from repro_torch.launch.op_stats import OpStats
from repro_torch.models import ssm as tssm

NAMES = ("x", "Bm", "Cm", "dt", "A_log", "D")
#: (B, S, H, P, N, chunk): one chunk; one segment of the kernels' state
#: chains (four chunks); three segments, the last of one chunk (nine
#: chunks: 4 + 4 + 1); P and N no multiple of 8, five chunks.
CASES = [(2, 16, 3, 8, 8, 16), (1, 64, 2, 16, 8, 16), (2, 144, 3, 8, 16, 16),
         (1, 160, 3, 12, 4, 32)]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _inputs(B, S, H, P, N, seed, strided=False):
    """(numpy arrays of x, Bm, Cm, dt, A_log, D; torch tensors of the same,
    x, B and C as column slices of one (B, S, H*P + 2N) tensor where
    ``strided``, as `mamba2_block` hands them to the kernel)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    conv = f(B, S, H * P + 2 * N)
    x, Bm, Cm = conv[..., :H * P].reshape(B, S, H, P), conv[..., H * P:H * P + N], \
        conv[..., H * P + N:]
    dt = np.log1p(np.exp(f(B, S, H)))                       # softplus
    A_log, D = f(H) * 0.5, f(H)
    arrays = [np.ascontiguousarray(a) for a in (x, Bm, Cm, dt, A_log, D)]
    if strided:
        t = torch.from_numpy(conv)
        views = [t[..., :H * P].unflatten(-1, (H, P)), t[..., H * P:H * P + N], t[..., H * P + N:]]
        return arrays, views + [torch.from_numpy(a) for a in arrays[3:]]
    return arrays, [torch.from_numpy(a) for a in arrays]


def _grad_close(got, want, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, err_msg=name, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_gradient_matches_jax_grad_and_autograd(case, with_state):
    """All six gradients of a weighted sum of y (and of the final state,
    where ``with_state``) against `jax.grad` of the reference's
    `ssd_chunked` and autograd through the port's; x, B and C strided in
    every other case."""
    B, S, H, P, N, chunk = case
    arrays, t = _inputs(B, S, H, P, N, seed=sum(case), strided=case[1] % 32 == 0)
    rng = np.random.default_rng(7)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_state else None

    def jloss(*args):
        y, s = jssm.ssd_chunked(*args, chunk)
        return (y * wy).sum() + ((s * ws).sum() if with_state else 0.0)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    leaves = [a.detach().clone().requires_grad_(True) for a in t]
    y, s = tssm.ssd_chunked(*leaves, chunk)
    loss = (y * torch.from_numpy(wy)).sum()
    if with_state:
        loss = loss + (s * torch.from_numpy(ws)).sum()
    autograd = torch.autograd.grad(loss, leaves)
    dstate = torch.from_numpy(ws) if with_state else None
    got = tscan.ssm_scan_bwd_plain(*t, torch.from_numpy(wy), dstate, chunk)
    for name, g, j, a in zip(NAMES, got, want, autograd):
        assert g.shape == a.shape and g.dtype == torch.float32, name
        _grad_close(g, _np(j), name)
        _grad_close(g, _np(a), name)


def test_the_function_backward_is_the_closed_form(monkeypatch):
    """`ssm_scan`'s Function takes its gradient from `ssm_scan_bwd` (the
    plain version here, bit for bit), handing it no final-state gradient
    where the state is unused; on the CPU nothing is launched."""
    B, S, H, P, N, chunk = 2, 64, 3, 8, 8, 16
    _, t = _inputs(B, S, H, P, N, seed=3, strided=True)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal((B, S, H, P))
                          .astype(np.float32))
    seen = []
    real = tscan.ssm_scan_bwd
    monkeypatch.setattr(tscan, "ssm_scan_bwd", lambda *a: seen.append(a[7]) or real(*a))
    before = real.launches
    leaves = [a.detach().clone().requires_grad_(True) for a in t]
    y, _ = tscan.ssm_scan(*leaves, chunk=chunk)
    assert type(y.grad_fn).__name__ == "_SSMScanFnBackward"
    grads = torch.autograd.grad(y, leaves, dy)
    assert seen == [None] and real.launches == before == 0
    want = tscan.ssm_scan_bwd_plain(*t, dy, None, chunk)
    for name, g, w in zip(NAMES, grads, want):
        assert torch.equal(g, w), name


def test_use_plain_takes_autograd_through_the_plain_scan():
    """Under `use_plain()` the scan is `ssd_chunked` itself (no Function), so
    the gradient is autograd's, the closed form's oracle; the two agree."""
    B, S, H, P, N, chunk = 1, 64, 2, 8, 8, 16
    _, t = _inputs(B, S, H, P, N, seed=5)
    dy = torch.ones((B, S, H, P))
    leaves = [a.detach().clone().requires_grad_(True) for a in t]
    with tops.use_plain():
        y, _ = tops.ssm_scan(*leaves, chunk=chunk)
    assert type(y.grad_fn).__name__ != "_SSMScanFnBackward"
    grads = torch.autograd.grad(y, leaves, dy)
    for name, g, w in zip(NAMES, grads, tscan.ssm_scan_bwd_plain(*t, dy, None, chunk)):
        _grad_close(w, _np(g), name)
    assert tscan.ssm_scan_bwd.launches == 0


def test_ssm_scan_bwd_refuses():
    _, t = _inputs(1, 32, 2, 8, 4, seed=6)
    dy = torch.zeros((1, 32, 2, 8))
    with pytest.raises(ValueError):
        tscan.ssm_scan_bwd(*t, dy[:, :16], None, 16)                 # dy's shape
    with pytest.raises(ValueError):
        tscan.ssm_scan_bwd(*t, dy, torch.zeros((1, 2, 8, 8)), 16)     # the state's N
    with pytest.raises(ValueError):
        tscan.ssm_scan_bwd(*t, dy, None, 12)                         # S % chunk
    with pytest.raises(TypeError):
        tscan.ssm_scan_bwd(t[0].double(), *t[1:], dy, None, 16)


def test_the_gradient_stays_finite_under_strong_decay():
    """A = -16 and dt = 0.1 over 64 steps: exp(cum_i - cum_j) overflows above
    the diagonal, where the reference's `jax.grad` gives nan in dt
    (tests/test_torch_ssm.py); the closed form masks the exponent first and
    equals autograd through the port's `ssd_chunked`, finite."""
    rng = np.random.default_rng(13)
    B, S, H, P, N, chunk = 1, 128, 2, 8, 4, 64
    x, Bm, Cm = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = torch.full((B, S, H), 0.1)
    A_log, D = torch.full((H,), float(np.log(16.0))), torch.ones((H,))
    args = (x, Bm, Cm, dt, A_log, D)
    dy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    got = tscan.ssm_scan_bwd_plain(*args, dy, None, chunk)
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = torch.autograd.grad(tssm.ssd_chunked(*leaves, chunk)[0], leaves, dy)
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        _grad_close(g, _np(w), name)


# ------------------------------------------- the bf16 kernels, emulated --
#: The bf16 kernels' allowance (chip_smoke.py's SSM_BWD_BF16_TOL): dx, dB
#: and dC, which the kernels write in bf16, within 2^-8 of their largest
#: magnitude plus 2^-6 of the element (the output's own rounding is 2^-9 of
#: it); ddt, dA_log and dD, fp32 sums that cancel, at `GRAD_TOL`'s rule.
#: The emulation's split operands put it at most at 0.03-0.6 of it (dx's
#: and dC's one output rounding the largest); w rounded once to bf16, or
#: the carried state gradient dropped at a segment edge, at 6 times it and
#: more (ddt's).
BWD_BF16_TOL = dict(max_share=2.0 ** -8, rtol=2.0 ** -6)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    return _bf16(t) + _bf16(t - _bf16(t))


def _segments(nc):
    """The chunks of each segment of the kernels' state chains (SEG 4)."""
    return [min(4, nc - s) for s in range(0, nc, 4)]


#: Chunks between two states the chains keep (csrc/ssm_scan_bwd.cu, R).
KEPT = tscan.BWD_STATE_CHUNKS


def _kept_states(up, dec, start, segs, reverse, drop_edge=False):
    """The states the chains keep, one a group of KEPT chunks: the start
    state of each group (forward) or the gradient at its end (``reverse``).
    Each segment of `_segments` sweeps its own chunks from zero in the
    chain's order, keeping its state after its first group in that order;
    then combines with its neighbour's inclusive state (``drop_edge``: left
    out past the first segment), as the look-back does."""
    nc = len(up)
    kept = [None] * (-(-nc // KEPT))
    carry, first = start, (nc if reverse else 0)
    for k, n in enumerate(reversed(segs) if reverse else segs):
        if reverse:
            first -= n
        chunks = range(first, first + n)
        order = list(reversed(chunks)) if reverse else list(chunks)
        n_first = n - KEPT * ((n - 1) // KEPT) if reverse else min(KEPT, n)
        if drop_edge and k > 0:
            carry = torch.zeros_like(carry)
        loc, dseg, mid, dmid = torch.zeros_like(carry), torch.ones_like(dec[0]), None, None
        for j, c in enumerate(order):
            loc = loc * dec[c][..., None, None] + up[c]
            dseg = dseg * dec[c]
            if j == n_first - 1:
                mid, dmid = loc, dseg
        near = (first + n - 1) // KEPT if reverse else first // KEPT
        kept[near] = carry
        if n > KEPT:
            kept[first // KEPT if reverse else first // KEPT + 1] = dmid[..., None, None] * carry + mid
        carry = dseg[..., None, None] * carry + loc
        if not reverse:
            first += n
    return kept


def _tensor_core_scan_bwd(x, Bm, Cm, dt, A_log, D, dy, dstate, chunk, w_cut=_split,
                          drop_edge=False):
    """The bf16 gradient kernels' arithmetic (csrc/ssm_scan_bwd.cu,
    `ssm_bwd_state_wgmma_kernel` + `ssm_bwd_chunk_wgmma_kernel` +
    `ssm_bwd_sum_kernel`) in PyTorch: bf16 inputs exact; C B^T and dy x^T
    exact; every fp32 operand of a product split into bf16 hi + lo (the
    chains' wl x and exp(cum) dy, the chunk pass's S_c and G_c) and the
    weighted matrices (C B^T) w and (dy x^T) w through ``w_cut``.  The
    chains keep a state every `KEPT` chunks (`_kept_states`: segments of
    four chunks, each from a zero start then combined with its neighbour's
    inclusive state; ``drop_edge``: the gradient chain's carried state left
    out at every segment edge); the chunk pass recomputes S_c from its
    group's start over the chunk before it, G_c from its group's end over
    the chunk after it, by the same split updates.  dx is wl (B G^T), then
    Wg^T dy and D dy added; dC takes e^cum (dy S) before Wm B.  The sums of
    cum's gradient in fp32.  dx, dB and dC rounded to bf16."""
    B, S, H, P = x.shape
    N, L = Bm.shape[-1], chunk
    nc = S // L
    f = torch.float32
    xc, dyc = x.reshape(B, nc, L, H, P).float(), dy.reshape(B, nc, L, H, P).float()
    Bc, Cc = Bm.reshape(B, nc, L, N).float(), Cm.reshape(B, nc, L, N).float()
    dtc = dt.reshape(B, nc, L, H).float()
    A = -torch.exp(A_log.float())
    cum = torch.cumsum(A * dtc, dim=2)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))[None, None, :, :, None]
    e = torch.exp((cum[:, :, :, None] - cum[:, :, None]).masked_fill(~tri, -np.inf))
    w = e * dtc[:, :, None]
    ec, el = torch.exp(cum), torch.exp(cum[:, :, -1:] - cum)
    wl, dec = el * dtc, torch.exp(cum[:, :, -1])

    # The chains' per-chunk updates, their A operands split; the kept states.
    T_up = torch.einsum("bclhp,bcln->bchpn", _split(wl[..., None] * xc), Bc)
    U_up = torch.einsum("bclhp,bcln->bchpn", _split(ec[..., None] * dyc), Cc)
    decs = [dec[:, c] for c in range(nc)]
    segs = _segments(nc)
    zero = torch.zeros((B, H, P, N), dtype=f)
    kept_s = _kept_states([T_up[:, c] for c in range(nc)], decs, zero, segs, False)
    kept_g = _kept_states([U_up[:, c] for c in range(nc)], decs,
                          zero if dstate is None else dstate.float(), segs, True, drop_edge)
    # Each chunk's states, recomputed from its group's over the group's other
    # chunk.
    starts, ends = [], []
    for c in range(nc):
        s_c, g_c = kept_s[c // KEPT], kept_g[c // KEPT]
        if c % KEPT:
            s_c = s_c * decs[c - 1][..., None, None] + T_up[:, c - 1]
        elif c + 1 < nc:
            g_c = g_c * decs[c + 1][..., None, None] + U_up[:, c + 1]
        starts.append(s_c)
        ends.append(g_c)
    S_c, G_c = torch.stack(starts, 1), torch.stack(ends, 1)

    Gm = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    Wg, Wm = w_cut(Gm[..., None] * w), w_cut(M * w)
    R = Gm[..., None] * M * e
    Uy = torch.einsum("bcihp,bchpn->bcihn", dyc, _split(S_c))
    V = torch.einsum("bcjn,bchpn->bcjhp", Bc, _split(G_c))
    Y = torch.einsum("bcjhp,bchpn->bcjhn", xc, _split(G_c))
    dx = wl[..., None] * V + torch.einsum("bcijh,bcihp->bcjhp", Wg, dyc) \
        + D.float()[:, None] * dyc
    dC = torch.einsum("bcih,bcihn->bcin", ec, Uy) + torch.einsum("bcijh,bcjn->bcin", Wm, Bc)
    dB = torch.einsum("bcijh,bcin->bcjn", Wm, Cc) + torch.einsum("bcjh,bcjhn->bcjn", wl, Y)
    col = R.sum(2)
    row = (R * dtc[:, :, None]).sum(3)
    d_ecum = torch.einsum("bcihn,bcin->bcih", Uy, Cc)
    d_wl = (V * xc).sum(-1)
    d_dec = (S_c * G_c).sum((-2, -1))
    dcum = row - dtc * col + d_ecum * ec - d_wl * wl
    dcum[:, :, -1] += (d_wl * wl).sum(2) + d_dec * dec
    rc = dcum.flip(2).cumsum(2).flip(2)
    ddt = col + d_wl * el + A * rc
    return (_bf16(dx.reshape(B, S, H, P)), _bf16(dB.reshape(B, S, N)),
            _bf16(dC.reshape(B, S, N)), ddt.reshape(B, S, H),
            A * (dtc * rc).sum((0, 1, 2)), (dyc * xc).sum((0, 1, 2, 4)))


def _bf16_case(case, seed):
    B, S, H, P, N, chunk = case
    _, t = _inputs(B, S, H, P, N, seed)
    t = [a.to(torch.bfloat16).float() if i < 3 else a for i, a in enumerate(t)]
    rng = np.random.default_rng(seed + 1)
    dy = _bf16(torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32)))
    ds = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(np.float32))
    return t, dy, ds


def _over_tol(got, want):
    """The largest error over its allowance of each gradient."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g.float() - w).abs()
        if i < 3:
            allowed = BWD_BF16_TOL["max_share"] * float(w.abs().max()) + BWD_BF16_TOL["rtol"] * w.abs()
        else:
            allowed = 1e-4 * max(1.0, float(w.abs().max())) + 1e-4 * w.abs()
        out.append(float((err / allowed).max()))
    return out


#: The emulation's cases: a few heads at zamba2-7b's P, N and chunk, three
#: segments; a small ragged one; five chunks, a count the kept states'
#: groups of two do not divide (segments of four and one); one chunk.
TC_CASES = [(1, 640, 4, 64, 64, 64), (2, 144, 3, 8, 16, 16), (1, 320, 3, 32, 16, 64),
            (2, 64, 2, 16, 8, 64)]


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_rounding_meets_the_bf16_allowance(case):
    t, dy, ds = _bf16_case(case, seed=41)
    want = tscan.ssm_scan_bwd_plain(*t, dy, ds, case[-1])
    got = _tensor_core_scan_bwd(*t, dy, ds, case[-1])
    ratios = _over_tol(got, want)
    assert max(ratios) <= 1.0, dict(zip(NAMES, ratios))


def test_the_allowance_refuses_a_dropped_state_gradient():
    case = TC_CASES[0]
    t, dy, ds = _bf16_case(case, seed=41)
    want = tscan.ssm_scan_bwd_plain(*t, dy, ds, case[-1])
    ratios = _over_tol(_tensor_core_scan_bwd(*t, dy, ds, case[-1], drop_edge=True), want)
    assert max(ratios) > 1.0, dict(zip(NAMES, ratios))


#: chip_smoke.py's float64 gate (`check_ssm_bwd_f64`): the mean |g - g64| of
#: dx, dB and dC, which the kernels write in bf16, at most SSM_F64_LIMIT
#: times that of the plain fp32 gradient rounded once to bf16.  The split
#: puts the emulation at 1.00 of it (the output's rounding is all); w
#: rounded once at 1.4-1.6, the dropped state gradient at 3.7 and more.  (The
#: per-element allowance above cannot see w's rounding: the output's own
#: rounding is as large.)
SSM_F64_LIMIT = 1.1


@pytest.mark.parametrize("control", [None, "w rounded once", "state gradient dropped at an edge"])
def test_the_float64_gate_passes_the_split_and_refuses_its_controls(control):
    case = (1, 640, 4, 64, 64, 64)
    t, dy, _ = _bf16_case(case, seed=45)
    g64 = tscan.ssm_scan_bwd_plain(*t, dy, None, case[-1], compute=torch.float64)
    plain = tscan.ssm_scan_bwd_plain(*t, dy, None, case[-1])
    kwargs = {None: {}, "w rounded once": dict(w_cut=_bf16),
              "state gradient dropped at an edge": dict(drop_edge=True)}[control]
    got = _tensor_core_scan_bwd(*t, dy, None, case[-1], **kwargs)
    ratios = [float((g.double() - w).abs().mean() / (_bf16(p).double() - w).abs().mean())
              for g, p, w in zip(got[:3], plain[:3], g64[:3])]
    if control is None:
        assert max(ratios) <= SSM_F64_LIMIT, ratios
    else:
        assert max(ratios) > SSM_F64_LIMIT, ratios


def test_the_emulation_in_float_is_the_closed_form():
    """With nothing cut and nothing dropped the emulation is the plain
    gradient (up to fp32 sums in another order): the controls above move
    only what they name."""
    case = (1, 320, 2, 16, 8, 32)
    t, dy, ds = _bf16_case(case, seed=43)
    want = tscan.ssm_scan_bwd_plain(*t, dy, ds, case[-1])
    got = _tensor_core_scan_bwd(*t, dy, ds, case[-1], w_cut=lambda a: a)
    got = list(got)
    for name, g, w in zip(NAMES[3:], got[3:], want[3:]):
        _grad_close(g, _np(w), name)


# --------------------------------------------------- the card's route --
def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_work_bwd_at_zamba2s_training_shape():
    """Ten products of 64 x 64 x 64 a (b, h, chunk), 7.5e10 operations
    (0.0760 ms at the bf16 peak); 363.9 MB moved (0.1086 ms at 3.35 TB/s):
    bound by bytes; the final state's gradient counted where there is one."""
    B, S, H, P, N, L = 2, 4096, 112, 64, 64, 64
    x, bm = _meta((B, S, H, P)), _meta((B, S, N))
    dt, h = _meta((B, S, H), torch.float32), _meta((H,), torch.float32)
    flops, nbytes = tscan.work_bwd(x, bm, bm, dt, h, h, L)
    assert flops == 2 * 10 * L * 64 * 64 * B * H * (S // L) == 75_161_927_680
    assert nbytes == (3 * B * S * H * P + 4 * B * S * N) * 2 + 2 * B * S * H * 4 + 4 * H * 4
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.1086
    assert round(flops / 989e12 * 1e3, 4) == 0.0760
    assert tscan.work_bwd(x, bm, bm, dt, h, h, L, True)[1] == nbytes + B * H * P * N * 4


def test_a_meta_backward_is_one_scope_with_its_work():
    """On ``meta`` the Function's backward takes the card's route inside one
    `ssm_scan_bwd` scope, which the tally counts by `work_bwd`."""
    B, S, H, P, N, L = 2, 256, 4, 64, 64, 64
    leaves = [_meta((B, S, H, P)), _meta((B, S, N)), _meta((B, S, N)),
              _meta((B, S, H), torch.float32), _meta((H,), torch.float32),
              _meta((H,), torch.float32)]
    leaves = [a.requires_grad_(True) for a in leaves]
    y, _ = tscan.ssm_scan(*leaves, chunk=L)
    dy = torch.ones_like(y)
    with OpStats() as tally:
        grads = torch.autograd.grad(y, leaves, dy)
    row = tally.row()
    assert all(g.is_meta and g.shape == a.shape for g, a in zip(grads, leaves))
    assert row["scopes"] == {"ssm_scan_bwd": 1}
    assert (row["flops"], row["bytes"]) == tscan.work_bwd(*leaves, L)


def test_the_launcher_and_the_kernels_names():
    """The launcher's C signature (31 arguments), its kernels' names in the
    source and in the dry run's table: none holds another wrapper's names
    and no other wrapper's name holds one of them; three launches a scope."""
    text = (_build.CSRC / "ssm_scan_bwd.cu").read_text()
    assert 'extern "C" int repro_ssm_scan_bwd(' in text
    assert len(_build.SIGNATURES["repro_ssm_scan_bwd"]) == 31
    mine = dryrun._KERNEL_NAMES["ssm_scan_bwd"]
    assert set(tscan.BWD_KERNELS) <= set(mine)
    for k in mine:
        assert re.search(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+" + k + r"\(", text), k
    for other, theirs in dryrun._KERNEL_NAMES.items():
        if other != "ssm_scan_bwd":
            assert not any(a in b or b in a for a in mine for b in theirs), other
    assert dryrun.LAUNCHES_A_SCOPE["ssm_scan_bwd"] == 3
    assert "ssm_scan_bwd" in dryrun._wrapper_launches()


# ------------------------------------------------ the kept states, scratch --
@pytest.mark.parametrize("nc", [1, 2, 5, 7, 9])
def test_the_kept_states_give_every_chunks_states(nc):
    """The states the chains keep every `KEPT` chunks (`_kept_states`),
    with the chunk pass's one update over the group's other chunk, are the
    chunks' start states and end gradients of the sequential chains, in
    float64: a count of chunks that groups of two do not divide (5, 7, 9),
    segments of one, two and three chunks, one chunk."""
    rng = np.random.default_rng(nc)
    B, H, P, N = 2, 3, 4, 5
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))
    up = [t(B, H, P, N) for _ in range(nc)]
    dec = [torch.from_numpy(rng.uniform(0.5, 1.0, (B, H))) for _ in range(nc)]
    final = t(B, H, P, N)
    state, starts = torch.zeros_like(final), []
    for c in range(nc):
        starts.append(state)
        state = state * dec[c][..., None, None] + up[c]
    grad, ends = final, [None] * nc
    for c in reversed(range(nc)):
        ends[c] = grad
        grad = grad * dec[c][..., None, None] + up[c]
    segs = _segments(nc)
    kept_s = _kept_states(up, dec, torch.zeros_like(final), segs, False)
    kept_g = _kept_states(up, dec, final, segs, True)
    assert len(kept_s) == len(kept_g) == -(-nc // KEPT)
    for c in range(nc):
        s_c, g_c = kept_s[c // KEPT], kept_g[c // KEPT]
        if c % KEPT:
            s_c = s_c * dec[c - 1][..., None, None] + up[c - 1]
        elif c + 1 < nc:
            g_c = g_c * dec[c + 1][..., None, None] + up[c + 1]
        torch.testing.assert_close(s_c, starts[c], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(g_c, ends[c], rtol=1e-12, atol=1e-12)


def test_the_scratch_at_zamba2s_training_shape():
    """The wrapper's fp32 scratch (`bwd_scratch_floats`) at zamba2-7b's
    training shape: the kept states, a start state and an end gradient every
    two chunks, 2 x 117.4 MB (every chunk's were 2 x 234.9 MB); the sums of
    dB and dC over 7 head groups of 16 and of dA_log and dD per (b, chunk,
    head), 29.5 MB."""
    B, S, H, P, N, L = 2, 4096, 112, 64, 64, 64
    states, parts = tscan.bwd_scratch_floats(B, S, H, N, L)
    assert states * 4 == 2 * 117_440_512 <= 2 * 118e6
    assert states * 2 == 2 * B * (S // L) * H * 64 * 64          # every chunk's, halved
    assert parts == 2 * B * S * 7 * N + 2 * B * (S // L) * H
    assert tscan.bwd_scratch_floats(1, 320, 3, 16, 64)[0] == 2 * 3 * 3 * 64 * 64   # 5 chunks: 3 groups


def test_the_sources_constants_are_the_wrappers():
    """The kernels' chunks between kept states, heads a chunk block and
    chunks a chain segment are the wrapper's (the scratch follows them)."""
    text = (_build.CSRC / "ssm_scan_bwd.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    assert const("R") == tscan.BWD_STATE_CHUNKS == KEPT
    assert const("HB") == tscan.BWD_HEAD_GROUP
    assert const("SEG") == tscan.SEGMENT_CHUNKS
