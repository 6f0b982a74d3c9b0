"""The Mamba2 layer of the port against the reference, on the CPU: the conv,
the chunked and sequential scans, the `ssm_scan` kernel's plain version
against the interpret-mode Pallas kernel, the kernel's autograd Function
against `jax.grad`, and `mamba2_block` on its three routes.  Inputs are
made with numpy from a seed and handed to both.

Tolerances.  bf16 5e-2 and the scan's final state 1e-3 (those of
tests/test_kernels.py).  fp32 scan outputs: 2e-5 of the output's largest
magnitude (atol) plus 2e-5 of each element (rtol).  An elementwise 2e-5
cannot hold between two fp32 scans that add in different orders: y_i sums
terms exp(cum_i - cum_j)·(C_i·B_j)·dt_j·x_j, where cum is a running sum of
up to ~50 in magnitude, so each exponent carries ~1e-6 of rounding and an
output that is small beside its terms moves by more than 2e-5 of itself.
Measured on these inputs: the reference's own fp32 `ssd_chunked` is 1.5
times the elementwise allowance away from the same function evaluated in
float64; it agrees with the Pallas kernel only because both run XLA's
order of operations.  Model-level outputs (after the gated RMSNorm) at
1e-4, as in tests/test_torch_transformer.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro.configs import get_config as jget_config
from repro.models import reduced as jreduced
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssm_scan as tscan
from repro_torch.models import reduced as treduced
from repro_torch.models import ssm as tssm

# (B, S, H, P, N, chunk): the cases of tests/test_kernels.py::TestSsmScan
SCAN_CASES = [(1, 128, 2, 16, 8, 32), (2, 256, 4, 64, 16, 64), (2, 192, 3, 32, 64, 64)]
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _scan_tol(want, bf16=False):
    if bf16:
        return dict(atol=5e-2, rtol=5e-2)
    return dict(atol=2e-5 * max(1.0, float(np.abs(want).max())), rtol=2e-5)


def _scan_inputs(B, S, H, P, N, seed, bf16=False):
    """(jax arrays, torch tensors) of x, Bm, Cm, dt, A_log, D, as the
    reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bm, Cm = f(B, S, H, P), f(B, S, N), f(B, S, N)
    dt = np.log1p(np.exp(f(B, S, H)))                       # softplus
    A_log, D = f(H) * 0.5, f(H)
    wide = (x, Bm, Cm)
    jt = jnp.bfloat16 if bf16 else jnp.float32
    tt = torch.bfloat16 if bf16 else torch.float32
    j = [jnp.asarray(a, jt) for a in wide] + [jnp.asarray(a) for a in (dt, A_log, D)]
    t = [torch.from_numpy(a).to(tt) for a in wide] + [torch.from_numpy(a) for a in (dt, A_log, D)]
    return j, t


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# ------------------------------------------------------------------ conv --
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 7, 12), (4, 12), (12,)))
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    jo, js = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    to, ts = tssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(_np(ts), _np(js))


# ----------------------------------------------------------------- scans --
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_jax(init):
    B, S, H, P, N = 2, 96, 3, 8, 4
    j, t = _scan_inputs(B, S, H, P, N, seed=2)
    s0 = np.random.default_rng(3).standard_normal((B, H, P, N)).astype(np.float32)
    jy, js = jssm.ssd_chunked(*j, 16, init_state=jnp.asarray(s0) if init else None)
    ty, ts = tssm.ssd_chunked(*t, 16, init_state=torch.from_numpy(s0) if init else None)
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **_scan_tol(_np(jy)))
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_reference_matches_jax(init):
    B, S, H, P, N = 2, 40, 3, 8, 4
    j, t = _scan_inputs(B, S, H, P, N, seed=4)
    s0 = np.random.default_rng(5).standard_normal((B, H, P, N)).astype(np.float32)
    jy, js = jssm.ssd_reference(*j, init_state=jnp.asarray(s0) if init else None)
    ty, ts = tssm.ssd_reference(*t, init_state=torch.from_numpy(s0) if init else None)
    np.testing.assert_allclose(_np(ty), _np(jy), **_scan_tol(_np(jy)))
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-3, rtol=1e-3)


def test_chunked_matches_sequential():
    """The chunked oracle against the step-by-step scan, in the port alone
    (tests/test_kernels.py's check, at its tolerance)."""
    _, t = _scan_inputs(2, 96, 3, 8, 4, seed=6)
    y1, s1 = tref.ssm_scan_ref(*t, chunk=16)
    y2, s2 = tref.ssm_scan_sequential_ref(*t)
    np.testing.assert_allclose(_np(y1), _np(y2), atol=1e-4)
    np.testing.assert_allclose(_np(s1), _np(s2), atol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssm_scan_plain_matches_pallas(case, bf16):
    """The port's kernel entry (its plain version on the CPU) against the
    Pallas kernel in interpret mode."""
    B, S, H, P, N, chunk = case
    j, t = _scan_inputs(B, S, H, P, N, seed=7, bf16=bf16)
    jy, js = jops.ssm_scan(*j, chunk=chunk)
    for fn in (tops.ssm_scan, tscan.ssm_scan, tscan.ssm_scan_plain):
        ty, ts = fn(*t, chunk=chunk)
        assert ty.shape == (B, S, H, P) and ts.shape == (B, H, P, N)
        assert ts.dtype == torch.float32
        np.testing.assert_allclose(_np(ty), _np(jy), **_scan_tol(_np(jy), bf16))
        np.testing.assert_allclose(_np(ts), _np(js), atol=1e-3, rtol=1e-3)


def test_ssm_scan_decay_property():
    """tests/test_kernels.py's property on the port: with decay exp(-50) a
    step the late outputs do not see far-past inputs."""
    B, S, H, P, N = 1, 128, 1, 8, 4
    _, (x, Bm, Cm, _, _, _) = _scan_inputs(B, S, H, P, N, seed=8)
    dt = torch.full((B, S, H), 50.0)
    A_log, D = torch.zeros(H), torch.zeros(H)
    y1, _ = tops.ssm_scan(x, Bm, Cm, dt, A_log, D, chunk=32)
    x2 = x.clone()
    x2[:, :64] = 123.0
    y2, _ = tops.ssm_scan(x2, Bm, Cm, dt, A_log, D, chunk=32)
    np.testing.assert_allclose(_np(y1[:, -16:]), _np(y2[:, -16:]), atol=1e-3)
    assert not np.allclose(_np(y1[:, :64]), _np(y2[:, :64]), atol=1e-3)


def test_ssm_scan_gradient_matches_jax_grad():
    """The kernel's autograd Function (plain forward on the CPU, plain
    recompute in the backward) against `jax.grad` of a weighted sum of the
    reference's `ssd_chunked` output and final state."""
    B, S, H, P, N, chunk = 2, 64, 3, 8, 8, 16
    j, t = _scan_inputs(B, S, H, P, N, seed=9)
    rng = np.random.default_rng(10)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def jloss(*args):
        y, s = jssm.ssd_chunked(*args, chunk)
        return (y * wy).sum() + (s * ws).sum()

    want = jax.grad(jloss, argnums=tuple(range(6)))(*j)
    leaves = [a.clone().requires_grad_(True) for a in t]
    y, s = tscan.ssm_scan(*leaves, chunk=chunk)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "_SSMScanFnBackward"
    ((y * torch.from_numpy(wy)).sum() + (s * torch.from_numpy(ws)).sum()).backward()
    for name, a, g in zip(("x", "Bm", "Cm", "dt", "A_log", "D"), leaves, want):
        np.testing.assert_allclose(_np(a.grad), _np(g), err_msg=name,
                                   atol=1e-4 * max(1.0, float(np.abs(_np(g)).max())), rtol=1e-4)


def test_ssd_chunked_gradient_stays_finite_under_strong_decay():
    """A chunk whose decays sum past ~88 (A = -16, dt = 0.1, 64 steps: 102)
    overflows exp(cum_i - cum_j) above the diagonal.  The reference masks
    after the exp, so its gradients in dt and A_log are nan there; the port
    masks the exponent first: the same forward, finite gradients, equal to
    the reference's wherever those are finite."""
    rng = np.random.default_rng(13)
    B, S, H, P, N, chunk = 1, 64, 2, 8, 4, 64
    x, Bm, Cm = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = np.full((B, S, H), 0.1, np.float32)
    A_log, D = np.full((H,), np.log(16.0), np.float32), np.ones((H,), np.float32)
    args = (x, Bm, Cm, dt, A_log, D)
    jy, _ = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    jg = jax.grad(lambda *a: jssm.ssd_chunked(*a, chunk)[0].sum(), argnums=tuple(range(6)))(
        *map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ty, _ = tssm.ssd_chunked(*leaves, chunk)
    ty.sum().backward()
    np.testing.assert_allclose(_np(ty), _np(jy), **_scan_tol(_np(jy)))
    for name, a, g in zip(("x", "Bm", "Cm", "dt", "A_log", "D"), leaves, jg):
        got, want = _np(a.grad), _np(g)
        assert np.isfinite(got).all(), name
        if np.isfinite(want).all():
            np.testing.assert_allclose(got, want, err_msg=name,
                                       atol=1e-4 * max(1.0, float(np.abs(want).max())),
                                       rtol=1e-4)
    assert not np.isfinite(_np(jg[3])).all()          # the reference's nan, in dt


def test_ssm_scan_function_skips_what_needs_no_gradient():
    _, t = _scan_inputs(1, 32, 2, 8, 4, seed=11)
    x = t[0].clone().requires_grad_(True)
    y, s = tscan.ssm_scan(x, *t[1:], chunk=16)
    y.sum().backward()
    assert x.grad is not None and all(a.grad is None for a in t[1:])
    with torch.no_grad():
        y2, _ = tscan.ssm_scan(x, *t[1:], chunk=16)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


def test_ssm_scan_refuses():
    _, t = _scan_inputs(1, 32, 2, 8, 4, seed=12)
    x, Bm, Cm, dt, A_log, D = t
    with pytest.raises(TypeError):
        tscan.ssm_scan(x.half(), Bm.half(), Cm.half(), dt, A_log, D, chunk=16)
    with pytest.raises(TypeError):
        tscan.ssm_scan(x, Bm.bfloat16(), Cm, dt, A_log, D, chunk=16)
    with pytest.raises(TypeError):
        tscan.ssm_scan(x, Bm, Cm, dt.double(), A_log, D, chunk=16)
    with pytest.raises(ValueError):
        tscan.ssm_scan(x, Bm, Cm, dt, A_log, D, chunk=10)          # 32 % 10
    with pytest.raises(ValueError):
        tscan.ssm_scan(x, Bm[:, :16], Cm[:, :16], dt, A_log, D, chunk=16)
    with pytest.raises(ValueError):
        tscan.ssm_scan(x, Bm, Cm, dt, A_log[:1], D, chunk=16)


# ----------------------------------------------------------------- block --
@pytest.fixture(scope="module")
def zamba():
    jcfg = jreduced(jget_config("zamba2-7b"), vocab_size=64)
    tcfg = treduced(tget_config("zamba2-7b"), vocab_size=64)
    params = jssm.init_mamba2(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def test_init_mamba2_leaves_equal_the_reference(zamba):
    jcfg, tcfg, params, _ = zamba
    own = tssm.init_mamba2(torch.Generator("cpu").manual_seed(0), tcfg, torch.float32)
    want = jax.tree.map(np.asarray, params)
    assert sorted(own) == sorted(want)
    for k in own:
        got = own[k]["w"] if k in ("in_proj", "out_proj") else own[k]
        ref = want[k]["w"] if k in ("in_proj", "out_proj") else want[k]
        assert tuple(got.shape) == ref.shape and str(got.dtype) == f"torch.{ref.dtype}", k
    a = own["A_log"].exp()
    dt0 = torch.nn.functional.softplus(own["dt_bias"])
    assert bool((a >= 1 - 1e-5).all() and (a <= 16 + 1e-4).all())
    assert bool((dt0 >= 1e-3 - 1e-7).all() and (dt0 <= 1e-1 + 1e-6).all())
    assert bool((own["D"] == 1).all() and (own["norm_scale"] == 1).all())
    assert bool((own["conv_b"] == 0).all()) and 0.05 < float(own["conv_w"].std()) < 0.2
    cache = tssm.init_ssm_cache(tcfg, 3, device="cpu")
    jcache = jssm.init_ssm_cache(jcfg, 3)
    for k in ("conv", "state"):
        assert tuple(cache[k].shape) == jcache[k].shape
    assert cache["state"].dtype == torch.float32
    bf = tssm.init_ssm_cache(treduced(tget_config("zamba2-7b"), compute_dtype="bfloat16"), 1,
                             device="cpu")
    assert bf["state"].dtype == torch.float32 and bf["conv"].dtype == torch.bfloat16


def _block_pair(zamba, S, cache, seed):
    jcfg, tcfg, params, tparams = zamba
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jc = tc = None
    if cache:
        d_inner, H, N = tssm._dims(tcfg)
        conv = rng.standard_normal((2, tcfg.ssm_conv - 1, d_inner + 2 * N)).astype(np.float32)
        state = rng.standard_normal((2, H, tcfg.mamba_headdim, N)).astype(np.float32) * 0.1
        jc = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
        tc = {"conv": torch.from_numpy(conv.copy()), "state": torch.from_numpy(state.copy())}
    jo, jnc = jssm.mamba2_block(params, jnp.asarray(x), jcfg, jc)
    to, tnc = tssm.mamba2_block(tparams, torch.from_numpy(x), tcfg, tc)
    np.testing.assert_allclose(_np(to), _np(jo), **MODEL_TOL)
    if cache:
        assert tnc is tc                               # updated in place
        np.testing.assert_allclose(_np(tc["conv"]), _np(jnc["conv"]), **MODEL_TOL)
        np.testing.assert_allclose(_np(tc["state"]), _np(jnc["state"]), atol=1e-3, rtol=1e-3)
    else:
        assert tnc is None and jnc is None


@pytest.mark.parametrize("S,cache,route", [
    (32, False, "kernel"),           # no cache, S % ssm_chunk == 0: ssm_scan
    (24, False, "chunk=1"),          # no cache, S % ssm_chunk != 0: ssd_chunked, chunk 1
    (1, True, "decode"),             # S == 1 with a cache: ssd_reference
    (7, True, "prefill"),            # cache and S % chunk != 0: ssd_chunked with init_state
    (16, True, "prefill-chunked"),   # cache, S % chunk == 0: still ssd_chunked (state given)
])
def test_mamba2_block_routes_match_jax(zamba, S, cache, route, monkeypatch):
    calls = []
    real = tscan.ssm_scan
    monkeypatch.setattr(tscan, "ssm_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    _block_pair(zamba, S, cache, seed=20 + S)
    assert len(calls) == (1 if route == "kernel" else 0)


# ------------------------------------------- the tensor-core instance's rounding --
# chip_smoke.py's allowances for the bf16 scan: y at 5e-3 + 1e-2·|want| (one
# bf16 rounding of nearly equal values), the fp32 state at 1e-3.
BF16_Y_TOL = dict(atol=5e-3, rtol=1e-2)
STATE_TOL = dict(atol=1e-3, rtol=1e-3)


def _tf32(t):
    """fp32 -> tf32 as the tensor cores read an fp32 operand: the low 13
    mantissa bits cleared."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


#: How the kernel's fp32 operands (W, the carried state, wl·x) reach the
#: tensor cores: split into bf16 hi + lo (the kernel), or cut once.
CUTS = {"bf16x2": lambda a: _bf16(a) + _bf16(a - _bf16(a)), "bf16": _bf16, "tf32": _tf32,
        None: lambda a: a}


def _segments(nc, n_seg=None):
    """Chunks of each segment: the kernel's split (`SEGMENT_CHUNKS` a
    segment, the last shorter) or ``n_seg`` segments as even as they go,
    some empty when there are more segments than chunks."""
    if n_seg is None:
        k = tscan.SEGMENT_CHUNKS
        return [min(k, nc - i) for i in range(0, nc, k)]
    return [len(a) for a in np.array_split(np.arange(nc), n_seg)]


def _tensor_core_scan(x, Bm, Cm, dt, A_log, D, chunk, cut="bf16x2", n_seg=None,
                      dtype=torch.float32, state_cut=None):
    """The bf16 `ssm_scan` kernel's arithmetic (csrc/ssm_scan.cu,
    `ssm_scan_wgmma_kernel`) in PyTorch on the CPU.  C B^T from the bf16
    values (exact products); W, the carried state and wl·x, the fp32
    operands of the other products, taken through ``cut`` (the state through ``state_cut`` where given); x,
    B and C exact.  The sequence is split into segments (`_segments`):
    sweep 1 gives each its
    end state S_loc from a zero start and its decay dseg; the look-back
    combines dseg · S_in + S_loc with the segment before's inclusive state
    S_in; sweep 2 computes y from the true start states.  ``dtype`` float64
    with ``cut`` None is the scan in float64.  Returns (y in x's type (as
    ``dtype`` when that is float64), state)."""
    R = CUTS[cut]
    Rs = CUTS[state_cut or cut]
    B, S, H, P = x.shape
    N, nc, f = Bm.shape[-1], S // chunk, dtype
    xc = x.reshape(B, nc, chunk, H, P).to(f)
    Bc, Cc = (t.reshape(B, nc, chunk, N).to(f) for t in (Bm, Cm))
    dtc = dt.reshape(B, nc, chunk, H).to(f)
    cum = torch.cumsum(-torch.exp(A_log.to(f)) * dtc, dim=2)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))[None, None, :, :, None]
    decay = torch.exp((cum[:, :, :, None] - cum[:, :, None]).masked_fill(~tri, -np.inf))
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    W = R(G[..., None] * (decay * dtc[:, :, None]))                      # (B,nc,i,j,H)
    wl = torch.exp(cum[:, :, -1:] - cum) * dtc                           # (B,nc,L,H)
    wx = R(wl[..., None] * xc)                                           # (B,nc,L,H,P)
    dec = torch.exp(cum[:, :, -1])                                       # (B,nc,H)
    dS = torch.einsum("bclhp,bcln->bchpn", wx, Bc)                       # (B,nc,H,P,N)
    ys, s_prev, c0 = [], torch.zeros((B, H, P, N), dtype=f), 0
    for n in _segments(nc, n_seg):
        chunks = range(c0, c0 + n)
        c0 += n
        s_loc, dseg = torch.zeros_like(s_prev), torch.ones((B, H), dtype=f)
        for c in chunks:                                                 # sweep 1
            s_loc = s_loc * dec[:, c, :, None, None] + dS[:, c]
            dseg = dseg * dec[:, c]
        state, s_prev = s_prev, dseg[..., None, None] * s_prev + s_loc   # the look-back
        for c in chunks:                                                 # sweep 2
            inter = torch.einsum("bin,bhpn->bihp", Cc[:, c], Rs(state))
            ys.append(torch.exp(cum[:, c])[..., None] * inter
                      + torch.einsum("bijh,bjhp->bihp", W[:, c], xc[:, c]))
            state = state * dec[:, c, :, None, None] + dS[:, c]
    y = torch.stack(ys, 1) + xc * D.to(f)[:, None]
    return y.reshape(B, S, H, P).to(x.dtype if f == torch.float32 else f), s_prev


TC_CASES = SCAN_CASES + [(2, 96, 3, 16, 8, 32), (1, 64, 3, 12, 4, 16), (1, 64, 2, 7, 4, 16),
                         (1, 320, 2, 64, 64, 64)]     # the last: the training shape's P, N, chunk


@functools.lru_cache(maxsize=None)
def _pallas_bf16(case):
    """The Pallas kernel in interpret mode on `_scan_inputs`' bf16 inputs
    (seed 30), and those inputs as torch tensors."""
    B, S, H, P, N, chunk = case
    j, t = _scan_inputs(B, S, H, P, N, seed=30, bf16=True)
    jy, js = jops.ssm_scan(*j, chunk=chunk)
    return _np(jy), _np(js), t


def _split_count(nc, split):
    """The segment count a test names: the kernel's split (None), 1, 2, one
    that does not divide the chunks, or more than there are chunks."""
    return {"kernel": None, "one": 1, "two": 2,
            "ragged": next(k for k in range(2, nc + 2) if nc % k), "more": nc + 2}[split]


@pytest.mark.parametrize("split", ["kernel", "one", "two", "ragged", "more"])
@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_rounding_meets_the_bf16_allowance(case, split):
    """The kernel's bf16 hi + lo products and its split of the sequence,
    emulated, against the Pallas kernel in interpret mode on the same bf16
    inputs, at chip_smoke.py's bf16 allowances, for each way of cutting
    the chunks into segments."""
    jy, js, t = _pallas_bf16(case)
    chunk = case[-1]
    ty, ts = _tensor_core_scan(*t, chunk, n_seg=_split_count(case[1] // chunk, split))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), jy, **BF16_Y_TOL)
    np.testing.assert_allclose(_np(ts), js, **STATE_TOL)


def test_the_segments_follow_the_kernel_and_the_edges():
    assert _segments(16) == [4, 4, 4, 4] and _segments(65) == [4] * 16 + [1]
    assert _segments(1) == [1] and _segments(3) == [3]
    assert _segments(4, 3) == [2, 1, 1] and _segments(2, 4) == [1, 1, 0, 0]
    assert [_split_count(n, "ragged") for n in (3, 4, 6)] == [2, 3, 4]


def _train_shape_ratio(cut, state_cut=None):
    """The emulation's largest error over the bf16 allowance at the training
    shape's P, N and chunk, against the plain version, under ``cut``."""
    B, S, H, P, N, chunk = 1, 512, 4, 64, 64, 64
    _, t = _scan_inputs(B, S, H, P, N, seed=31, bf16=True)
    want, _ = tssm.ssd_chunked(*t, chunk)
    allowed = BF16_Y_TOL["atol"] + BF16_Y_TOL["rtol"] * want.abs()
    y = _tensor_core_scan(*t, chunk, cut, state_cut=state_cut)[0]
    return float(((y.float() - want).abs() / allowed).max())


def test_one_tf32_rounding_alone_misses_the_bf16_allowance():
    """Why the kernel splits its fp32 operands: cut once to tf32 (10
    mantissa bits), W, the state and wl·x move y beyond the bf16 allowance
    at the training shape's P, N and chunk, where the kernel's bf16 hi + lo
    stays within it."""
    ratio = {cut: _train_shape_ratio(cut) for cut in ("bf16x2", "tf32")}
    assert ratio["bf16x2"] <= 1.0 < ratio["tf32"], ratio


def test_one_bf16_rounding_misses_the_bf16_allowance():
    """The control of the kernel's split: with one bf16 rounding of W, the
    state and wl·x (one rounding fewer) the emulation misses the allowance
    at the training shape's P, N and chunk."""
    assert _train_shape_ratio("bf16") > 1.0


def test_one_bf16_rounding_of_the_state_alone_misses_the_bf16_allowance():
    """Why C S^T takes two products: with the carried state alone cut once
    to bf16 (W and wl·x split), y misses the allowance at the training
    shape's P, N and chunk."""
    assert _train_shape_ratio("bf16x2", state_cut="bf16") > 1.0


@pytest.mark.parametrize("cut,passes", [("bf16x2", True), ("bf16", False)])
def test_the_float64_gate_passes_the_split_and_refuses_one_rounding(cut, passes):
    """chip_smoke.py's gate (`check_ssm_f64`) on the emulation: its mean
    |y - y64| within 1.1 times that of y64 rounded once to bf16 with the
    kernel's split, beyond it with one rounding."""
    B, S, H, P, N, chunk = 1, 512, 4, 64, 64, 64
    _, t = _scan_inputs(B, S, H, P, N, seed=32, bf16=True)
    y64, _ = _tensor_core_scan(*t, chunk, cut=None, n_seg=1, dtype=torch.float64)
    once = float((_bf16(y64) - y64).abs().mean())
    got = float((_tensor_core_scan(*t, chunk, cut)[0].double() - y64).abs().mean())
    assert (got <= 1.1 * once) == passes, got / once
