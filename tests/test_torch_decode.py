"""The bf16 tensor-core `decode_attention` kernel's arithmetic, emulated in
PyTorch on the CPU, against the reference on the same numpy inputs.

`_tensor_core_decode` repeats `decode_bf16_tc_kernel` (csrc/decode_attention
.cu) in its order: the splits of `split_plan`, key tiles of 64 in each, 16
keys of every tile to each of 4 warps, an online softmax a warp in log2
units, P split into three bf16 parts (hi + mid + lo) for P·V, each
16-key product summed apart and then added to O, the warps merged in
order, then the live splits merged in index order.  The kernel itself runs on the card
only (chip_smoke.py holds it against the plain version there).

Tolerance: one bf16 step of the output, chip_smoke.py's
``FLASH_TOL["bfloat16"]["out"]``: atol 5e-3, rtol 1e-2.  A right kernel's
output is one rounding to bf16 of an fp32 value close to the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tree_to_numpy
from repro_torch.kernels.decode_attention import kernel_instance, split_plan

BF16_OUT_TOL = dict(atol=5e-3, rtol=1e-2)
LOG2E = 1.4426950408889634
TILE, WARPS = 64, 4


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split_bf16(p, parts):
    """p as the sum of ``parts`` bf16 values, largest first."""
    out = []
    for _ in range(parts):
        out.append(_bf16(p))
        p = p - out[-1]
    return out


def _tensor_core_decode(q, k, v, kv_len, parts=3):
    """Output (fp32, before its rounding to bf16) of the tensor-core kernel
    for q ``(B, 1, Hq, D)`` and caches ``(B, Sk, Hkv, D)``, bf16, with
    ``kv_len`` a ``(B,)`` tensor; P split into ``parts`` bf16 parts.
    Every row runs the same trips; keys past a row's end are masked, which
    leaves (m, l, O) as the kernel's shorter loop does (corr 1, p 0), and
    an empty split weighs 0 in the merge, as one the merge skips."""
    B, _, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    chunk, n_splits = split_plan(B, Sk, Hkv, tensor_cores=True)
    lens = kv_len.clamp(0, Sk)[:, None, None, None]                     # (B,1,1,1)
    qf = q.float().reshape(B, Hkv, G, D)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))             # (B,Hkv,Sk,D)
    scale = LOG2E / D ** 0.5
    splits = []
    for s0 in range(0, n_splits * chunk, chunk):
        end = torch.clamp(lens, max=s0 + chunk)
        warps = []
        for w in range(WARPS):
            m = torch.full((B, Hkv, G, 1), -1e30)
            l, acc = torch.zeros((B, Hkv, G, 1)), torch.zeros((B, Hkv, G, D))
            for k0 in range(s0 + w * TILE // WARPS, min(s0 + chunk, Sk), TILE):
                keys = torch.arange(k0, min(k0 + TILE // WARPS, Sk))
                ok = keys[None, None, None, :] < end
                s = (qf @ kf[:, :, keys].transpose(-1, -2)) * scale
                s = torch.where(ok, s, torch.tensor(-1e30))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                corr = torch.exp2(m - m_new)
                p = torch.where(ok, torch.exp2(s - m_new), torch.zeros(()))
                vt = vf[:, :, keys]
                pv = torch.zeros_like(acc)
                for part in reversed(_split_bf16(p, parts)):      # smallest first
                    pv = pv + part @ vt
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + pv
                m = m_new
            warps.append((m, l, acc))
        M = torch.stack([w[0] for w in warps]).amax(0)
        L, A = torch.zeros_like(M), torch.zeros((B, Hkv, G, D))
        for m, l, acc in warps:
            wt = torch.exp2(m - M)
            L, A = L + l * wt, A + acc * wt
        live = (s0 < lens).float()                 # the merge reads only the live splits
        splits.append((M, L * live, A * live, s0 < lens))
    if n_splits == 1:
        _, L, A, _ = splits[0]
    else:
        M = torch.stack([torch.where(ok, m, torch.tensor(-1e30)) for m, _, _, ok in splits]).amax(0)
        L, A = torch.zeros_like(M), torch.zeros((B, Hkv, G, D))
        for m, l, acc, ok in splits:
            wt = torch.where(ok, torch.exp2(m - M), torch.zeros(()))
            L, A = L + l * wt, A + acc * wt
    return (A / L.clamp_min(1e-30)).reshape(B, 1, Hq, D)


def _np(t):
    return tree_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _inputs(seed, B, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, 1, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


# Every tile edge: none, one key, one short of a tile, a tile, one past,
# the whole (ragged) cache; the rest between splits.
EDGE_LENS = [0, 1, 63, 64, 65, 1000, 700, 333]
SK = 1000                      # no multiple of 64: the last tile is ragged


def _want(jax_in, lens):
    """The reference's Pallas kernel (interpret mode; zeros at kv_len 0) and
    `decode_attention_ref` (plain GQA), as fp32 numpy."""
    jq, jk, jv = jax_in
    jl = jnp.asarray(np.asarray(lens, np.int32))
    pallas = jops.decode_attention(jq, jk, jv, jl, block_k=jk.shape[1])
    return _np(pallas), _np(jref.decode_attention_ref(jq, jk, jv, jl))


@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("G", [4, 6, 8])
def test_tensor_core_decode_is_within_one_bf16_step_of_the_reference(G, D):
    Hkv = 2
    jax_in, (q, k, v) = _inputs(30 + G + D, len(EDGE_LENS), SK, G * Hkv, Hkv, D)
    lens = torch.tensor(EDGE_LENS, dtype=torch.int32)
    assert split_plan(len(EDGE_LENS), SK, Hkv, tensor_cores=True)[1] > 1   # the merge runs
    got = _np(_tensor_core_decode(q, k, v, lens).to(torch.bfloat16))
    pallas, ref = _want(jax_in, EDGE_LENS)
    np.testing.assert_allclose(got, pallas, **BF16_OUT_TOL)
    live = np.asarray(EDGE_LENS) > 0           # the plain GQA is uniform, not zero, at 0
    np.testing.assert_allclose(got[live], ref[live], **BF16_OUT_TOL)
    assert not got[~live].any()


def _over_tol(got, want):
    return np.abs(got - want) / (BF16_OUT_TOL["atol"] + BF16_OUT_TOL["rtol"] * np.abs(want))


@pytest.mark.parametrize("G,D", [(4, 64), (6, 128), (8, 112)])
def test_dropping_the_last_valid_key_misses_the_tolerance(G, D):
    """The control: the same emulation with each row's last valid key left
    out misses one bf16 step on every row at a tile edge."""
    Hkv = 2
    jax_in, (q, k, v) = _inputs(40 + G, len(EDGE_LENS), SK, G * Hkv, Hkv, D)
    lens = torch.tensor(EDGE_LENS, dtype=torch.int32)
    pallas, _ = _want(jax_in, EDGE_LENS)
    ok = _over_tol(_np(_tensor_core_decode(q, k, v, lens).to(torch.bfloat16)), pallas)
    short = _np(_tensor_core_decode(q, k, v, (lens - 1).clamp_min(0)).to(torch.bfloat16))
    miss = _over_tol(short, pallas).reshape(len(EDGE_LENS), -1).max(-1)
    assert ok.max() <= 1.0
    for row, n in enumerate(EDGE_LENS):
        if n in (1, 63, 64, 65):
            assert miss[row] > 1.0, (n, miss[row])


def test_p_in_three_parts_is_closer_to_the_exact_value():
    """Why P is split into three bf16 parts: each part left out moves the
    output farther (on average) from the exact, float64, attention by a
    large factor, and with two parts many times more bf16 outputs are off
    the correctly rounded value than with three (here about 45 of 49,152
    against about 4)."""
    _, (q, k, v) = _inputs(50, 4, 2048, 48, 8, 128)
    lens = torch.tensor([2048, 1500, 777, 65], dtype=torch.int32)
    B, Sk, Hkv, D = 4, 2048, 8, 128
    ok = (torch.arange(Sk)[None, :] < lens[:, None])[:, None, None, :]
    qf = q.double().reshape(B, Hkv, 6, D)
    s = (qf @ k.double().permute(0, 2, 3, 1)) / D ** 0.5
    p = torch.softmax(s.masked_fill(~ok, -1e30), -1)
    want = (p @ v.double().permute(0, 2, 1, 3)).reshape(B, 1, 48, D)
    got = {parts: _tensor_core_decode(q, k, v, lens, parts).double() for parts in (1, 2, 3)}
    err = {parts: float((out - want).abs().mean()) for parts, out in got.items()}
    off = {parts: int((out.to(torch.bfloat16) != want.to(torch.bfloat16)).sum())
           for parts, out in got.items()}
    assert 8 * err[3] < err[2] and 8 * err[2] < err[1], err
    assert 4 * off[3] < off[2] < off[1], off


def test_a_row_does_not_depend_on_its_neighbours_or_its_slot():
    """A migrated slot continues bit for bit: the emulated row is the same
    bits whatever the other rows' lengths and whichever slot it sits in."""
    _, (q, k, v) = _inputs(60, 8, SK, 16, 2, 128)
    lens = torch.tensor(EDGE_LENS, dtype=torch.int32)
    out = _tensor_core_decode(q, k, v, lens)
    others = torch.tensor([1000, 5, 999, 0, 2, 64, 700, 128], dtype=torch.int32)
    for row in (2, 4, 6):
        moved = others.clone()
        moved[row] = lens[row]
        assert torch.equal(_tensor_core_decode(q, k, v, moved)[row], out[row])
    perm = torch.tensor([3, 0, 7, 1, 6, 2, 5, 4])
    got = _tensor_core_decode(q[perm], k[perm], v[perm], lens[perm])
    assert torch.equal(got, out[perm])


@pytest.mark.parametrize("B,Sk,Hkv", [(8, 4096, 8), (1, 524288, 8), (128, 32768, 8),
                                      (3, 384, 6), (1, 200, 1), (4, 32768, 8), (13, 4096, 8)])
def test_the_tensor_core_plan_is_one_wave_and_covers_the_cache(B, Sk, Hkv):
    """At most two blocks an SM of a 132-SM card (the D-128 instance's
    shared memory), the whole cache covered, from the shapes alone."""
    chunk, n = split_plan(B, Sk, Hkv, tensor_cores=True)
    assert chunk % 64 == 0 and 1 <= n <= 64
    assert chunk * n >= Sk > chunk * (n - 1)
    assert n == 1 or B * Hkv * n <= 2 * 132
    assert split_plan(8, 4096, 8, tensor_cores=True) == (1024, 4)     # dbrx, granite: 256 blocks


@pytest.mark.parametrize("dtype,G,D,name", [
    (torch.bfloat16, 4, 64, "decode_bf16_tc_kernel<64, false>"),
    (torch.bfloat16, 6, 128, "decode_bf16_tc_kernel<128, false>"),
    (torch.bfloat16, 8, 112, "decode_bf16_tc_kernel<128, true>"),
    (torch.bfloat16, 3, 32, "decode_bf16_tc_kernel<32, false>"),
    (torch.bfloat16, 1, 112, "decode_partial_kernel<__nv_bfloat16, 128, 1, true>"),
    (torch.bfloat16, 2, 64, "decode_partial_kernel<__nv_bfloat16, 64, 2, false>"),
    (torch.float32, 6, 128, "decode_partial_kernel<float, 128, 8, false>"),
    (torch.float32, 3, 96, "decode_partial_kernel<float, 128, 4, true>"),
])
def test_kernel_instance_names_what_a_call_launches(dtype, G, D, name):
    """bf16 groups of 3 to 8 run the tensor-core kernel; fp32 and bf16
    groups of 1 or 2 the SIMT one (its group rounded up to 1, 2, 4, 8)."""
    assert kernel_instance(dtype, G, D) == name
