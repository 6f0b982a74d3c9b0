"""flash_attention's gradient (`kernels.flash_attention.flash_attention_bwd`,
the backward of the training autograd Function) held on the CPU, where the
wrapper runs its plain version, `_flash_bwd_rule`: against the reference's
rule (`repro.models.attention._flash_bwd_rule`) on the same inputs, fp32 at
`GRAD_TOL` (1e-4, tests/test_torch_flash.py's gradient tolerance: the port
sums the block pairs in another order); that a CPU backward launches
nothing and `use_plain()` takes the plain route; `work_bwd` at the training
paths' shapes; the `meta` route's scope; and the bf16 kernels' arithmetic,
emulated in PyTorch (`_tensor_core_flash_bwd`), against the reference's rule
on the same bf16 inputs at `BWD_BF16_TOL`, with controls that must miss it.
Inputs are made by numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import (DQ_KEY_TILE, KV_KEY_BLOCK, KV_QUERY_TILE,
                                                 dkdv_cap, dkdv_items, flash_attention_bwd,
                                                 flash_attention_bwd_plain, work, work_bwd)
from repro_torch.launch.op_stats import OpStats
from repro_torch.models import attention as tattn

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# The bf16 kernels' allowance (chip_smoke.py's BWD_BF16_TOL): each gradient
# within 2^-8 of its largest magnitude plus 2^-6 of the element.  P rounded
# once and dS split into bf16 hi + lo put the emulation at 0.06-0.39 of it
# (dv's, from P's rounding, the largest); P and dS both rounded once at
# 0.25-0.39; a dropped key tile or delta left out at 2.3 times it and more.
BWD_BF16_TOL = dict(max_share=2.0 ** -8, rtol=2.0 ** -6)


def _arrays(seed, B, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, Hq, D)]]


def _reference(arrays, causal, dtype):
    """The reference's forward (out, lse) and its rule's (dq, dk, dv), one
    block each side, as fp32 numpy; and the inputs in ``dtype``."""
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrays)
    Sq, Sk = jq.shape[1], jk.shape[1]
    jout, jlse = jattn._flash_fwd_math(jq, jk, jv, causal, 0, None, Sq, Sk)
    grads = jattn._flash_bwd_rule(causal, Sq, Sk, (jq, jk, jv, jout, jlse), jdo)
    as_np = lambda x: np.asarray(x.astype(jnp.float32))
    return [as_np(x) for x in (jq, jk, jv, jout, jlse, jdo)], [as_np(g) for g in grads]


def _torch(inputs, dtype):
    return [torch.from_numpy(x.copy()).to(torch.float32 if i == 4 else dtype)
            for i, x in enumerate(inputs)]


# (B, Sq, Sk, Hq, Hkv, D, causal): G 1, 4 and 6; d_head 32, 64, 112, 128;
# ragged lengths 77 and 300; Sq != Sk both ways, non-causal.
CASES = [(2, 77, 77, 4, 4, 32, True), (1, 300, 300, 8, 2, 64, True),
         (1, 300, 300, 6, 1, 128, True), (1, 300, 300, 4, 1, 112, True),
         (2, 77, 77, 8, 2, 112, False), (1, 300, 300, 4, 4, 64, False),
         (1, 77, 300, 6, 1, 64, False), (1, 300, 77, 4, 4, 128, False),
         (2, 77, 300, 8, 2, 32, False)]


@pytest.mark.parametrize("chunk", [1024, 64])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", CASES)
def test_the_wrapper_is_the_references_rule(B, Sq, Sk, Hq, Hkv, D, causal, chunk):
    """fp32: the wrapper's plain route (one block each side, and blocks of
    64 whose last one is ragged) against the reference's rule."""
    inputs, want = _reference(_arrays(1, B, Sq, Sk, Hq, Hkv, D), causal, jnp.float32)
    q, k, v, out, lse, dout = _torch(inputs, torch.float32)
    for fn in (flash_attention_bwd, tops.flash_attention_bwd):
        got = fn(q, k, v, out, lse, dout, causal, chunk, chunk)
        for name, g, w, like in zip("qkv", got, want, (q, k, v)):
            assert g.shape == like.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", **GRAD_TOL)


def test_the_plain_version_is_the_rule_bit_for_bit():
    """`flash_attention_bwd_plain` is `_flash_bwd_rule` itself, and the
    autograd Function's CPU backward goes through it unchanged."""
    q, k, v, dout = (torch.from_numpy(a) for a in _arrays(2, 2, 96, 96, 4, 2, 32))
    out, lse = tattn._flash_fwd_math(q, k, v, True, 0, None, 32, 32)
    want = tattn._flash_bwd_rule(True, 32, 32, (q, k, v, out, lse), dout)
    got = flash_attention_bwd_plain(q, k, v, out, lse, dout, True, 32, 32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad((tattn.flash_attention_jnp(*leaves, True, 32, 32) * dout).sum(),
                                leaves)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_a_cpu_backward_launches_nothing_and_use_plain_is_the_plain_route():
    q, k, v, dout = (torch.from_numpy(a) for a in _arrays(3, 1, 40, 40, 4, 2, 32))
    out, lse = tattn._flash_fwd_math(q, k, v, True, 0, None, 40, 40)
    before = flash_attention_bwd.launches
    with tops.use_plain():
        inside = tops.flash_attention_bwd(q, k, v, out, lse, dout, True, 16, 16)
    outside = tops.flash_attention_bwd(q, k, v, out, lse, dout, True, 16, 16)
    assert all(torch.equal(a, b) for a, b in zip(inside, outside))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (tattn.flash_attention_jnp(*leaves, True, 16, 16) * dout).sum().backward()
    assert flash_attention_bwd.launches == before == 0


def test_what_the_wrapper_refuses():
    q = torch.zeros(1, 8, 2, 32)
    lse = torch.zeros(1, 2, 1, 8)
    with pytest.raises(TypeError):
        flash_attention_bwd(q.double(), q.double(), q.double(), q.double(), lse, q.double())
    with pytest.raises(TypeError):
        flash_attention_bwd(q, q, q, q, lse.double(), q)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, q, q, q.bfloat16(), lse, q)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, q, lse[..., :7], q)                     # lse rows
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q[:, :, :1], q, q, lse, q)                   # k / v shapes
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, q[:, :7], lse, q)                      # out


# (B, Sq, Sk, Hq, Hkv, D, causal) of each training path's attention, and
# its bound in ms: five products at the bf16 dense peak (989 TFLOP/s).
PATH_SHAPES = [((2, 4096, 4096, 32, 8, 64, True), 0.3475),      # granite-3-2b
               ((2, 4096, 4096, 32, 32, 112, True), 0.6081),    # zamba2-7b
               ((2, 4096, 4096, 48, 8, 128, True), 1.0425),     # dbrx-132b
               ((2, 4096, 4096, 12, 2, 128, True), 0.2606),     # qwen2-vl-2b
               ((2, 4096, 4096, 16, 16, 64, True), 0.1738),     # seamless decoder
               ((2, 4096, 2048, 16, 16, 64, False), 0.1737),    # seamless cross
               ((2, 2048, 2048, 16, 16, 64, False), 0.0869)]    # seamless encoder


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape,bound_ms", PATH_SHAPES)
def test_work_bwd_is_five_products(shape, bound_ms):
    B, Sq, Sk, Hq, Hkv, D, causal = shape
    q, kv = _meta((B, Sq, Hq, D)), _meta((B, Sk, Hkv, D))
    flops, nbytes = work_bwd(q, kv, kv, causal)
    pairs = B * Sq * (Sq + 1) // 2 if causal else B * Sq * Sk
    assert flops == 10 * pairs * Hq * D
    assert 2 * flops == 5 * work(q, kv, kv, causal)[0]
    assert nbytes == (4 * q.numel() + 4 * kv.numel()) * 2 + 2 * B * Hq * Sq * 4
    assert round(flops / 989e12 * 1e3, 4) == bound_ms
    assert nbytes / 3.35e12 < flops / 989e12          # bound by operations


def test_a_meta_backward_is_one_scope_with_its_work():
    """On ``meta`` the autograd Function's backward takes the card's route
    inside one `flash_attention_bwd` scope, which the tally counts by
    `work_bwd` and not by the plain rule's ops."""
    q = _meta((2, 256, 8, 64)).requires_grad_(True)
    k, v = (_meta((2, 256, 2, 64)).requires_grad_(True) for _ in range(2))
    out = tattn.flash_attention_jnp(q, k, v, True, 128, 128)
    dout = torch.ones_like(out)
    with OpStats() as tally:
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    row = tally.row()
    assert dq.is_meta and dk.shape == k.shape and dv.shape == v.shape
    assert row["scopes"] == {"flash_attention_bwd": 1}
    assert (row["flops"], row["bytes"]) == work_bwd(q, k, v, True)


# ------------------------------------------- the bf16 kernels, emulated --
def _bf16(t):
    return t.to(torch.bfloat16).float()


def _tensor_core_flash_bwd(q, k, v, out, lse, dout, causal, dq_split=False, dk_split=True,
                           no_delta=False, tile_dropped=False, n_sm=132):
    """The bf16 gradient kernels' arithmetic (csrc/flash_attention_bwd.cu,
    `flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkdv_wgmma_kernel`) in
    PyTorch on the CPU: delta = sum(dout * out) in fp32; P = 2^(S scale
    log2(e) - lse log2(e)), dP = dO V^T and dS = P (dP - delta) in fp32.
    dq is summed over key tiles of `DQ_KEY_TILE` in order, dS rounded once
    to bf16 (split into bf16 hi + lo with ``dq_split``).  dk and dv follow
    the dk/dv kernel's items (`dkdv_items` under `dkdv_cap` on ``n_sm``
    SMs): each piece of a key block sums its query tiles head by head in
    fp32 from zero, P rounded once to bf16 for dv, dS split into bf16 hi +
    lo for dk, lo's product first (rounded once without ``dk_split``); a
    block cut into pieces adds them in piece order.  Each scaled and
    returned in fp32, before the rounding to q's type.  Controls: delta
    left out (``no_delta``), the last key tile's pairs dropped
    (``tile_dropped``)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, log2e, scale = Hq // Hkv, 1.4426950408889634, D ** -0.5
    qf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, dout))           # (B,Hq,Sq,D)
    kf, vf = (t.float().permute(0, 2, 1, 3).repeat_interleave(G, 1) for t in (k, v))
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    if no_delta:
        delta = torch.zeros_like(delta)
    lse2 = lse.reshape(B, Hq, Sq) * log2e
    seen = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        seen = torch.arange(Sk)[None] <= torch.arange(Sq)[:, None]
    if tile_dropped:
        seen = seen & (torch.arange(Sk)[None] < (Sk - 1) // DQ_KEY_TILE * DQ_KEY_TILE)
    p = torch.exp2((qf @ kf.transpose(-1, -2)) * (scale * log2e) - lse2[..., None])
    p = torch.where(seen, p, torch.zeros(()))
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    hi = _bf16(ds)
    parts = lambda split: (_bf16(ds - hi), hi) if split else (hi,)
    dq = torch.zeros_like(qf)
    for j0 in range(0, Sk, DQ_KEY_TILE):
        for part in parts(dq_split):
            dq += part[..., j0:j0 + DQ_KEY_TILE] @ kf[:, :, j0:j0 + DQ_KEY_TILE]
    dk, dv = torch.zeros((B, Hkv, Sk, D)), torch.zeros((B, Hkv, Sk, D))
    n_qt = -(-Sq // KV_QUERY_TILE)
    cap = dkdv_cap(B, Sq, Sk, Hkv, G, causal, n_sm)
    pieces = {}
    for z, t0, t1, _, _ in dkdv_items(Sq, Sk, G, causal, cap):
        keys = slice(z * KV_KEY_BLOCK, (z + 1) * KV_KEY_BLOCK)
        qt0 = min(z * KV_KEY_BLOCK // KV_QUERY_TILE, n_qt) if causal else 0
        per_head = n_qt - qt0
        pk = torch.zeros_like(dk[:, :, keys])
        pv = torch.zeros_like(dv[:, :, keys])
        for tile in range(t0, t1):
            heads = torch.arange(Hkv) * G + tile // per_head
            i0 = (qt0 + tile % per_head) * KV_QUERY_TILE
            rows = slice(i0, i0 + KV_QUERY_TILE)
            pv += _bf16(p[:, heads, rows, keys]).transpose(-1, -2) @ dof[:, heads, rows]
            for part in parts(dk_split):
                pk += part[:, heads, rows, keys].transpose(-1, -2) @ qf[:, heads, rows]
        pieces.setdefault(z, []).append((pk, pv))
    for z, got in pieces.items():
        keys = slice(z * KV_KEY_BLOCK, (z + 1) * KV_KEY_BLOCK)
        dk[:, :, keys], dv[:, :, keys] = got[0]
        for pk, pv in got[1:]:
            dk[:, :, keys] += pk
            dv[:, :, keys] += pv
    return tuple(t.permute(0, 2, 1, 3) for t in (dq * scale, dk * scale, dv))


def _over_allowance(got, want):
    """The largest error of ``got`` (rounded to bf16) over `BWD_BF16_TOL`."""
    got = _bf16(got).numpy()
    allowed = (BWD_BF16_TOL["max_share"] * np.abs(want).max()
               + BWD_BF16_TOL["rtol"] * np.abs(want))
    return float((np.abs(got - want) / allowed).max())


EMULATED = [(1, 300, 300, 8, 2, 64, True), (2, 77, 300, 4, 2, 64, False),
            (1, 300, 300, 4, 4, 112, True), (1, 300, 300, 6, 1, 128, True),
            (1, 256, 256, 8, 1, 64, False), (1, 1000, 1000, 4, 1, 64, True),
            (2, 130, 130, 8, 8, 32, True), (1, 300, 129, 4, 2, 128, False)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", EMULATED)
def test_tensor_core_rounding_meets_the_bf16_allowance(B, Sq, Sk, Hq, Hkv, D, causal):
    """P rounded once to bf16, dS rounded once for dq and split into hi +
    lo for dk, emulated at the kernels' tiles and dk/dv pieces, against the
    reference's rule on the same bf16 inputs (and the reference's bf16
    forward's out and lse): within `BWD_BF16_TOL` with room to spare, as is
    dS rounded once for both; while a dropped last key tile and a left-out
    delta miss it."""
    inputs, want = _reference(_arrays(4, B, Sq, Sk, Hq, Hkv, D), causal, jnp.bfloat16)
    tensors = _torch(inputs, torch.bfloat16)
    got = _tensor_core_flash_bwd(*tensors, causal)
    ratios = [_over_allowance(g, w) for g, w in zip(got, want)]
    assert max(ratios) < 0.6, ratios
    single = _tensor_core_flash_bwd(*tensors, causal, dk_split=False)
    assert max(_over_allowance(g, w) for g, w in zip(single, want)) < 0.6
    dropped = _tensor_core_flash_bwd(*tensors, causal, tile_dropped=True)
    assert min(_over_allowance(g, w) for g, w in zip(dropped, want)) > 1.0
    no_delta = _tensor_core_flash_bwd(*tensors, causal, no_delta=True)
    assert min(_over_allowance(g, w) for g, w in zip(no_delta[:2], want[:2])) > 1.0


def _bias_inputs(seed, shape):
    """bf16 inputs from the reference's forward, and the fp32 rule's
    (dq, dk, dv) on them."""
    inputs, _ = _reference(_arrays(seed, *shape), True, jnp.bfloat16)
    q, k, v, out, lse, dout = _torch(inputs, torch.bfloat16)
    fp32 = [t.float() for t in (q, k, v, out)]
    want = flash_attention_bwd_plain(*fp32, lse, dout.float(), True, shape[1], shape[2])
    return (q, k, v, out, lse, dout), want


def test_split_ds_keeps_a_key_bias_gradient():
    """Why dS is split into hi + lo for dk: a K projection's bias has the
    gradient sum_j dk_j, which vanishes in exact arithmetic (each row of dS
    sums to 0).  With dS rounded once to bf16 it lies many times farther
    from the fp32 rule's than with the split.  (Both pass the per-call
    allowance; over a training step the single rounding moved qwen2-vl's
    loss past its train_vs_fp32 limit on the card, see PERF.md.)"""
    tensors, want = _bias_inputs(5, (1, 512, 512, 6, 1, 128))
    err = {split: float((_tensor_core_flash_bwd(*tensors, True, dk_split=split)[1].sum(1)
                         - want[1].sum(1)).abs().max())
           for split in (True, False)}
    assert 8 * err[True] < err[False], err


# (seed, (B, Sq, Sk, Hq, Hkv, D)): qwen2-vl's group of 6 at d_head 128, the
# key test's inputs; granite's group of 4 at 64; one head a group, ragged.
QUERY_BIAS = [(5, (1, 512, 512, 6, 1, 128)), (6, (1, 512, 512, 8, 2, 64)),
              (7, (2, 300, 300, 4, 4, 64))]


@pytest.mark.parametrize("seed,shape", QUERY_BIAS)
def test_ds_rounded_once_keeps_a_query_bias_gradient(seed, shape):
    """Why dq takes dS rounded once: a Q projection's bias has the gradient
    sum_i dq_i = scale sum_j (sum_i dS_ij) k_j, and the columns of dS do
    not sum to 0, so nothing cancels.  With dS rounded once, sum_i dq_i of
    the bf16 dq the kernel returns lies at most 2 times as far from the
    fp32 rule's as with the split (1.3-1.5 at these inputs), and before
    that rounding within 2^-8 of its own size (0.0017-0.0022).  The key
    side's sum_j dk_j, which cancels, lies from it by a quarter of its size
    and more under one rounding (0.67-1.04): the split is kept there."""
    tensors, want = _bias_inputs(seed, shape)
    sums = {split: _tensor_core_flash_bwd(*tensors, True, dq_split=split)[0].sum(1)
            for split in (True, False)}
    rounded = {split: float((_bf16(_tensor_core_flash_bwd(*tensors, True, dq_split=split)[0])
                             .sum(1) - want[0].sum(1)).abs().max())
               for split in (True, False)}
    assert rounded[False] <= 2 * rounded[True], rounded
    size = float(want[0].sum(1).abs().max())
    assert float((sums[False] - want[0].sum(1)).abs().max()) <= 2 ** -8 * size
    k_single = _tensor_core_flash_bwd(*tensors, True, dk_split=False)[1].sum(1)
    assert (float((k_single - want[1].sum(1)).abs().max())
            >= 0.25 * float(want[1].sum(1).abs().max()))


# Ragged and small shapes beside the paths' (B, Sq, Sk, Hq, Hkv, causal).
SCHEDULE_SHAPES = [s[:5] + (s[6],) for s, _ in PATH_SHAPES] + [
    (1, 300, 300, 6, 1, True), (2, 77, 300, 8, 2, False), (1, 300, 77, 4, 4, True),
    (1, 1000, 1000, 12, 2, True), (2, 130, 130, 8, 8, True), (1, 64, 4096, 12, 2, True),
    (1, 4096, 64, 6, 1, True), (1, 1, 1, 1, 1, True)]


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal", SCHEDULE_SHAPES)
def test_dkdv_items_cover_every_visible_pair_once(B, Sq, Sk, Hq, Hkv, causal, n_sm):
    """The dk/dv kernel's items (`dkdv_items` under `dkdv_cap`, as the
    source's ``kv_item`` decodes them): every (key block, head of the
    group, query tile) that the mask lets a key of the block see, once, and
    nothing else; every key block at least one item (its zeros are stored
    even where it sees nothing); a block's pieces in order, of near-equal
    length, no longer than the cap and, cut, no shorter than half of it;
    the cut blocks' items first; and the same list on every call."""
    G = Hq // Hkv
    cap = dkdv_cap(B, Sq, Sk, Hkv, G, causal, n_sm)
    items = dkdv_items(Sq, Sk, G, causal, cap)
    assert items == dkdv_items(Sq, Sk, G, causal, cap)
    n_qt, n_kb = -(-Sq // KV_QUERY_TILE), -(-Sk // KV_KEY_BLOCK)
    seen = []
    for z, t0, t1, p, n in items:
        qt0 = min(z * KV_KEY_BLOCK // KV_QUERY_TILE, n_qt) if causal else 0
        per_head = n_qt - qt0
        seen += [(z, t // per_head, qt0 + t % per_head) for t in range(t0, t1)]
        assert t1 - t0 <= cap and (n == 1 or 2 * (t1 - t0) >= cap)
    visible = [(z, g, qt) for z in range(n_kb) for g in range(G) for qt in range(n_qt)
               if not causal or qt * KV_QUERY_TILE + KV_QUERY_TILE - 1 >= z * KV_KEY_BLOCK]
    assert sorted(seen) == sorted(visible) and len(seen) == len(set(seen))
    assert sorted({it[0] for it in items}) == list(range(n_kb))
    assert [(it[0], it[3]) for it in items] == sorted((it[0], it[3]) for it in items)
    cut = [it[4] > 1 for it in items]
    assert cut == sorted(cut, reverse=True)              # the cut blocks' items first
    assert len(items) <= 65535


def test_the_pieces_cut_qwen2vl_and_leave_the_other_paths_whole():
    """At qwen2-vl-2b's training shape the 128 key blocks of (2 kv heads, 2
    batches) become 576 items of at most 48 tiles, where the longest block
    held 384, twice an SM's share; the other paths' longest blocks hold at
    most half an SM's share, and their blocks stay whole."""
    cuts = []
    for (B, Sq, Sk, Hq, Hkv, D, causal), _ in PATH_SHAPES:
        cap = dkdv_cap(B, Sq, Sk, Hkv, Hq // Hkv, causal, 132)
        items = dkdv_items(Sq, Sk, Hq // Hkv, causal, cap)
        cuts.append((len(items), sum(it[4] > 1 for it in items)))
    granite, zamba2, dbrx, qwen2vl, decoder, cross, encoder = cuts
    assert dkdv_cap(2, 4096, 4096, 2, 6, True, 132) == 48 and qwen2vl == (144, 140)
    assert granite == dbrx == zamba2 == decoder == (32, 0) and cross == encoder == (16, 0)
