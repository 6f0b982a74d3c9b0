"""The flash-attention path of the port against the reference, on the CPU.

On a CPU tensor the port's `flash_attention` runs its plain version; here
it is held against the interpret-mode Pallas kernel and the reference's
`_flash_fwd_math` (output and log-sum-exp), and the training autograd
Function against `jax.grad` of `flash_attention_jnp`.  Inputs are made by
numpy from a seed.  Tolerances: fp32 2e-5 and bf16 5e-2 for forward
values (those of tests/test_kernels.py); 1e-4 for gradients, which sum
over every block pair in another order than the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models.config import reduced as jreduced
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax, tree_to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import KEY_TILE, flash_attention, flash_attention_plain
from repro_torch.models import attention as tattn
from repro_torch.models.config import reduced as treduced

GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _tol(bf16):
    return dict(atol=5e-2, rtol=5e-2) if bf16 else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, bf16=False):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32))


def _np(t):
    return tree_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D, bf16=False):
    rng = np.random.default_rng(seed)
    return (_pair(rng, (B, Sq, Hq, D), bf16), _pair(rng, (B, Sk, Hkv, D), bf16),
            _pair(rng, (B, Sk, Hkv, D), bf16))


# The cases of tests/test_kernels.py::TestFlashAttention: (B, S, Hq, Hkv, D, bq, bk).
CASES = [(1, 128, 4, 4, 64, 64, 64), (2, 256, 8, 2, 64, 128, 64),
         (2, 256, 6, 3, 32, 64, 128), (1, 512, 4, 1, 128, 128, 128)]


class TestFlashForward:
    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("B,S,Hq,Hkv,D,bq,bk", CASES)
    def test_matches_pallas_and_fwd_math(self, B, S, Hq, Hkv, D, bq, bk, causal, bf16):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(1, B, S, S, Hq, Hkv, D, bf16)
        want_pallas = jops.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
        want_out, want_lse = jattn._flash_fwd_math(jq, jk, jv, causal, 0, None, bq, bk)
        for fn in (flash_attention, flash_attention_plain, tops.flash_attention):
            out, lse = fn(tq, tk, tv, causal)
            assert out.shape == tq.shape and out.dtype == tq.dtype
            assert lse.shape == (B, Hkv, Hq // Hkv, S) and lse.dtype == torch.float32
            np.testing.assert_allclose(_np(out), _np(want_pallas), **_tol(bf16))
            np.testing.assert_allclose(_np(out), _np(want_out), **_tol(bf16))
            np.testing.assert_allclose(_np(lse), _np(want_lse), **_tol(bf16))
        np.testing.assert_allclose(_np(tref.flash_attention_ref(tq, tk, tv, causal)),
                                   _np(want_pallas), **_tol(bf16))
        out, lse = tattn._flash_fwd_math(tq, tk, tv, causal, 0, None, bq, bk)
        np.testing.assert_allclose(_np(out), _np(want_out), **_tol(bf16))
        np.testing.assert_allclose(_np(lse), _np(want_lse), **_tol(bf16))

    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("Sq,Sk,chunk", [(40, 40, 16), (1000, 1000, 128), (24, 70, 32)])
    def test_ragged_blocks_are_masked(self, Sq, Sk, chunk, causal):
        """Chunks that do not divide the lengths (the CUDA path's last chunk)
        give what the unchunked reference gives."""
        (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 2, Sq, Sk, 4, 2, 32)
        want = jattn.gqa_reference(jq, jk, jv, causal)
        out, lse = tattn._flash_fwd_math(tq, tk, tv, causal, 0, None, chunk, chunk)
        np.testing.assert_allclose(_np(out), _np(want), **_tol(False))
        _, plain_lse = flash_attention_plain(tq, tk, tv, causal)
        np.testing.assert_allclose(_np(lse), _np(plain_lse), **_tol(False))

    def test_use_plain_switch_and_no_launch_on_the_cpu(self):
        (_, q), (_, k), (_, v) = _qkv(3, 1, 16, 16, 2, 2, 32)
        with tops.use_plain():
            inside = tops.flash_attention(q, k, v, True)
        outside = tops.flash_attention(q, k, v, True)
        assert all(torch.equal(a, b) for a, b in zip(inside, outside))
        assert flash_attention.launches == 0


class TestChunkedAttention:
    @pytest.mark.parametrize("q_offset", [0, 5, "array"])
    @pytest.mark.parametrize("kv_len", [None, 20, "int"])
    def test_offset_and_length(self, q_offset, kv_len):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(4, 2, 8, 32, 4, 2, 32)
        joff, toff = ((jnp.asarray(7, jnp.int32), torch.tensor(7, dtype=torch.int32))
                      if q_offset == "array" else (q_offset, q_offset))
        jlen = None if kv_len is None else jnp.asarray(17 if kv_len == "int" else kv_len,
                                                       jnp.int32)
        tlen = (None if kv_len is None else 17 if kv_len == "int"
                else torch.tensor(kv_len, dtype=torch.int32))
        want = jattn.chunked_attention(jq, jk, jv, causal=True, q_offset=joff, kv_len=jlen,
                                       q_chunk=4, k_chunk=8)
        got = tattn.chunked_attention(tq, tk, tv, causal=True, q_offset=toff, kv_len=tlen,
                                      q_chunk=4, k_chunk=8)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(False))

    def test_chunks_that_do_not_divide_fall_back_to_the_reference(self):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(5, 1, 6, 10, 2, 2, 32)
        want = jattn.chunked_attention(jq, jk, jv, causal=True, q_chunk=4, k_chunk=4)
        got = tattn.chunked_attention(tq, tk, tv, causal=True, q_chunk=4, k_chunk=4)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(False))


class TestFlashBackward:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("B,S,Hq,Hkv,D,chunk", [(2, 64, 8, 2, 32, 16), (1, 96, 4, 4, 64, 32),
                                                    (1, 128, 6, 3, 32, 128)])
    def test_grads_match_jax(self, B, S, Hq, Hkv, D, chunk, causal):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(6, B, S, S, Hq, Hkv, D)
        jw, tw = _pair(np.random.default_rng(7), (B, S, Hq, D))

        def jloss(q, k, v):
            return (jattn.flash_attention_jnp(q, k, v, causal, chunk, chunk) * jw).sum()

        jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
        tq, tk, tv = (t.requires_grad_(True) for t in (tq, tk, tv))
        tl = (tattn.flash_attention_jnp(tq, tk, tv, causal, chunk, chunk) * tw).sum()
        tg = torch.autograd.grad(tl, (tq, tk, tv))
        np.testing.assert_allclose(float(tl.detach()), float(jl), **GRAD_TOL)
        for name, g, w in zip("qkv", tg, jg):
            np.testing.assert_allclose(_np(g), _np(w), err_msg=f"d{name}", **GRAD_TOL)

    @pytest.mark.parametrize("causal", [True, False])
    def test_ragged_chunks_match_autograd_of_the_reference(self, causal):
        """Chunks of 16 over 40 positions: the last chunk is ragged."""
        (_, tq), (_, tk), (_, tv) = _qkv(8, 2, 40, 40, 4, 2, 32)
        w = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 40, 4, 32))
                             .astype(np.float32))
        grads = []
        for fn in (lambda q, k, v: tattn.flash_attention_jnp(q, k, v, causal, 16, 16),
                   lambda q, k, v: tattn.gqa_reference(q, k, v, causal)):
            leaves = [t.detach().clone().requires_grad_(True) for t in (tq, tk, tv)]
            grads.append(torch.autograd.grad((fn(*leaves) * w).sum(), leaves))
        for g, want in zip(*grads):
            np.testing.assert_allclose(g.numpy(), want.numpy(), **GRAD_TOL)


class TestSelfAttentionMath:
    def test_long_sequence_takes_the_flash_branch(self):
        """Sq = 2048: the reference routes to `flash_attention_jnp` (1024-chunks)."""
        (jq, tq), (jk, tk), (jv, tv) = _qkv(10, 1, 2048, 2048, 4, 2, 32)
        want = jattn._self_attention_math(jq, jk, jv, True)
        got = tattn._self_attention_math(tq, tk, tv, True)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(False))

    def test_long_prefill_with_offset_takes_the_chunked_branch(self):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(11, 1, 2048, 3072, 2, 1, 32)
        want = jattn._self_attention_math(jq, jk, jv, True, q_offset=jnp.asarray(512),
                                          kv_len=jnp.asarray(2560))
        got = tattn._self_attention_math(tq, tk, tv, True, q_offset=torch.tensor(512),
                                         kv_len=torch.tensor(2560))
        np.testing.assert_allclose(_np(got), _np(want), **_tol(False))

    def test_attention_entry_at_2048_and_prefill_cache(self):
        jcfg = jreduced(jget_config("granite-3-2b"))
        tcfg = treduced(tget_config("granite-3-2b"))
        params = jattn.init_attention(jax.random.PRNGKey(0), jcfg, jnp.float32)
        tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
        jx, tx = _pair(np.random.default_rng(12), (1, 2048, jcfg.d_model))
        pos = np.arange(2048, dtype=np.int32)[None]
        want, _ = jattn.attention(params, jx, jcfg, jnp.asarray(pos))
        got, _ = tattn.attention(tparams, tx, tcfg, torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
        (jk, tk), (jv, tv) = _pair(np.random.default_rng(13), (2, 5, 2, 32)), \
            _pair(np.random.default_rng(14), (2, 5, 2, 32))
        jc = jattn.prefill_cache(jcfg, jk, jv, 9)
        tc = tattn.prefill_cache(tcfg, tk, tv, 9)
        for n in "kv":
            assert tc[n].shape == (2, 9, 2, 32)
            np.testing.assert_array_equal(_np(tc[n]), _np(jc[n]))

    def test_short_causal_entry_takes_the_flash_route(self):
        """S 40 (below the threshold, where the reference uses `gqa_reference`):
        the entry goes through the flash autograd Function, the card's route;
        its input gradient against JAX's (fp32, 1e-4)."""
        jcfg = jreduced(jget_config("granite-3-2b"))
        tcfg = treduced(tget_config("granite-3-2b"))
        params = jattn.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
        tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
        jx, tx = _pair(np.random.default_rng(15), (2, 40, jcfg.d_model))
        pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
        w = np.random.default_rng(16).standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
        loss = lambda x: jnp.sum(jattn.attention(params, x, jcfg, jnp.asarray(pos))[0] * w)
        want_dx = jax.grad(loss)(jx)
        tx.requires_grad_(True)
        got, _ = tattn.attention(tparams, tx, tcfg, torch.from_numpy(pos.copy()))
        seen, stack = set(), [got.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is not None and fn not in seen:
                seen.add(fn)
                stack.extend(f for f, _ in fn.next_functions)
        assert "_FlashAttentionBackward" in {type(f).__name__ for f in seen}
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **GRAD_TOL)


# chip_smoke.py's allowances for the bf16 kernel (FLASH_TOL): the output at
# 5e-3 + 1e-2·|want|, the fp32 log-sum-exp at 1e-3.
BF16_OUT_TOL, LSE_TOL = dict(atol=5e-3, rtol=1e-2), dict(atol=1e-3, rtol=0.0)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _tensor_core_flash(q, k, v, causal, split=True, l_from_rounded=False, tile=KEY_TILE):
    """The bf16 `flash_attention` kernel's arithmetic (csrc/flash_attention
    .cu, `flash_fwd_wgmma_kernel`) in PyTorch on the CPU: key tiles of
    ``tile`` (the kernel's `KEY_TILE`), scores in log2 units, the online
    softmax in fp32, P split into bf16 hi + lo for P·V (rounded once to bf16
    without ``split``) and l summed from the fp32 P (from the rounded P with
    ``l_from_rounded``).  Returns (out fp32 before its rounding to q's type,
    lse fp32 (B, Hkv, G, Sq))."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, log2e = Hq // Hkv, 1.4426950408889634
    qf = q.float().permute(0, 2, 1, 3)                                   # (B,Hq,Sq,D)
    kf, vf = (t.float().permute(0, 2, 1, 3).repeat_interleave(G, 1) for t in (k, v))
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l, acc = torch.zeros((B, Hq, Sq, 1)), torch.zeros((B, Hq, Sq, D))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, tile):
        keys = torch.arange(k0, min(k0 + tile, Sk))[None]
        seen = keys <= rows if causal else torch.ones((Sq, keys.shape[1]), dtype=torch.bool)
        s = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * (log2e / D ** 0.5)
        s = s.masked_fill(~seen, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(seen, torch.exp2(s - m_new), torch.zeros(()))
        corr = torch.exp2(m - m_new)
        hi = _bf16(p)
        l = l * corr + (hi if l_from_rounded else p).sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + tile]
        acc = acc * corr + (_bf16(p - hi) @ vt + hi @ vt if split else hi @ vt)
        m = m_new
    L = l.clamp_min(1e-30)
    lse = ((m + torch.log2(L)) / log2e).squeeze(-1)
    return (acc / L).permute(0, 2, 1, 3), lse.reshape(B, Hkv, G, Sq)


@pytest.mark.parametrize("tile", [KEY_TILE // 2, KEY_TILE])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64), (2, 256, 256, 6, 3, 32),
    (1, 512, 512, 4, 1, 128), (2, 77, 300, 4, 2, 32), (1, 200, 70, 4, 2, 112),
    (2, 130, 130, 8, 1, 64)])
def test_tensor_core_rounding_meets_the_bf16_allowance(B, Sq, Sk, Hq, Hkv, D, causal, tile):
    """P rounded to bf16 before P·V, emulated at the kernel's key tile (and
    at half of it, which rescales the running sums twice as often),
    against the reference's `_flash_fwd_math` (one chunk each side, so the
    ragged lengths divide) on the same bf16 inputs, at chip_smoke.py's bf16
    allowances."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(20, B, Sq, Sk, Hq, Hkv, D, bf16=True)
    want_out, want_lse = jattn._flash_fwd_math(jq, jk, jv, causal, 0, None, Sq, Sk)
    out, lse = _tensor_core_flash(tq, tk, tv, causal, tile=tile)
    assert lse.shape == (B, Hkv, Hq // Hkv, Sq)
    np.testing.assert_allclose(_np(out.to(torch.bfloat16)), _np(want_out), **BF16_OUT_TOL)
    np.testing.assert_allclose(_np(lse), _np(want_lse), **LSE_TOL)


def test_split_p_is_closer_to_fp32_than_one_rounding():
    """Why P is split into hi + lo: rounded once to bf16, P moves the fp32
    output several times farther from the unrounded online softmax than
    the split does.  (Both pass the per-call allowance; over a training
    step the single rounding drifted the loss and gradient norm to their
    train_vs_plain limits on the card, see PERF.md.)"""
    (_, tq), (_, tk), (_, tv) = _qkv(22, 1, 512, 512, 4, 1, 64, bf16=True)
    want, _ = flash_attention_plain(tq.float(), tk.float(), tv.float(), True)
    err = {split: float((_tensor_core_flash(tq, tk, tv, True, split)[0] - want).abs().max())
           for split in (True, False)}
    assert 8 * err[True] < err[False], err


def test_l_from_rounded_p_misses_the_lse_allowance():
    """Why l sums the fp32 P: summed from P rounded once to bf16, the
    log-sum-exp of long rows moves beyond its allowance."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(21, 1, 1000, 1000, 8, 2, 64, bf16=True)
    _, want = jattn._flash_fwd_math(jq, jk, jv, True, 0, None, 200, 200)
    err = {rounded: float(np.abs(_np(_tensor_core_flash(tq, tk, tv, True, False, rounded)[1])
                                 - _np(want)).max())
           for rounded in (False, True)}
    assert err[False] <= LSE_TOL["atol"] < err[True], err
