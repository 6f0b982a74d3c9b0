"""Attention of the port against the reference, on the same numpy inputs.

Tolerances: fp32 2e-5, bf16 5e-2 (those of tests/test_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models.config import reduced as jreduced
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax, tree_to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain, split_plan)
from repro_torch.models import attention as tattn
from repro_torch.models.config import reduced as treduced


def _tol(bf16):
    return dict(atol=5e-2, rtol=5e-2) if bf16 else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, bf16=False):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32))


def _np(t):
    return tree_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _qkv(rng, B, Sq, Sk, Hq, Hkv, D, bf16=False):
    return (_pair(rng, (B, Sq, Hq, D), bf16), _pair(rng, (B, Sk, Hkv, D), bf16),
            _pair(rng, (B, Sk, Hkv, D), bf16))


class TestGqaReference:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (4, 1)])
    def test_full_sequence(self, Hq, Hkv, causal):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(0), 2, 16, 16, Hq, Hkv, 32)
        want = jattn.gqa_reference(jq, jk, jv, causal)
        got = tattn.gqa_reference(tq, tk, tv, causal)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(False))

    @pytest.mark.parametrize("q_offset", [3, np.array([0, 5, 9], np.int32)])
    def test_q_offset_and_kv_len(self, q_offset):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(1), 3, 4, 24, 4, 2, 32)
        kv_len = np.array([7, 12, 24], np.int32)
        joff = jnp.asarray(q_offset) if isinstance(q_offset, np.ndarray) else q_offset
        toff = torch.from_numpy(q_offset) if isinstance(q_offset, np.ndarray) else q_offset
        want = jattn.gqa_reference(jq, jk, jv, True, joff, jnp.asarray(kv_len))
        got = tattn.gqa_reference(tq, tk, tv, True, toff, torch.from_numpy(kv_len))
        np.testing.assert_allclose(_np(got), _np(want), **_tol(False))

    def test_bf16(self):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(2), 2, 8, 8, 4, 2, 32, True)
        want = jattn.gqa_reference(jq, jk, jv, True)
        got = tattn.gqa_reference(tq, tk, tv, True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), **_tol(True))

    def test_long_sequences_name_the_missing_path(self):
        """The chunked / flash branch is ported: Sq = 2048 no longer raises
        and agrees with the unchunked plain attention."""
        (_, q), (_, k), (_, v) = _qkv(np.random.default_rng(3), 1, 2048, 2048, 2, 1, 32)
        np.testing.assert_allclose(_np(tattn._self_attention_math(q, k, v, True)),
                                   _np(tattn.gqa_reference(q, k, v, True)), **_tol(False))


DECODE_SHAPES = [(1, 256, 4, 4, 64, 64), (2, 512, 8, 2, 64, 128), (3, 384, 6, 6, 32, 128)]


class TestDecodeAttentionPlain:
    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("B,Sk,Hq,Hkv,D,bk", DECODE_SHAPES)
    def test_matches_reference_and_pallas(self, B, Sk, Hq, Hkv, D, bk, bf16):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(7), B, 1, Sk, Hq, Hkv, D, bf16)
        kv_len = (np.arange(1, B + 1, dtype=np.int32) * (Sk // (B + 1))).astype(np.int32)
        want_ref = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(kv_len))
        want_pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len), block_k=bk)
        tlen = torch.from_numpy(kv_len)
        for fn in (decode_attention_plain, decode_attention, tops.decode_attention,
                   tref.decode_attention_ref):
            got = fn(tq, tk, tv, tlen)
            assert got.shape == tq.shape and got.dtype == tq.dtype
            np.testing.assert_allclose(_np(got), _np(want_ref), **_tol(bf16))
            np.testing.assert_allclose(_np(got), _np(want_pallas), **_tol(bf16))

    def test_scalar_kv_len(self):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(8), 2, 1, 64, 4, 2, 32)
        want = jops.decode_attention(jq, jk, jv, jnp.asarray(40, jnp.int32), block_k=64)
        for kv_len in (40, torch.tensor(40), torch.tensor(40, dtype=torch.int32)):
            np.testing.assert_allclose(_np(tops.decode_attention(tq, tk, tv, kv_len)),
                                       _np(want), **_tol(False))

    def test_stale_cache_is_masked(self):
        """Entries past kv_len must not affect the output."""
        (_, q), (_, k), (_, v) = _qkv(np.random.default_rng(10), 1, 1, 128, 4, 4, 32)
        kv_len = torch.tensor([64], dtype=torch.int32)
        out1 = tops.decode_attention(q, k, v, kv_len)
        k2, v2 = k.clone(), v.clone()
        k2[:, 64:] = 999.0
        v2[:, 64:] = -999.0
        np.testing.assert_allclose(tops.decode_attention(q, k2, v2, kv_len).numpy(),
                                   out1.numpy())

    def test_zero_length_gives_zeros_as_the_pallas_kernel_does(self):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(np.random.default_rng(11), 2, 1, 64, 4, 2, 32)
        kv_len = np.array([0, 9], np.int32)
        want = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len), block_k=64)
        got = tops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len))
        assert float(got[0].abs().max()) == 0.0
        np.testing.assert_allclose(_np(got), _np(want), **_tol(False))

    def test_length_past_the_cache_is_clamped(self):
        (_, q), (_, k), (_, v) = _qkv(np.random.default_rng(12), 2, 1, 32, 4, 2, 32)
        over = tops.decode_attention(q, k, v, torch.tensor([40, 33], dtype=torch.int32))
        assert torch.equal(over, tops.decode_attention(q, k, v, 32))

    def test_use_plain_switch(self):
        (_, q), (_, k), (_, v) = _qkv(np.random.default_rng(13), 1, 1, 16, 2, 2, 32)
        with tops.use_plain():
            inside = tops.decode_attention(q, k, v, 5)
        assert torch.equal(inside, tops.decode_attention(q, k, v, 5))
        assert decode_attention.launches == 0      # the CPU never launches

    @pytest.mark.parametrize("B,Sk,Hkv", [(8, 4096, 8), (1, 524288, 8), (128, 32768, 8),
                                          (3, 384, 6), (1, 200, 1), (4, 32768, 8)])
    def test_split_plan_covers_the_cache(self, B, Sk, Hkv):
        chunk, n = split_plan(B, Sk, Hkv)
        assert chunk % 64 == 0 and 1 <= n <= 128
        assert chunk * n >= Sk > chunk * (n - 1)
        # from the shapes alone: nothing else goes in
        assert (chunk, n) == split_plan(B, Sk, Hkv)


class TestAttentionEntry:
    """`attention()` with converted weights: output and the new cache."""

    def _setup(self, arch, seed=0):
        jcfg = jreduced(jget_config(arch))
        tcfg = treduced(tget_config(arch))
        params = jattn.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32)
        tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
        return jcfg, tcfg, params, tparams

    @pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-2b"])
    def test_no_cache_full_sequence(self, arch):
        jcfg, tcfg, params, tparams = self._setup(arch)
        jx, tx = _pair(np.random.default_rng(3), (2, 9, jcfg.d_model))
        pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
        want, wc = jattn.attention(params, jx, jcfg, jnp.asarray(pos))
        got, gc = tattn.attention(tparams, tx, tcfg, torch.from_numpy(pos))
        assert wc is None and gc is None
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)

    def _cached(self, arch, S, index, max_len=16):
        jcfg, tcfg, params, tparams = self._setup(arch)
        rng = np.random.default_rng(4)
        B = 3
        jx, tx = _pair(rng, (B, S, jcfg.d_model))
        jc = {n: _pair(rng, (B, max_len, jcfg.n_kv_heads, jcfg.d_head))[0] for n in "kv"}
        tc = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
        idx = np.asarray(index, np.int32)
        pos = (idx[:, None] if idx.ndim else idx) + np.arange(S, dtype=np.int32)[None, :]
        pos = np.broadcast_to(pos, (B, S)).astype(np.int32)
        want, wc = jattn.attention(params, jx, jcfg, jnp.asarray(pos), cache=jc,
                                   cache_index=jnp.asarray(idx))
        got, gc = tattn.attention(tparams, tx, tcfg, torch.from_numpy(pos), cache=tc,
                                  cache_index=torch.from_numpy(idx))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
        for n in "kv":
            np.testing.assert_allclose(_np(gc[n]), _np(wc[n]), atol=1e-5, rtol=1e-5)
            assert gc[n] is tc[n]                       # written in place
        return got

    @pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-2b"])
    @pytest.mark.parametrize("S", [1, 4])
    def test_scalar_cache_index(self, arch, S):
        self._cached(arch, S, 5)

    @pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-2b"])
    @pytest.mark.parametrize("S", [1, 4])
    def test_per_row_cache_index(self, arch, S):
        self._cached(arch, S, [0, 7, 11])

    @pytest.mark.parametrize("index", [[2, 15, 40], 19, [16, 16, 3]])
    def test_index_past_max_len_clamps_like_the_reference(self, index):
        out = self._cached("granite-3-2b", 1, index)
        assert bool(torch.isfinite(out).all())

    def test_init_shapes(self):
        tcfg = treduced(tget_config("qwen1.5-0.5b"))
        g = torch.Generator("cpu").manual_seed(0)
        p = tattn.init_attention(g, tcfg, torch.float32)
        assert p["wq"]["w"].shape == (tcfg.d_model, tcfg.n_heads * tcfg.d_head)
        assert p["wk"]["b"].shape == (tcfg.n_kv_heads * tcfg.d_head,)
        assert "b" not in p["wo"]
        c = tattn.init_kv_cache(tcfg, 2, 8, torch.float32, device="cpu")
        assert c["k"].shape == (2, 8, tcfg.n_kv_heads, tcfg.d_head)
