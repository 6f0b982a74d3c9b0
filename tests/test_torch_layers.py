"""Base layers of the port against the reference, on the same numpy inputs.

Tolerances: fp32 2e-5, bf16 5e-2 (those of tests/test_kernels.py): both
sides do the same fp32 arithmetic, in another order of summation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.convert import params_from_jax, tree_to_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rmsnorm import rms_norm as rms_norm_wrapper
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ModelConfig


def _tol(bf16):
    return dict(atol=5e-2, rtol=5e-2) if bf16 else dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, bf16):
    """The same values as a JAX array and a torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    return jx, tx


def _np(t):
    return tree_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


RMS_SHAPES = [(4, 128), (2, 37, 256), (1, 5, 7, 64), (300, 512)]


class TestRmsNorm:
    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    def test_matches_reference_layer(self, shape, bf16):
        rng = np.random.default_rng(13)
        jx, tx = _pair(rng, shape, bf16)
        js, ts = _pair(rng, shape[-1:], bf16)
        want = jlayers.rms_norm(jx, js, 1e-5)
        for fn in (tlayers.rms_norm, tlayers.fused_rms_norm, tops.rms_norm,
                   tref.rms_norm_ref, rms_norm_wrapper):
            got = fn(tx, ts, 1e-5)
            assert got.dtype == tx.dtype and got.shape == tx.shape
            np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16))

    @pytest.mark.parametrize("bf16", [False, True])
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    def test_matches_pallas_kernel(self, shape, bf16):
        rng = np.random.default_rng(14)
        jx, tx = _pair(rng, shape, bf16)
        js, ts = _pair(rng, shape[-1:], bf16)
        want = jops.rms_norm(jx, js)          # Pallas, interpret mode
        np.testing.assert_allclose(_np(tops.rms_norm(tx, ts)), _np(want), **_tol(bf16))

    @pytest.mark.parametrize("rows,d,seed", [(1, 32, 0), (7, 64, 1), (64, 128, 2), (33, 32, 3)])
    def test_scale_invariance(self, rows, d, seed):
        """rms_norm(c*x) == rms_norm(x) for any c > 0."""
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal((rows, d))
                             .astype(np.float32))
        scale = torch.ones(d)
        a, b = tops.rms_norm(x, scale), tops.rms_norm(3.7 * x, scale)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=1e-4)

    def test_use_plain_switch_restores(self):
        x, s = torch.randn(3, 32), torch.ones(32)
        with tops.use_plain():
            inside = tops.rms_norm(x, s)
            assert tops._force_plain
        assert not tops._force_plain
        assert torch.equal(inside, tops.rms_norm(x, s))

    def test_cpu_runs_never_count_as_launches(self):
        before = rms_norm_wrapper.launches
        rms_norm_wrapper(torch.randn(3, 32), torch.ones(32))
        assert rms_norm_wrapper.launches == before


class TestRope:
    @pytest.mark.parametrize("bf16", [False, True])
    def test_per_row_positions(self, bf16):
        rng = np.random.default_rng(1)
        jx, tx = _pair(rng, (3, 5, 4, 32), bf16)
        pos = np.array([[0, 1, 2, 3, 4], [10, 11, 12, 13, 14], [63, 64, 65, 66, 67]], np.int32)
        want = jlayers.apply_rope(jx, jnp.asarray(pos), 10_000.0)
        got = tlayers.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
        np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16))

    def test_split_half_not_interleaved(self):
        """Element i rotates with element i + Dh/2."""
        x = torch.zeros(1, 1, 1, 8)
        x[..., 0] = 1.0
        out = tlayers.apply_rope(x, torch.tensor([[1]]), 10_000.0)[0, 0, 0]
        assert abs(float(out[0]) - np.cos(1.0)) < 1e-6
        assert abs(float(out[4]) - np.sin(1.0)) < 1e-6
        assert float(out[1]) == 0.0

    def test_freqs(self):
        np.testing.assert_allclose(tlayers.rope_freqs(64, 1e6).numpy(),
                                   np.asarray(jlayers.rope_freqs(64, 1e6)), rtol=1e-6)


class TestLinearEmbed:
    @pytest.mark.parametrize("bias", [False, True])
    def test_apply_linear(self, bias):
        rng = np.random.default_rng(2)
        p = {"w": rng.standard_normal((48, 24)).astype(np.float32)}
        if bias:
            p["b"] = rng.standard_normal(24).astype(np.float32)
        x = rng.standard_normal((2, 5, 48)).astype(np.float32)
        want = jlayers.apply_linear(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.float32)
        got = tlayers.apply_linear(params_from_jax(p, "cpu"), torch.from_numpy(x), torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)

    def test_apply_linear_casts_operands_to_compute_type(self):
        rng = np.random.default_rng(3)
        p = {"w": rng.standard_normal((16, 8)).astype(np.float32)}
        x = rng.standard_normal((3, 16)).astype(np.float32)
        want = jlayers.apply_linear({"w": jnp.asarray(p["w"])}, jnp.asarray(x), jnp.bfloat16)
        got = tlayers.apply_linear(params_from_jax(p, "cpu"), torch.from_numpy(x),
                                   torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), atol=5e-2, rtol=5e-2)

    def test_embed_unembed(self):
        rng = np.random.default_rng(4)
        p = {"embedding": rng.standard_normal((50, 16)).astype(np.float32)}
        toks = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
        tp = params_from_jax(p, "cpu")
        jp = {"embedding": jnp.asarray(p["embedding"])}
        e_want = jlayers.embed(jp, jnp.asarray(toks), jnp.float32)
        e_got = tlayers.embed(tp, torch.from_numpy(toks), torch.float32)
        np.testing.assert_array_equal(e_got.numpy(), np.asarray(e_want))
        l_want = jlayers.unembed(jp, e_want, jnp.float32)
        l_got = tlayers.unembed(tp, e_got, torch.float32)
        np.testing.assert_allclose(l_got.numpy(), np.asarray(l_want), atol=2e-5, rtol=2e-5)

    def test_init_shapes_and_determinism(self):
        mk = lambda: torch.Generator("cpu").manual_seed(5)
        a = tlayers.init_linear(mk(), 64, 32, torch.float32, bias=True)
        b = tlayers.init_linear(mk(), 64, 32, torch.float32, bias=True)
        assert a["w"].shape == (64, 32) and a["b"].shape == (32,)
        assert torch.equal(a["w"], b["w"]) and float(a["b"].abs().max()) == 0.0
        assert float(a["w"].abs().max()) <= 2.0 * 64 ** -0.5 + 1e-6   # truncated at 2 sigma
        assert 0.5 < float(a["w"].std()) * 64 ** 0.5 < 1.0
        e = tlayers.init_embedding(mk(), 100, 16, torch.bfloat16)
        assert e["embedding"].shape == (100, 16) and e["embedding"].dtype == torch.bfloat16
        assert tlayers.init_rmsnorm(8, torch.float32, "cpu")["scale"].tolist() == [1.0] * 8


class TestPositions:
    CFG = ModelConfig("x", "dense", 2, 64, 4, 2, 128, 32)

    @pytest.mark.parametrize("offset", [0, 5, np.array([0, 3, 9], np.int32)])
    def test_positions_for(self, offset):
        want = jlayers.positions_for(self.CFG, 3, 4, offset)
        toff = torch.from_numpy(offset) if isinstance(offset, np.ndarray) else offset
        got = tlayers.positions_for(self.CFG, 3, 4, toff)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_scalar_tensor_offset(self):
        got = tlayers.positions_for(self.CFG, 2, 3, torch.tensor(7, dtype=torch.int32))
        assert got.tolist() == [[7, 8, 9], [7, 8, 9]]

    def test_dtype_of(self):
        assert tlayers.dtype_of("bfloat16") == torch.bfloat16
        assert tlayers.dtype_of("float32") == torch.float32
