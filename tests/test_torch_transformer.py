"""The dense decoder of the port against the reference: the same weights
(made by the reference's `init_lm`, converted) and the same tokens go
through both; hidden states, logits and every cache leaf agree to 1e-4 in
fp32 (the two frameworks sum in another order; nothing else differs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.models.transformer import reset_slot as jreset_slot
from repro_torch import models as tmodels
from repro_torch._tree import tree_items
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax, tree_to_numpy
from repro_torch.serve import make_decode_step, make_prefill_step

TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ["qwen1.5-0.5b", "granite-3-2b"]


def _jax_paths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in leaves]


def _setup(arch, seed=0, **overrides):
    jcfg = jmodels.reduced(jget_config(arch), vocab_size=64, **overrides)
    tcfg = tmodels.reduced(tget_config(arch), vocab_size=64, **overrides)
    params = jmodels.init_lm(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, tcfg, params, tparams


def _assert_tree_close(got, want, **tol):
    got, want = dict(tree_items(tree_to_numpy(got))), dict(tree_items(
        jax.tree.map(np.asarray, want)))
    assert list(got) == list(want)
    for path in got:
        np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)


@pytest.mark.parametrize("arch", DENSE)
def test_leaf_paths_equal_the_reference(arch):
    jcfg, tcfg, params, tparams = _setup(arch)
    own = tmodels.init_lm(torch.Generator("cpu").manual_seed(0), tcfg)
    want = _jax_paths(params)
    assert [p for p, _ in tree_items(own)] == want
    assert [p for p, _ in tree_items(tparams)] == want
    for (_, a), (_, b) in zip(tree_items(own), tree_items(tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    jc = jmodels.init_cache(jcfg, 3, 16, per_slot_index=True)
    tc = tmodels.init_cache(tcfg, 3, 16, per_slot_index=True, device="cpu")
    assert [p for p, _ in tree_items(tc)] == _jax_paths(jc)
    for (_, a), b in zip(tree_items(tc), jax.tree.leaves(jc)):
        assert tuple(a.shape) == tuple(b.shape)
    assert tc["index"].dtype == torch.int32 and tc["tail"] == []
    assert tmodels.init_cache(tcfg, 3, 16, device="cpu")["index"].shape == ()


@pytest.mark.parametrize("arch", DENSE)
def test_full_sequence_hidden_and_logits(arch):
    jcfg, tcfg, params, tparams = _setup(arch)
    toks = np.random.default_rng(0).integers(0, 64, size=(2, 12)).astype(np.int32)
    jh, jc, _ = jmodels.forward(params, jnp.asarray(toks), jcfg)
    th, tc, aux = tmodels.forward(tparams, torch.from_numpy(toks), tcfg)
    assert jc is None and tc is None and float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tmodels.logits_fn(tparams, th, tcfg).numpy(),
                               np.asarray(jmodels.logits_fn(params, jh, jcfg)), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_eight_decode_steps_per_slot(arch):
    """Prefill 3 rows into the cache, give each row its own index, then
    decode 8 steps: hidden, logits and every cache leaf at every step."""
    jcfg, tcfg, params, tparams = _setup(arch)
    rng = np.random.default_rng(1)
    B, S, L = 3, 6, 24
    toks = rng.integers(0, 64, size=(B, S)).astype(np.int32)
    jc = jmodels.init_cache(jcfg, B, L, per_slot_index=True)
    tc = tmodels.init_cache(tcfg, B, L, per_slot_index=True, device="cpu")
    jh, jc, _ = jmodels.forward(params, jnp.asarray(toks), jcfg, cache=jc)
    th, tc, _ = tmodels.forward(tparams, torch.from_numpy(toks), tcfg, cache=tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _assert_tree_close(tc, jc, **TOL)
    # ragged slots: rewind two rows, as an engine with requests of other ages
    ragged = np.array([6, 2, 4], np.int32)
    jc = dict(jc, index=jnp.asarray(ragged))
    tc = dict(tc, index=torch.from_numpy(ragged.copy()))
    jstep = jax.jit(lambda p, c, t: jmodels.forward(p, t, jcfg, cache=c)[:2])
    for step in range(8):
        tok = rng.integers(0, 64, size=(B, 1)).astype(np.int32)
        jh, jc = jstep(params, jc, jnp.asarray(tok))
        th, tc, _ = tmodels.forward(tparams, torch.from_numpy(tok), tcfg, cache=tc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), err_msg=f"step {step}", **TOL)
        np.testing.assert_allclose(tmodels.logits_fn(tparams, th, tcfg).numpy(),
                                   np.asarray(jmodels.logits_fn(params, jh, jcfg)), **TOL)
        _assert_tree_close(tc, jc, **TOL)
    assert tc["index"].tolist() == (ragged + 8).tolist()


@pytest.mark.parametrize("arch", DENSE)
def test_decode_with_scalar_index_and_step_makers(arch):
    jcfg, tcfg, params, tparams = _setup(arch)
    from repro.serve import make_decode_step as jmake_decode, make_prefill_step as jmake_prefill
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 64, size=(2, 5)).astype(np.int32)
    jc, jl = jmake_prefill(jcfg, 16)(params, {"tokens": jnp.asarray(toks)})
    tc, tl = make_prefill_step(tcfg, 16, device="cpu")(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["index"].shape == () and int(tc["index"]) == 5
    jdec, tdec = jmake_decode(jcfg), make_decode_step(tcfg)
    for _ in range(3):
        tok = rng.integers(0, 64, size=(2, 1)).astype(np.int32)
        jc, jl = jdec(params, jc, jnp.asarray(tok))
        tc, tl = tdec(tparams, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, 64)
    _assert_tree_close(tc, jc, **TOL)


def test_untied_head_and_unscanned_stack():
    """nemotron: relu2 FFN, untied unembedding; scan_layers=False unrolls
    the stack into one period of n_layers positions."""
    for overrides in ({}, {"scan_layers": False}):
        jcfg, tcfg, params, tparams = _setup("nemotron-4-15b", **overrides)
        assert [p for p, _ in tree_items(tparams)] == _jax_paths(params)
        toks = np.random.default_rng(3).integers(0, 64, size=(2, 7)).astype(np.int32)
        jh, _, _ = jmodels.forward(params, jnp.asarray(toks), jcfg)
        th, _, _ = tmodels.forward(tparams, torch.from_numpy(toks), tcfg)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tmodels.logits_fn(tparams, th, tcfg).numpy(),
                                   np.asarray(jmodels.logits_fn(params, jh, jcfg)), **TOL)


def test_reset_slot():
    jcfg, tcfg, params, tparams = _setup("granite-3-2b")
    toks = np.random.default_rng(4).integers(0, 64, size=(3, 5)).astype(np.int32)
    jc = jmodels.init_cache(jcfg, 3, 8, per_slot_index=True)
    tc = tmodels.init_cache(tcfg, 3, 8, per_slot_index=True, device="cpu")
    _, jc, _ = jmodels.forward(params, jnp.asarray(toks), jcfg, cache=jc)
    _, tc, _ = tmodels.forward(tparams, torch.from_numpy(toks), tcfg, cache=tc)
    jc, tc2 = jreset_slot(jc, 1), tmodels.reset_slot(tc, 1)
    assert tc2 is tc                                  # in place
    _assert_tree_close(tc, jc, **TOL)
    assert tc["index"].tolist() == [5, 0, 5]
    k = tc["blocks"]["pos0"]["attn"]["k"]
    assert float(k[:, 1].abs().max()) == 0.0 and float(k[:, 0].abs().max()) > 0.0


def test_bf16_weights_cross_exactly():
    """ml_dtypes bfloat16 arrays convert bit for bit, and back."""
    jcfg, tcfg, _, _ = _setup("granite-3-2b")
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    params = jax.tree.map(np.asarray, jmodels.init_lm(jax.random.PRNGKey(1), jcfg))
    tparams = params_from_jax(params, "cpu")
    for (path, t), a in zip(tree_items(tparams), jax.tree.leaves(params)):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(tree_to_numpy(t), a.astype(np.float32))
    wide = params_from_jax(params, "cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for _, t in tree_items(wide))
    payload = {"index": np.int32(3), "blocks": {"k": np.ones((2, 2), np.float32)},
               "tail": [], "offset": 3}
    back = cache_from_jax(payload, "cpu")
    assert back["offset"] == 3 and back["index"].dtype == torch.int32 and back["tail"] == []


def test_module_registers_the_tree():
    _, tcfg, params, tparams = _setup("qwen1.5-0.5b")
    model = tmodels.DecoderLM(tcfg, tparams, device="cpu")
    assert sorted(model.state_dict()) == sorted(_jax_paths(params))
    assert [p for p, _ in tree_items(model.params)] == _jax_paths(params)
    assert not any(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 64, size=(1, 4)).astype(np.int32))
    h, _ = model(toks)
    want, _, _ = tmodels.forward(tparams, toks, tcfg)
    assert torch.equal(h, want) and model.logits(h).shape == (1, 4, 64)
    half = model.to(torch.float64)
    assert half.params["embed"]["embedding"].dtype == torch.float64
    fresh = tmodels.DecoderLM(tcfg, generator=torch.Generator("cpu").manual_seed(7), device="cpu")
    assert sorted(fresh.state_dict()) == sorted(model.state_dict())


def test_unsupported_forward_options_raise():
    _, tcfg, _, tparams = _setup("granite-3-2b")
    toks = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat"):
        tmodels.forward(tparams, toks, dataclasses.replace(tcfg, remat="all"))
    dots, _, _ = tmodels.forward(tparams, toks, dataclasses.replace(tcfg, remat="dots"))
    assert torch.equal(dots, tmodels.forward(tparams, toks, tcfg)[0])
    # accepted and ignored in inference
    loose = dataclasses.replace(tcfg, remat="none", psum_barrier=True, bf16_cotangent=True)
    a, _, _ = tmodels.forward(tparams, toks, loose)
    b, _, _ = tmodels.forward(tparams, toks, tcfg)
    assert torch.equal(a, b)
