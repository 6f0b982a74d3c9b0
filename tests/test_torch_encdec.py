"""The encoder-decoder path of the port (seamless-m4t-large-v2, cut by
`reduced` to 2 encoder and 2 decoder layers) against the reference, on the
CPU: the parameter and cache trees, `layer_norm`, cross-attention, the
encoder, the decoder's forward over the encoder's memory, decode against a
full forward, the prefill step filling the cross cache and eight decode
steps after it, the refusals, `reset_slot`, the loss and its gradients,
the non-causal flash backward at Sq != Sk, and three `Trainer` steps.  Also
the twin of tests/test_arch_smoke.py's forward test over all ten archs.

Weights come from the reference's `init_lm`, converted; inputs are drawn
with numpy.  Tolerance: fp32 2e-5 (tests/test_kernels.py's ``_tol``);
gradients and optimizer state 1e-4 and parameters after AdamW steps a
quarter of the learning rate, as tests/test_torch_train.py holds them (the
two frameworks sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import serve as jserve
from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.transformer import encode as jencode
from repro.train import trainer as jtrainer
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch._tree import tree_items, tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax, state_from_jax, tree_to_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.train import trainer as ttrainer

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "seamless-m4t-large-v2"
VOCAB = 64
S_ENC = 16


def _np(t):
    return np.asarray(tree_to_numpy(t), np.float32)


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), err_msg=err_msg,
                               **(tol or TOL))


def _assert_tree_close(got, want, **tol):
    got = dict(tree_items(tree_to_numpy(got)))
    want = dict(tree_items(jax.tree.map(np.asarray, want)))
    assert list(got) == list(want)
    for path in got:
        _close(got[path], want[path], path, **tol)


def _jax_paths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in leaves]


def _draw(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _toks(rng, *shape, vocab=VOCAB):
    return rng.integers(0, vocab, size=shape).astype(np.int32)


class EncDec:
    """A reduced seamless in both packages, its weights from the reference."""

    def __init__(self, **overrides):
        self.jcfg = jmodels.reduced(jget_config(ARCH), vocab_size=VOCAB, **overrides)
        self.tcfg = tmodels.reduced(tget_config(ARCH), vocab_size=VOCAB, **overrides)
        self.params = jmodels.init_lm(jax.random.PRNGKey(0), self.jcfg)
        self.tparams = params_from_jax(jax.tree.map(np.asarray, self.params), "cpu")


@pytest.fixture(scope="module")
def ed():
    return EncDec()


def test_config_cut():
    cfg = tmodels.reduced(tget_config(ARCH))
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.family) == (2, 2, "encdec")


def test_param_and_cache_trees_equal_the_reference(ed):
    own = tmodels.init_lm(torch.Generator("cpu").manual_seed(0), ed.tcfg)
    want = _jax_paths(ed.params)
    assert [p for p, _ in tree_items(own)] == want
    assert "encoder.blocks.attn.wq.w" in want and "blocks.pos0.cross.wk.w" in want
    for (path, a), b in zip(tree_items(own), jax.tree.leaves(ed.params)):
        assert tuple(a.shape) == b.shape, path
    jc = jmodels.init_cache(ed.jcfg, 3, 24, cross_len=S_ENC, per_slot_index=True)
    tc = tmodels.init_cache(ed.tcfg, 3, 24, cross_len=S_ENC, per_slot_index=True, device="cpu")
    assert [p for p, _ in tree_items(tc)] == _jax_paths(jc)
    for (path, a), b in zip(tree_items(tc), jax.tree.leaves(jc)):
        assert tuple(a.shape) == b.shape, path
    assert tc["blocks"]["pos0"]["cross"]["k"].shape == (2, 3, S_ENC, 4, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(1)
    x, scale, bias = _draw(rng, 3, 5, 64, scale=3.0), _draw(rng, 64), _draw(rng, 64)
    want = jlayers.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale, dtype),
                              jnp.asarray(bias, dtype), 1e-5)
    tdt = getattr(torch, dtype)
    got = tlayers.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale).to(tdt),
                             torch.from_numpy(bias).to(tdt), 1e-5)
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else dict(atol=5e-2, rtol=5e-2)
    _close(got, want, **tol)
    init = tlayers.init_layernorm(64, torch.float32, device="cpu")
    assert [p for p, _ in tree_items(init)] == _jax_paths(jlayers.init_layernorm(64, jnp.float32))


@pytest.mark.parametrize("sq,sk", [(8, 16), (16, 8), (2048, 1024)],
                         ids=["sq<sk", "sq>sk", "flash-route"])
def test_cross_attention(ed, sq, sk):
    """`attention(kv_input=...)`: K and V from the memory, no RoPE, no
    causal mask; at Sq >= 2048 the route is `flash_attention_jnp`."""
    rng = np.random.default_rng(2)
    x, mem = _draw(rng, 1, sq, ed.jcfg.d_model), _draw(rng, 1, sk, ed.jcfg.d_model)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (1, sq))
    p = ed.params["blocks"]["pos0"]["cross"]
    want, _ = jattn.attention(jax.tree.map(lambda a: a[0], p), jnp.asarray(x), ed.jcfg,
                              jnp.asarray(pos), kv_input=jnp.asarray(mem))
    got, _ = tattn.attention(tree_map(lambda a: a[0], ed.tparams["blocks"]["pos0"]["cross"]),
                             torch.from_numpy(x), ed.tcfg, torch.from_numpy(pos.copy()),
                             kv_input=torch.from_numpy(mem))
    _close(got, want)


@pytest.mark.parametrize("s_enc", [S_ENC, 2048], ids=["gqa-route", "flash-route"])
def test_encode(ed, s_enc):
    embeds = _draw(np.random.default_rng(3), 2, s_enc, ed.jcfg.d_model)
    want = jax.jit(lambda p, e: jencode(p, e, ed.jcfg))(ed.params, jnp.asarray(embeds))
    got = tmodels.encode(ed.tparams, torch.from_numpy(embeds), ed.tcfg)
    _close(got, want)


def _memory(ed, rng, B=2, s_enc=S_ENC):
    embeds = _draw(rng, B, s_enc, ed.jcfg.d_model)
    return embeds, jencode(ed.params, jnp.asarray(embeds), ed.jcfg), \
        tmodels.encode(ed.tparams, torch.from_numpy(embeds), ed.tcfg)


def test_forward_with_encoder_out(ed):
    rng = np.random.default_rng(4)
    _, jenc, tenc = _memory(ed, rng)
    toks = _toks(rng, 2, 24)
    jh, _, _ = jmodels.forward(ed.params, jnp.asarray(toks), ed.jcfg, encoder_out=jenc)
    th, _, _ = tmodels.forward(ed.tparams, torch.from_numpy(toks), ed.tcfg, encoder_out=tenc)
    _close(th, jh)
    _close(tmodels.logits_fn(ed.tparams, th, ed.tcfg), jmodels.logits_fn(ed.params, jh, ed.jcfg))


def test_decode_matches_full_forward(ed):
    """tests/test_arch_smoke.py::test_decode_matches_full_forward on the
    port: S_enc 16, S 24; a prefill of 23 tokens fills the cross cache and
    the 24th token's decode, which reads it back, equals the full forward's
    last position."""
    rng = np.random.default_rng(5)
    _, _, tenc = _memory(ed, rng)
    toks = torch.from_numpy(_toks(rng, 2, 24))
    h_full, _, _ = tmodels.forward(ed.tparams, toks, ed.tcfg, encoder_out=tenc)
    cache = tmodels.init_cache(ed.tcfg, 2, 24, cross_len=S_ENC, device="cpu")
    _, cache, _ = tmodels.forward(ed.tparams, toks[:, :23], ed.tcfg, cache=cache,
                                  encoder_out=tenc)
    h_dec, cache, _ = tmodels.forward(ed.tparams, toks[:, 23:], ed.tcfg, cache=cache)
    np.testing.assert_allclose(h_dec[:, 0].numpy(), h_full[:, -1].numpy(), atol=2e-4,
                               rtol=2e-3)
    assert int(cache["index"]) == 24


def test_prefill_step_then_eight_decode_steps(ed):
    """`make_prefill_step(cross_len=)` with ``encoder_embeds`` in both
    packages, then 8 decode steps: every cache leaf (the cross K/V too) and
    the logits of each step."""
    rng = np.random.default_rng(6)
    embeds = _draw(rng, 2, S_ENC, ed.jcfg.d_model)
    toks = _toks(rng, 2, 5)
    jpre = jax.jit(jserve.make_prefill_step(ed.jcfg, 32, cross_len=S_ENC))
    jdec = jax.jit(jserve.make_decode_step(ed.jcfg))
    jc, jl = jpre(ed.params, {"tokens": jnp.asarray(toks), "encoder_embeds": jnp.asarray(embeds)})
    tpre = tserve.make_prefill_step(ed.tcfg, 32, cross_len=S_ENC, device="cpu")
    tdec = tserve.make_decode_step(ed.tcfg)
    tc, tl = tpre(ed.tparams, {"tokens": torch.from_numpy(toks),
                               "encoder_embeds": torch.from_numpy(embeds)})
    _close(tl, jl)
    _assert_tree_close(tc, jc)
    for step in range(8):
        nxt = _toks(rng, 2, 1)
        jc, jl = jdec(ed.params, jc, jnp.asarray(nxt))
        tc, tl = tdec(ed.tparams, tc, torch.from_numpy(nxt))
        _close(tl, jl, f"step {step}")
    _assert_tree_close(tc, jc)
    # The reference's cache, converted, decodes on in the port.
    conv = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    nxt = _toks(rng, 2, 1)
    _, jl = jdec(ed.params, jc, jnp.asarray(nxt))
    _, tl = tdec(ed.tparams, conv, torch.from_numpy(nxt))
    _close(tl, jl)


def test_what_the_cross_path_refuses(ed):
    """Decode without a cross cache raises the reference's ValueError; a
    cross cache whose length is not the encoder's raises one naming both."""
    with pytest.raises(ValueError, match="needs a cross cache"):
        jmodels.forward(ed.params, jnp.zeros((1, 1), jnp.int32), ed.jcfg,
                        cache=jmodels.init_cache(ed.jcfg, 1, 8))
    with pytest.raises(ValueError, match="needs a cross cache"):
        tmodels.forward(ed.tparams, torch.zeros((1, 1), dtype=torch.int32), ed.tcfg,
                        cache=tmodels.init_cache(ed.tcfg, 1, 8, device="cpu"))
    enc = torch.zeros(1, S_ENC, ed.tcfg.d_model)
    for cross_len in (0, S_ENC - 1):
        cache = tmodels.init_cache(ed.tcfg, 1, 8, cross_len=cross_len, device="cpu")
        with pytest.raises(ValueError, match=f"cross_len {cross_len} .* length {S_ENC}"):
            tmodels.forward(ed.tparams, torch.zeros((1, 2), dtype=torch.int32), ed.tcfg,
                            cache=cache, encoder_out=enc)


def test_reset_slot_zeroes_the_cross_caches(ed):
    rng = np.random.default_rng(7)
    cache = tmodels.init_cache(ed.tcfg, 3, 16, cross_len=S_ENC, per_slot_index=True,
                               device="cpu")
    tree_map(lambda t: t.copy_(torch.from_numpy(_draw(rng, *t.shape)).to(t.dtype))
             if t.is_floating_point() else t.fill_(5), cache)
    tmodels.reset_slot(cache, 1)
    cross = cache["blocks"]["pos0"]["cross"]
    for t in (cross["k"], cross["v"]):
        assert bool((t[:, 1] == 0).all()) and bool((t[:, [0, 2]] != 0).all())
    assert cache["index"].tolist() == [5, 0, 5]


def _batch(rng, B=2, S=24, s_enc=S_ENC, d=128):
    toks = _toks(rng, B, S + 1)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "encoder_embeds": _draw(rng, B, s_enc, d)}


def test_lm_loss_and_gradients_match_jax(ed):
    """The loss encodes ``encoder_embeds`` (encoder blocks under block
    remat) and its gradients reach every encoder and cross leaf."""
    batch = _batch(np.random.default_rng(8))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodels.lm_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, ed.jcfg, loss_chunk=8)[0]))(ed.params)
    leaves = []

    def track(t):
        leaves.append(t.clone().requires_grad_(True))
        return leaves[-1]

    live = tree_map(track, ed.tparams)
    tl, _ = tmodels.lm_loss(live, {k: torch.from_numpy(v) for k, v in batch.items()}, ed.tcfg,
                            loss_chunk=8)
    grads = torch.autograd.grad(tl, leaves)
    _close(tl.detach(), jl)
    paths = [p for p, _ in tree_items(ed.tparams)]
    for path, g, want in zip(paths, grads, jax.tree.leaves(jg)):
        _close(g, want, path, **GRAD_TOL)
    assert float(grads[paths.index("encoder.blocks.attn.wq.w")].abs().max()) > 0


@pytest.mark.parametrize("sq,sk", [(48, 80), (80, 48)], ids=["sq<sk", "sq>sk"])
def test_noncausal_flash_gradients_at_unequal_lengths(sq, sk):
    """`flash_attention_jnp`'s backward (the ported `_flash_bwd_rule`),
    non-causal, Sq != Sk, ragged last blocks in the port, against the
    reference's, and the forward's lse against the plain kernel version."""
    rng = np.random.default_rng(9)
    q, k, v = _draw(rng, 2, sq, 4, 32), _draw(rng, 2, sk, 2, 32), _draw(rng, 2, sk, 2, 32)
    w = _draw(rng, 2, sq, 4, 32)
    jq = lambda a, b, c: (jattn.flash_attention_jnp(a, b, c, False, 16, 16) * w).sum()
    want = jax.grad(jq, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn.flash_attention_jnp(*leaves, False, 32, 32)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for name, g, wnt in zip("qkv", got, want):
        _close(g, wnt, f"d{name}", **GRAD_TOL)
    plain_out, plain_lse = tflash.flash_attention_plain(*[t.detach() for t in leaves], False)
    _, lse = tattn._flash_fwd_math(*[t.detach() for t in leaves], False, 0, None, 32, 32)
    _close(out.detach(), plain_out)
    _close(lse, plain_lse)


class _EncoderData:
    """SyntheticLM's batches with frame embeddings drawn for each step."""

    def __init__(self, data, d, s_enc=S_ENC):
        self.data, self.d, self.s_enc = data, d, s_enc

    def batch_at(self, step):
        batch = dict(self.data.batch_at(step))
        rng = np.random.default_rng(100 + step)
        batch["encoder_embeds"] = _draw(rng, batch["inputs"].shape[0], self.s_enc, self.d)
        return batch


def test_three_trainer_steps_match_the_jax_trainer(ed):
    from repro.data import pipeline as jdata
    from repro_torch.data import pipeline as tdata
    tc = dict(steps=3, log_every=100, loss_chunk=8)
    dcfg = dict(vocab_size=VOCAB, global_batch=2, seq_len=24, seed=0)
    jt = jtrainer.Trainer(ed.jcfg, jtrainer.TrainerConfig(**tc),
                          _EncoderData(jdata.SyntheticLM(jdata.DataConfig(**dcfg)), 128))
    tt = ttrainer.Trainer(ed.tcfg, ttrainer.TrainerConfig(**tc),
                          _EncoderData(tdata.SyntheticLM(tdata.DataConfig(**dcfg)), 128),
                          device="cpu")
    jstate, _ = jt.init_or_restore()
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jstate = jt.run(state=jstate)
    tstate = tt.run(state=tstate)
    for got, want in zip(tt.metrics_log, jt.metrics_log):
        _close(got["loss"], want["loss"])
    got = dict(tree_items(tree_to_numpy(tstate)))
    want = dict(tree_items(jax.tree.map(np.asarray, jstate)))
    assert list(got) == list(want)
    for path in got:
        # parameters: a quarter of the learning rate (tests/test_torch_train.py)
        tol = dict(atol=2.5e-4, rtol=1e-4) if path.startswith("params") else GRAD_TOL
        _close(got[path], want[path], path, **tol)


# ------------------------------------------ every family, one forward --
def _arch_batch(cfg, B=2, S=32, seed=0):
    """tests/test_arch_smoke.py's `_batch`, drawn with numpy."""
    rng = np.random.default_rng(seed)
    batch = {"inputs": _toks(rng, B, S, vocab=cfg.vocab_size),
             "targets": _toks(rng, B, S, vocab=cfg.vocab_size)}
    if cfg.n_encoder_layers:
        batch["encoder_embeds"] = _draw(rng, B, 16, cfg.d_model, scale=0.02)
    if cfg.family == "vlm":
        P = cfg.vision_stub_patches
        batch["vision_embeds"] = _draw(rng, B, P, cfg.d_model, scale=0.02)
        batch["positions"] = np.broadcast_to(np.arange(S + P, dtype=np.int32),
                                             (3, B, S + P)).copy()
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_loss_of_every_arch_matches_the_reference(arch):
    """tests/test_arch_smoke.py::test_forward_shapes_and_finite on the port,
    held to the reference's loss: the port takes every family now.  The
    stacks' fp32 sums differ in order, so the loss is held at 2e-5 of its
    magnitude (tests/test_torch_xlstm.py)."""
    jcfg = jmodels.reduced(jget_config(arch))
    tcfg = tmodels.reduced(tget_config(arch))
    params = jmodels.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    batch = _arch_batch(jcfg)
    jl, _ = jax.jit(lambda p, b: jmodels.lm_loss(p, b, jcfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, metrics = tmodels.lm_loss(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  tcfg)
    assert bool(torch.isfinite(tl)) and float(tl) > 0
    np.testing.assert_allclose(float(tl), float(jl), atol=2e-5 * max(1.0, abs(float(jl))),
                               rtol=2e-5)
