"""The VLM path of the port (qwen2-vl-2b, cut by `reduced` to 2 layers and
16 patches on a 4 x 4 grid) against the reference, on the CPU: M-RoPE, the
hoisted RoPE tables, `positions_for`, the twins of
tests/test_model_properties.py's RoPE properties, the forward over a
vision prefix, the prefill step with a vision prefix and grid ids and eight
decode steps after it, the loss and its gradients, the (3, B, S)
microbatch split, three `Trainer` steps, and the serving engine's greedy
streams and slot migration.

Weights come from the reference's `init_lm`, converted; inputs are drawn
with numpy.  Tolerance: fp32 2e-5 (tests/test_kernels.py's ``_tol``);
gradients and optimizer state 1e-4 and parameters after AdamW steps a
quarter of the learning rate, as tests/test_torch_train.py holds them (the
two frameworks sum in other orders).  Greedy streams must be EQUAL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import serve as jserve
from repro import train as jtrain
from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.train import trainer as jtrainer
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch import train as ttrain
from repro_torch._tree import tree_items, tree_leaves, tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax, state_from_jax, tree_to_numpy
from repro_torch.models import layers as tlayers
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen2-vl-2b"
VOCAB = 64
SIDE = 4                      # the patches' grid: SIDE x SIDE
P = SIDE * SIDE


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


def _draw(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _toks(rng, *shape):
    return rng.integers(0, VOCAB, size=shape).astype(np.int32)


def grid_positions(B, n_text, side=SIDE):
    """(3, B, side² + n_text) M-RoPE ids as Qwen2-VL numbers an image
    followed by text: patch i at t 0, h i // side, w i % side; the text
    counts on from ``side`` on all three axes."""
    i = np.arange(side * side)
    pos = np.empty((3, B, side * side + n_text), np.int32)
    pos[0, :, :side * side] = 0
    pos[1, :, :side * side] = i // side
    pos[2, :, :side * side] = i % side
    pos[:, :, side * side:] = side + np.arange(n_text)
    return pos


class VLM:
    """A reduced qwen2-vl in both packages, its weights from the reference."""

    def __init__(self, arch=ARCH, **overrides):
        self.jcfg = jmodels.reduced(jget_config(arch), vocab_size=VOCAB, **overrides)
        self.tcfg = tmodels.reduced(tget_config(arch), vocab_size=VOCAB, **overrides)
        self.params = jmodels.init_lm(jax.random.PRNGKey(0), self.jcfg)
        self.tparams = params_from_jax(jax.tree.map(np.asarray, self.params), "cpu")


@pytest.fixture(scope="module")
def vl():
    return VLM()


def _vision_batch(rng, B=2, n_text=24, d=128):
    toks = _toks(rng, B, n_text + 1)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "vision_embeds": _draw(rng, B, P, d), "positions": grid_positions(B, n_text)}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ------------------------------------------------------------- M-RoPE --
@pytest.mark.parametrize("grid", [False, True], ids=["text-ids", "grid-ids"])
def test_apply_mrope(grid):
    rng = np.random.default_rng(0)
    x = _draw(rng, 2, 20, 4, 32, scale=1.0)
    pos = grid_positions(2, 4) if grid else np.broadcast_to(
        np.arange(20, dtype=np.int32), (3, 2, 20)).copy()
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (8, 4, 4))
    got = tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (8, 4, 4))
    _close(got, want)
    for apply, arr in ((jlayers.apply_mrope, jnp.asarray), (tlayers.apply_mrope, torch.from_numpy)):
        with pytest.raises(ValueError, match="must sum to d_head/2=16"):
            apply(arr(x), arr(pos), 1e6, (8, 4, 5))


@pytest.mark.parametrize("arch", ["granite-3-2b", ARCH])
def test_rope_tables_and_apply_rope_tables(arch):
    jcfg, tcfg = jmodels.reduced(jget_config(arch)), tmodels.reduced(tget_config(arch))
    rng = np.random.default_rng(1)
    pos = grid_positions(2, 4) if jcfg.mrope else rng.integers(0, 50, (2, 20)).astype(np.int32)
    jt = jlayers.rope_tables(jcfg, jnp.asarray(pos))
    tt = tlayers.rope_tables(tcfg, torch.from_numpy(pos))
    for got, want in zip(tt, jt):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 20, 16)
        _close(got, want)
    x = _draw(rng, 2, 20, 4, 32, scale=1.0)
    _close(tlayers.apply_rope_tables(torch.from_numpy(x), tt),
           jlayers.apply_rope_tables(jnp.asarray(x), jt))


@pytest.mark.parametrize("offset", [0, 7, [3, 11]], ids=["0", "int", "per-row"])
def test_positions_for_under_mrope(vl, offset):
    want = jlayers.positions_for(vl.jcfg, 2, 5, jnp.asarray(offset))
    got = tlayers.positions_for(vl.tcfg, 2, 5, torch.tensor(offset), device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (3, 2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mrope_equals_rope_for_text():
    """tests/test_model_properties.py's twin: identical t/h/w ids reduce
    M-RoPE to standard RoPE."""
    x = torch.from_numpy(_draw(np.random.default_rng(2), 2, 8, 4, 32, scale=1.0))
    pos = torch.arange(8).expand(2, 8)
    a = tlayers.apply_rope(x, pos, 10_000.0)
    b = tlayers.apply_mrope(x, pos[None].expand(3, 2, 8), 10_000.0, (4, 6, 6))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-3-2b", ARCH])
def test_hoisted_tables_match_direct(arch):
    """tests/test_model_properties.py's twin, for granite and qwen2-vl."""
    cfg = tmodels.reduced(tget_config(arch))
    x = torch.from_numpy(_draw(np.random.default_rng(3), 2, 8, 4, cfg.d_head, scale=1.0))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    if cfg.mrope:
        pos = pos[None].expand(3, 2, 8)
        direct = tlayers.apply_mrope(x, pos, cfg.rope_theta, cfg.mrope_sections)
    else:
        direct = tlayers.apply_rope(x, pos, cfg.rope_theta)
    got = tlayers.apply_rope_tables(x, tlayers.rope_tables(cfg, pos))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-3-2b", ARCH])
def test_hoist_rope_flag_preserves_forward(arch):
    """tests/test_model_properties.py's twin: ``hoist_rope`` changes no
    hidden state beyond the reference's tolerance, and the port's hoisted
    forward equals the reference's."""
    m = VLM(arch)
    rng = np.random.default_rng(4)
    toks = _toks(rng, 2, 16)
    kwargs = {}
    if m.tcfg.family == "vlm":
        kwargs = {"vision_embeds": _draw(rng, 2, P, m.tcfg.d_model, scale=0.02),
                  "positions": np.broadcast_to(np.arange(16 + P, dtype=np.int32),
                                               (3, 2, 16 + P)).copy()}
    tk = {k: torch.from_numpy(v) for k, v in kwargs.items()}
    h1, _, _ = tmodels.forward(m.tparams, torch.from_numpy(toks), m.tcfg, **tk)
    hoisted = dataclasses.replace(m.tcfg, hoist_rope=True)
    h2, _, _ = tmodels.forward(m.tparams, torch.from_numpy(toks), hoisted, **tk)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-5, rtol=2e-4)
    jh, _, _ = jmodels.forward(m.params, jnp.asarray(toks),
                               dataclasses.replace(m.jcfg, hoist_rope=True), **_jnp(kwargs))
    _close(h2, jh)


# ------------------------------------------------------------- forward --
def test_param_tree_equals_the_reference(vl):
    own = tmodels.init_lm(torch.Generator("cpu").manual_seed(0), vl.tcfg)
    assert dict(tree_items(own)).keys() == dict(tree_items(vl.tparams)).keys()
    for (path, a), (_, b) in zip(tree_items(own), tree_items(vl.tparams)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert "unembed" not in own                      # tied


@pytest.mark.parametrize("hoist", [False, True], ids=["direct", "hoisted"])
def test_forward_with_a_vision_prefix(vl, hoist):
    batch = _vision_batch(np.random.default_rng(5))
    jcfg = dataclasses.replace(vl.jcfg, hoist_rope=hoist)
    tcfg = dataclasses.replace(vl.tcfg, hoist_rope=hoist)
    kw = dict(vision_embeds=batch["vision_embeds"], positions=batch["positions"])
    jh, _, _ = jmodels.forward(vl.params, jnp.asarray(batch["inputs"]), jcfg, **_jnp(kw))
    th, _, _ = tmodels.forward(vl.tparams, torch.from_numpy(batch["inputs"]), tcfg, **_torch(kw))
    assert tuple(th.shape) == (2, P + 24, 128)
    _close(th, jh)
    _close(tmodels.logits_fn(vl.tparams, th, tcfg), jmodels.logits_fn(vl.params, jh, jcfg))


def test_vision_prefill_then_eight_decode_steps(vl):
    """`make_prefill_step` with ``vision_embeds`` and grid ids in both
    packages, then 8 decode steps (text ids from the cache index, as the
    reference numbers them): every cache leaf and each step's logits."""
    rng = np.random.default_rng(6)
    toks = _toks(rng, 2, 6)
    batch = {"tokens": toks, "vision_embeds": _draw(rng, 2, P, 128),
             "positions": grid_positions(2, 6)}
    jpre = jax.jit(jserve.make_prefill_step(vl.jcfg, 48))
    jdec = jax.jit(jserve.make_decode_step(vl.jcfg))
    jc, jl = jpre(vl.params, _jnp(batch))
    tc, tl = tserve.make_prefill_step(vl.tcfg, 48, device="cpu")(vl.tparams, _torch(batch))
    _close(tl, jl)
    _assert_tree_close(tc, jc)
    assert int(tc["index"]) == P + 6
    tdec = tserve.make_decode_step(vl.tcfg)
    for step in range(8):
        nxt = _toks(rng, 2, 1)
        jc, jl = jdec(vl.params, jc, jnp.asarray(nxt))
        tc, tl = tdec(vl.tparams, tc, torch.from_numpy(nxt))
        _close(tl, jl, f"step {step}")
    _assert_tree_close(tc, jc)


# ------------------------------------------------------------ training --
def _loss_and_grads(tparams, tcfg, batch, loss_chunk=8):
    leaves = []

    def track(t):
        leaves.append(t.clone().requires_grad_(True))
        return leaves[-1]

    live = tree_map(track, tparams)
    loss, _ = tmodels.lm_loss(live, _torch(batch), tcfg, loss_chunk=loss_chunk)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_lm_loss_and_gradients_match_jax(vl):
    """The loss runs over the text suffix; its gradients reach the stub
    patch embeddings' path through every layer."""
    batch = _vision_batch(np.random.default_rng(7))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodels.lm_loss(
        p, _jnp(batch), vl.jcfg, loss_chunk=8)[0]))(vl.params)
    tl, grads = _loss_and_grads(vl.tparams, vl.tcfg, batch)
    _close(tl, jl)
    for (path, _), g, want in zip(tree_items(vl.tparams), grads, jax.tree.leaves(jg)):
        _close(g, want, path, **GRAD_TOL)


def test_microbatches_split_mrope_positions_on_their_batch_axis(vl):
    """`make_train_step(n_microbatch=2)` with (3, B, S) positions: the same
    update as one microbatch, and as the reference's split."""
    batch = _vision_batch(np.random.default_rng(8), B=4, n_text=16)
    batch["positions"][:, 2:] += 5                   # rows of the two halves differ
    opt = topt.make_optimizer("adamw", lr=1e-3, warmup=1, total_steps=10)
    jopt = jtrain.make_optimizer("adamw", lr=1e-3, warmup=1, total_steps=10)
    jstate = jtrain.init_state(jax.random.PRNGKey(0), vl.jcfg, jopt)
    params = {}
    for n in (1, 2):
        state = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
        _, metrics = ttrain.make_train_step(vl.tcfg, opt, loss_chunk=8, n_microbatch=n)(
            state, _torch(batch))
        params[n] = state["params"]
    jnew, jmetrics = jax.jit(jtrain.make_train_step(vl.jcfg, jopt, loss_chunk=8,
                                                    n_microbatch=2))(jstate, _jnp(batch))
    _close(metrics["loss"], jmetrics["loss"])
    for (path, a), (_, b) in zip(tree_items(params[2]), tree_items(params[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=path, **GRAD_TOL)
    _assert_tree_close(params[2], jnew["params"], **GRAD_TOL)


class _VisionData:
    """SyntheticLM's batches with patch embeddings drawn for each step and
    the grid's M-RoPE ids."""

    def __init__(self, data, d):
        self.data, self.d = data, d

    def batch_at(self, step):
        batch = dict(self.data.batch_at(step))
        B, S = batch["inputs"].shape
        batch["vision_embeds"] = _draw(np.random.default_rng(100 + step), B, P, self.d)
        batch["positions"] = grid_positions(B, S)
        return batch


def test_three_trainer_steps_match_the_jax_trainer(vl):
    from repro.data import pipeline as jdata
    from repro_torch.data import pipeline as tdata
    tc = dict(steps=3, log_every=100, loss_chunk=8)
    dcfg = dict(vocab_size=VOCAB, global_batch=2, seq_len=24, seed=0)
    jt = jtrainer.Trainer(vl.jcfg, jtrainer.TrainerConfig(**tc),
                          _VisionData(jdata.SyntheticLM(jdata.DataConfig(**dcfg)), 128))
    tt = ttrainer.Trainer(vl.tcfg, ttrainer.TrainerConfig(**tc),
                          _VisionData(tdata.SyntheticLM(tdata.DataConfig(**dcfg)), 128),
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


# ------------------------------------------------------------- serving --
def _requests(mod, n=6, seed=1, max_new=6):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(1, VOCAB, size=int(rng.integers(2, 7))).tolist(),
                        max_new_tokens=max_new) for i in range(n)]


def _run(engine, requests, max_steps=500):
    for r in requests:
        engine.submit(r)
    engine.run_until_done(max_steps)
    return {r.req_id: list(r.output) for r in requests}


def _engine(vl, slots=2, max_len=48, **kw):
    return tserve.ServeEngine(vl.tcfg, vl.tparams, batch_slots=slots, max_len=max_len,
                              eos_id=-1, device="cpu", **kw)


def test_greedy_streams_equal_the_jax_engine(vl):
    """6 text requests through 2 slots, M-RoPE ids from each slot's offset:
    every token of every stream."""
    jeng = jserve.ServeEngine(vl.jcfg, vl.params, batch_slots=2, max_len=48, eos_id=-1)
    want = _run(jeng, _requests(jserve))
    teng = _engine(vl)
    got = _run(teng, _requests(tserve))
    assert got == want and teng.steps == jeng.steps


def test_exported_slot_decodes_bit_identically(vl):
    mk = lambda: _engine(vl, slots=2, max_len=64, temperature=0.7, rng_seed=3)
    ref_eng = mk()
    ref = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
    ref_eng.submit(ref)
    ref_eng.run_until_done(200)
    src = mk()
    mig = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
    src.submit(mig)
    while len(mig.output) < 4:
        src.step()
    state = src.export_slot(0)
    mig.output, mig.done = mig.output[:4], False
    dst = mk()
    dst.import_slot(1, state)
    dst.slots[1] = mig
    dst.run_until_done(200)
    assert mig.done and mig.output == ref.output
    got, want = dst.export_slot(1), ref_eng.export_slot(0)
    assert got["offset"] == want["offset"]
    for a, b in zip(tree_leaves(got["blocks"]), tree_leaves(want["blocks"])):
        assert torch.equal(a, b)
