"""Training in the port against the reference, on the CPU: optimizers,
schedule, loss and gradients, the train step, the data pipeline and the
trainer.  Weights and states are made by the reference and converted;
batches come from numpy.

Tolerances (fp32 throughout unless said): loss 1e-5 relative; gradients
and optimizer leaves 1e-4 (the two frameworks sum in other orders);
parameters after train steps a quarter of the learning rate (Adam's update
is lr * m / (sqrt(v) + eps), and for an element whose gradient is near eps
that ratio moves by a fraction of one when the gradient moves by 1e-4);
bf16 5e-2.  The int8 blocks of `adam8bit` may differ by one step of rounding
where a value lies on a rounding edge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import train as jtrain
from repro.configs import get_config as jget_config
from repro.data import pipeline as jdata
from repro.models import layers as jlayers
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch import train as ttrain
from repro_torch._tree import tree_items, tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax, state_from_jax, tree_to_numpy
from repro_torch.data import pipeline as tdata
from repro_torch.kernels.rmsnorm import rms_norm
from repro_torch.models import layers as tlayers
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

import torch_dist_util as du

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = dict(rtol=1e-5)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
DENSE = ["granite-3-2b", "qwen1.5-0.5b"]


def _np_tree(tree):
    return dict(tree_items(jax.tree.map(np.asarray, tree)))


def _assert_tree_close(got, want, **tol):
    got, want = dict(tree_items(tree_to_numpy(got))), _np_tree(want)
    assert list(got) == list(want)
    for path in got:
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(want[path], np.float64), err_msg=path, **tol)


def _models(arch, seed=0, **overrides):
    jcfg = jmodels.reduced(jget_config(arch), vocab_size=64, **overrides)
    tcfg = tmodels.reduced(tget_config(arch), vocab_size=64, **overrides)
    params = jmodels.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), "cpu")


def _batch(B, S, seed=0, vocab=64):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _grads_of(tparams, tcfg, batch, loss_chunk=0):
    leaves = []

    def track(p):
        leaves.append(p.detach().clone().requires_grad_(True))
        return leaves[-1]

    live = tree_map(track, tparams)
    loss, metrics = tmodels.lm_loss(live, batch, tcfg, loss_chunk=loss_chunk)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss, metrics, tree_map(lambda _: next(grads), live)


# ------------------------------------------------------------- optimizers --
def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"stack": {"w": (3, 128, 160)}, "mat": {"w": (130, 128)},
              "small": {"w": (16, 24)}, "scale": (40,), "tail": [{"b": (200,)}]}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v) for v in tree]
        return rng.standard_normal(tree).astype(np.float32) * 0.1

    return draw(shapes), [draw(shapes) for _ in range(3)]


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adam8bit"])
def test_optimizer_updates_per_leaf(name):
    """Three updates from the same params and gradients: params and every
    state leaf (fp32 moments, factored statistics, int8 blocks)."""
    params, grads = _opt_trees()
    jo = jopt.make_optimizer(name, lr=1e-2, warmup=2, total_steps=10)
    to = topt.make_optimizer(name, lr=1e-2, warmup=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    _assert_tree_close(ts, js, atol=0, rtol=0)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp2, ts = to.update(params_from_jax(g, "cpu"), ts, tp)
        assert tp2 is tp                          # in place
        _assert_tree_close(tp, jp, **TOL)
    if name == "adam8bit":
        got, want = dict(tree_items(tree_to_numpy(ts))), _np_tree(js)
        for path in got:
            if path.endswith(("mq", "vq")):
                assert got[path].dtype == np.int8
                assert np.abs(got[path].astype(int) - want[path].astype(int)).max() <= 1, path
            else:
                np.testing.assert_allclose(got[path], want[path], err_msg=path, **TOL)
    else:
        _assert_tree_close(ts, js, **TOL)


@pytest.mark.parametrize("run_elements", [1 << 26, 130 * 160, 7])
def test_large_leaves_go_in_runs(monkeypatch, run_elements):
    """Adafactor updates a large stacked leaf a run of leading rows at a
    time, and the global norm sums a large leaf a run at a time: the same
    values as the whole leaf at once, and as the reference's."""
    monkeypatch.setattr(topt, "_CHUNK_ELEMENTS", run_elements)
    params, grads = _opt_trees()
    params["experts"] = {"w": np.random.default_rng(5).standard_normal(
        (2, 3, 130, 160)).astype(np.float32)}
    for g in grads:
        g["experts"] = {"w": np.random.default_rng(6).standard_normal(
            (2, 3, 130, 160)).astype(np.float32)}
    jo = jopt.make_optimizer("adafactor", lr=1e-2, warmup=2, total_steps=10)
    to = topt.make_optimizer("adafactor", lr=1e-2, warmup=2, total_steps=10)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        np.testing.assert_allclose(float(topt.global_norm(params_from_jax(g, "cpu"))),
                                   float(jopt.global_norm(jax.tree.map(jnp.asarray, g))),
                                   rtol=1e-6)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(params_from_jax(g, "cpu"), ts, tp)
    _assert_tree_close(tp, jp, **TOL)
    _assert_tree_close(ts, js, **TOL)


def test_cosine_schedule():
    jlr, tlr = jopt.cosine_schedule(3e-4, 5, 40), topt.cosine_schedule(3e-4, 5, 40)
    for step in range(0, 45):
        np.testing.assert_allclose(float(tlr(torch.tensor(step, dtype=torch.int32))),
                                   float(jlr(jnp.int32(step))), rtol=1e-6)
        np.testing.assert_allclose(float(tlr(step)), float(jlr(step)), rtol=1e-6)


def test_global_norm_and_clip():
    _, grads = _opt_trees(1)
    jg, tg = jax.tree.map(jnp.asarray, grads[0]), params_from_jax(grads[0], "cpu")
    np.testing.assert_allclose(float(topt.global_norm(tg)), float(jopt.global_norm(jg)),
                               rtol=1e-6)
    for max_norm in (0.5, 1e3):
        (tc, tn), (jc, jn) = topt.clip_by_global_norm(tg, max_norm), \
            jopt.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tc, jc, atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------- loss and grads --
@pytest.mark.parametrize("S", [16, 2048])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_and_grads_match_jax(arch, S):
    """S = 2048 crosses the chunked threshold: the reference and the port
    both take the flash branch with its hand-written backward."""
    jcfg, tcfg, params, tparams = _models(arch)
    batch = _batch(1 if S > 16 else 2, S)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.lm_loss(p, b, jcfg), has_aux=True))(params, _jbatch(batch))
    tl, tm, tg = _grads_of(tparams, tcfg, _tbatch(batch))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]), **LOSS_TOL)
    assert float(tm["aux"]) == 0.0
    _assert_tree_close(tg, jg, **TOL)


def test_loss_chunk_microbatch_and_remat_agree():
    """loss_chunk, n_microbatch=2 and remat none/block/dots change how the
    loss and gradients are computed, not their values; an unknown remat
    raises."""
    _, tcfg, _, tparams = _models("granite-3-2b")
    batch = _tbatch(_batch(2, 16, seed=3))
    base_l, _, base_g = _grads_of(tparams, tcfg, batch)
    for cfg, chunk in ((tcfg, 4), (dataclasses.replace(tcfg, remat="none"), 0),
                       (dataclasses.replace(tcfg, remat="block"), 8),
                       (dataclasses.replace(tcfg, remat="dots"), 0)):
        l, _, g = _grads_of(tparams, cfg, batch, loss_chunk=chunk)
        np.testing.assert_allclose(float(l.detach()), float(base_l.detach()), **LOSS_TOL)
        for (path, a), (_, b) in zip(tree_items(g), tree_items(base_g)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=path, **TOL)
    opt = topt.make_optimizer("adamw")
    params = {}
    for n in (1, 2):
        state = ttrain.init_state(torch.Generator("cpu").manual_seed(0), tcfg, opt)
        ttrain.make_train_step(tcfg, opt, n_microbatch=n)(state, batch)
        params[n] = state["params"]
    for (path, a), (_, b) in zip(tree_items(params[2]), tree_items(params[1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=path, **TOL)
    with pytest.raises(ValueError, match="remat"):
        tmodels.forward(tparams, batch["inputs"], dataclasses.replace(tcfg, remat="all"))


def test_bf16_cotangent_barrier():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jgrad = jax.grad(lambda a: (jlayers.bf16_cotangent_barrier(a).astype(jnp.float32)
                                * w).sum())(jx)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = tlayers.bf16_cotangent_barrier(tx)
    assert torch.equal(y, tx)
    (tgrad,) = torch.autograd.grad((y.float() * torch.from_numpy(w)).sum(), tx)
    assert tgrad.dtype == torch.bfloat16
    np.testing.assert_array_equal(tree_to_numpy(tgrad), np.asarray(jgrad, np.float32))
    fx = torch.from_numpy(x)
    assert tlayers.bf16_cotangent_barrier(fx) is fx           # no-op for fp32


def test_bf16_model_with_barriers_matches_jax():
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16", bf16_cotangent=True)
    jcfg, tcfg, params, tparams = _models("granite-3-2b", **over)
    batch = _batch(2, 16, seed=5)
    (jl, _), jg = jax.value_and_grad(lambda p, b: jmodels.lm_loss(p, b, jcfg),
                                     has_aux=True)(params, _jbatch(batch))
    tl, _, tg = _grads_of(tparams, tcfg, _tbatch(batch))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-2)
    for (path, g), (_, w) in zip(tree_items(tree_to_numpy(tg)), tree_items(_np_tree(jg))):
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g / scale, w / scale, err_msg=path, **BF16_TOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_rms_norm_gradient_matches_jax(bf16):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 2
    s = rng.standard_normal(64).astype(np.float32)
    w = rng.standard_normal((3, 7, 64)).astype(np.float32)
    jt = jnp.bfloat16 if bf16 else jnp.float32
    tt = torch.bfloat16 if bf16 else torch.float32
    jg = jax.grad(lambda a, b: (jlayers.rms_norm(a, b, 1e-5).astype(jnp.float32) * w).sum(),
                  argnums=(0, 1))(jnp.asarray(x, jt), jnp.asarray(s, jt))
    tx = torch.from_numpy(x).to(tt).requires_grad_(True)
    ts = torch.from_numpy(s).to(tt).requires_grad_(True)
    out = rms_norm(tx, ts, 1e-5)
    assert out.grad_fn is not None and "RMSNorm" in type(out.grad_fn).__name__
    tg = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), (tx, ts))
    tol = BF16_TOL if bf16 else dict(atol=1e-5, rtol=1e-5)
    for g, want in zip(tg, jg):
        assert g.dtype == tt
        np.testing.assert_allclose(tree_to_numpy(g), np.asarray(want, np.float32), **tol)
    with torch.no_grad():
        assert rms_norm(tx, ts, 1e-5).grad_fn is None


# -------------------------------------------------------------- train step --
@pytest.mark.parametrize("name", ["adamw", "adafactor", "adam8bit"])
def test_three_train_steps_from_one_state(name):
    jcfg, tcfg, _, _ = _models("granite-3-2b", optimizer=name)
    jo = jopt.make_optimizer(name, lr=1e-3, warmup=1, total_steps=3)
    to = topt.make_optimizer(name, lr=1e-3, warmup=1, total_steps=3)
    jstate = jtrain.init_state(jax.random.PRNGKey(1), jcfg, jo)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert [p for p, _ in tree_items(tstate)] == list(_np_tree(jstate))
    for (path, t), a in zip(tree_items(tstate), jax.tree.leaves(jstate)):
        assert str(t.dtype) == f"torch.{a.dtype}", path        # int8 / int32 kept
    jstep = jax.jit(jtrain.make_train_step(jcfg, jo, loss_chunk=8))
    tstep = ttrain.make_train_step(tcfg, to, loss_chunk=8)
    for i in range(3):
        batch = _batch(2, 16, seed=10 + i)
        jstate, jm = jstep(jstate, _jbatch(batch))
        tstate, tm = tstep(tstate, _tbatch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(tstate["step"]) == 3 and int(tstate["opt"]["step"]) == 3
    _assert_tree_close(tstate["params"], jstate["params"], atol=2.5e-4, rtol=1e-4)
    if name != "adam8bit":
        _assert_tree_close(tstate["opt"], jstate["opt"], **TOL)


def test_state_shapes_on_the_meta_device():
    jcfg, tcfg, _, _ = _models("qwen1.5-0.5b")
    for name in ("adamw", "adafactor", "adam8bit"):
        want = jtrain.state_shapes(jcfg, jopt.make_optimizer(name))
        got = ttrain.state_shapes(tcfg, topt.make_optimizer(name))
        assert [p for p, _ in tree_items(got)] == list(_np_tree(jax.tree.map(
            lambda s: np.zeros((), s.dtype), want)))
        for (path, t), s in zip(tree_items(got), jax.tree.leaves(want)):
            assert t.device.type == "meta" and tuple(t.shape) == tuple(s.shape), path


# -------------------------------------------------------------------- data --
def test_data_pipeline_batches_are_bit_equal(tmp_path):
    cfg = dict(vocab_size=49155, global_batch=4, seq_len=33, seed=3, n_hosts=2, host_index=1)
    jsrc, tsrc = jdata.SyntheticLM(jdata.DataConfig(**cfg)), tdata.SyntheticLM(
        tdata.DataConfig(**cfg))
    for step in (0, 1, 17):
        for key, want in jsrc.batch_at(step).items():
            got = tsrc.batch_at(step)[key]
            assert got.dtype == want.dtype and np.array_equal(got, want)
    path = tmp_path / "text.txt"
    path.write_text("the port reads the same bytes " * 20)
    dcfg = dict(vocab_size=258, global_batch=2, seq_len=16, seed=1)
    jtext, ttext = jdata.TextFileLM(str(path), jdata.DataConfig(**dcfg)), \
        tdata.TextFileLM(str(path), tdata.DataConfig(**dcfg))
    for step in (0, 5):
        for key in ("inputs", "targets"):
            assert np.array_equal(ttext.batch_at(step)[key], jtext.batch_at(step)[key])
    tok = tdata.ByteTokenizer()
    assert tok.decode(tok.encode("héllo")) == "héllo" and tok.vocab_size == 258
    pre = tdata.Prefetcher(iter([1, 2, 3]), depth=2)
    assert list(pre) == [1, 2, 3]
    pre.close()


# ----------------------------------------------------------------- trainer --
def test_trainer_three_steps_match_the_jax_trainer():
    jcfg, tcfg, _, _ = _models("granite-3-2b")
    tc = dict(steps=3, log_every=100, loss_chunk=8)
    jt = jtrainer.make_synthetic_trainer(jcfg, jtrainer.TrainerConfig(**tc), 2, 16)
    tt = ttrainer.make_synthetic_trainer(tcfg, ttrainer.TrainerConfig(**tc), 2, 16, device="cpu")
    jstate, _ = jt.init_or_restore()
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jt.run(state=jstate)
    tt.run(state=tstate)
    assert [r["step"] for r in tt.metrics_log] == [0, 1, 2]
    for got, want in zip(tt.metrics_log, jt.metrics_log):
        np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
        assert np.isfinite(got["grad_norm"]) and got["dt_s"] > 0
    fresh = ttrainer.make_synthetic_trainer(tcfg, ttrainer.TrainerConfig(steps=1), 2, 16,
                                            device="cpu")
    state = fresh.run()
    assert int(state["step"]) == 1 and np.isfinite(fresh.metrics_log[0]["loss"])


def test_trainer_refuses_what_waits(tmp_path):
    """A `DeviceMesh` is taken (a one-rank gloo mesh: the state becomes
    DTensors, the job trains, and its saved state restores into the mesh's
    placements bit for bit); anything else as a mesh raises."""
    tcfg = tmodels.reduced(tget_config("granite-3-2b"))
    data = tdata.SyntheticLM(tdata.DataConfig(vocab_size=tcfg.vocab_size, global_batch=1,
                                              seq_len=8))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttrainer.Trainer(tcfg, ttrainer.TrainerConfig(), data, mesh=object(), device="cpu")
    [ran] = du.run_ranks("rank_trainer_on_a_mesh", 1, tmp_path)
    assert ran["all_dtensors"] and ran["steps"] == [0, 1] and np.all(np.isfinite(ran["losses"]))
    assert ran["restored_dtensors"] and ran["restored_equal"]


# ------------------------------------------------- serving stays grad-free --
def test_serving_keeps_no_graph():
    """`forward` runs under autograd when grad is enabled; the serving steps
    turn it off, so their logits carry no graph."""
    _, tcfg, params, tparams = _models("qwen1.5-0.5b")
    live = tree_map(lambda p: p.requires_grad_(True), tparams)
    engine = tserve.ServeEngine(tcfg, live, batch_slots=2, max_len=16, eos_id=-1, device="cpu")
    seen = []
    inner = engine._decode

    def decode(p, cache, tokens):
        cache, logits = inner(p, cache, tokens)
        seen.append(logits)
        return cache, logits

    engine._decode = decode
    engine.submit(tserve.Request(0, [1, 2, 3], max_new_tokens=2))
    engine.step()
    assert seen and all(not lg.requires_grad and lg.grad_fn is None for lg in seen)
    cache, logits = tserve.make_prefill_step(tcfg, 8, device="cpu")(
        live, {"tokens": torch.ones((1, 4), dtype=torch.int32)})
    assert not logits.requires_grad
    assert not any(t.requires_grad for _, t in tree_items(cache))
    hidden, _, _ = tmodels.forward(live, torch.ones((1, 4), dtype=torch.int32), tcfg)
    assert hidden.requires_grad                   # outside serving, autograd is on
