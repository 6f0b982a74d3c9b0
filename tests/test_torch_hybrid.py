"""The Mamba2 hybrid stack of the port (zamba2-7b, cut by `reduced`) against
the reference, on the CPU: parameter and cache trees, forward, prefill and
decode with the cache leaf for leaf, `reset_slot`, the serving engine's
streams and slot migration, and the training loss, gradients and one AdamW
step.  Weights come from the reference's `init_lm` and are converted; tokens
are drawn with numpy.

Two cuts: 4 layers (two periods of two, each opened by the shared attention
block) and 5 layers (the same plus one tail layer, with its own shared
block cache ``tail_shared``).  Tolerances: 1e-4 (fp32; the two frameworks
add in other orders), the SSM state leaves 1e-3 (tests/test_kernels.py's
state tolerance).  Greedy streams must be EQUAL.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import serve as jserve
from repro.configs import get_config as jget_config
from repro.models.transformer import reset_slot as jreset_slot
from repro.train import trainer as jtrainer
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch._tree import tree_items, tree_leaves, tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax, state_from_jax, tree_to_numpy
from repro_torch.kernels import ssm_scan as tscan
from repro_torch.train import trainer as ttrainer

TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-3, rtol=1e-3)
VOCAB = 64


def _jax_paths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in leaves]


def _configs(n_layers, **overrides):
    jcfg = jmodels.reduced(jget_config("zamba2-7b"), vocab_size=VOCAB, n_layers=n_layers,
                           **overrides)
    tcfg = tmodels.reduced(tget_config("zamba2-7b"), vocab_size=VOCAB, n_layers=n_layers,
                           **overrides)
    return jcfg, tcfg


class Zamba:
    """A reduced zamba2 in both packages, with the reference's compiled
    functions shared by the tests of a module."""

    def __init__(self, n_layers):
        self.n_layers = n_layers
        self.jcfg, self.tcfg = _configs(n_layers)
        self.params = jmodels.init_lm(jax.random.PRNGKey(0), self.jcfg)
        self.tparams = params_from_jax(jax.tree.map(np.asarray, self.params), "cpu")
        cfg = self.jcfg
        self.jforward = jax.jit(lambda p, t: jmodels.forward(p, t, cfg)[0])
        self.jstep = jax.jit(lambda p, c, t: jmodels.forward(p, t, cfg, cache=c)[:2])


@pytest.fixture(scope="module", params=[4, 5], ids=["4-layers", "5-layers"])
def zamba(request):
    return Zamba(request.param)


@pytest.fixture(scope="module")
def zamba5():
    return Zamba(5)


def _assert_tree_close(got, want):
    got = dict(tree_items(tree_to_numpy(got)))
    want = dict(tree_items(jax.tree.map(np.asarray, want)))
    assert list(got) == list(want)
    for path in got:
        tol = STATE_TOL if path.endswith("state") else TOL
        np.testing.assert_allclose(got[path], np.asarray(want[path], np.float32),
                                   err_msg=path, **tol)


def _toks(rng, *shape):
    return rng.integers(0, VOCAB, size=shape).astype(np.int32)


# ------------------------------------------------------------------ trees --
def test_layout_of_the_cuts(zamba):
    layout = tmodels.stack_layout(zamba.tcfg)
    assert (layout.period, layout.n_full, layout.shared_attn) == (2, 2, True)
    assert len(layout.tail) == zamba.n_layers - 4
    full = tmodels.stack_layout(tget_config("zamba2-7b"))
    assert (full.period, full.n_full, len(full.tail)) == (6, 13, 3)


def test_param_and_cache_trees_equal_the_reference(zamba):
    own = tmodels.init_lm(torch.Generator("cpu").manual_seed(0), zamba.tcfg)
    want = _jax_paths(zamba.params)
    assert [p for p, _ in tree_items(own)] == want
    assert [p for p, _ in tree_items(zamba.tparams)] == want
    assert "shared_attn.attn.wq.w" in want
    for (path, a), b in zip(tree_items(own), jax.tree.leaves(zamba.params)):
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}", path
    for overrides in ({}, {"compute_dtype": "bfloat16"}):
        jcfg, tcfg = _configs(zamba.n_layers, **overrides)
        jc = jmodels.init_cache(jcfg, 3, 16, per_slot_index=True)
        tc = tmodels.init_cache(tcfg, 3, 16, per_slot_index=True, device="cpu")
        assert [p for p, _ in tree_items(tc)] == _jax_paths(jc)
        for (path, a), b in zip(tree_items(tc), jax.tree.leaves(jc)):
            assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}", path
        assert len(tc["tail_shared"]) == zamba.n_layers - 4
        assert tc["shared"]["attn"]["k"].shape[0] == 2


def test_full_size_cache_counts_shared_blocks():
    """zamba2-7b: 13 periods of 6 and 3 tail layers; the shared block runs
    before layer 78 (tail position 0) only."""
    cfg = tget_config("zamba2-7b")
    c = tmodels.init_cache(cfg, 1, 2, device="meta")
    assert c["shared"]["attn"]["k"].shape == (13, 1, 2, 32, 112)
    assert len(c["tail_shared"]) == 1 and len(c["tail"]) == 3
    assert c["tail"][0]["mixer"]["state"].dtype == torch.float32


# ---------------------------------------------------------------- forward --
@pytest.mark.parametrize("S", [32, 12], ids=["kernel-route", "chunk-1-route"])
def test_forward_hidden_states(zamba, S):
    toks = _toks(np.random.default_rng(S), 2, S)
    want = zamba.jforward(zamba.params, jnp.asarray(toks))
    got, cache, aux = tmodels.forward(zamba.tparams, torch.from_numpy(toks), zamba.tcfg)
    assert cache is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tmodels.logits_fn(zamba.tparams, got, zamba.tcfg).numpy(),
                               np.asarray(jmodels.logits_fn(zamba.params, want, zamba.jcfg)),
                               **TOL)


def test_prefill_then_eight_decode_steps(zamba):
    """Prefill 3 rows into the cache (the chunked scan from a given state),
    give each row its own index, then decode 8 steps (the one-step
    recurrence): hidden states and every cache leaf at every step."""
    rng = np.random.default_rng(1)
    B, S, L = 3, 6, 24
    toks = _toks(rng, B, S)
    jc = jmodels.init_cache(zamba.jcfg, B, L, per_slot_index=True)
    tc = tmodels.init_cache(zamba.tcfg, B, L, per_slot_index=True, device="cpu")
    jh, jc = zamba.jstep(zamba.params, jc, jnp.asarray(toks))
    th, tc, _ = tmodels.forward(zamba.tparams, torch.from_numpy(toks), zamba.tcfg, cache=tc)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _assert_tree_close(tc, jc)
    ragged = np.array([6, 2, 4], np.int32)
    jc = dict(jc, index=jnp.asarray(ragged))
    tc = dict(tc, index=torch.from_numpy(ragged.copy()))
    for step in range(8):
        tok = _toks(rng, B, 1)
        jh, jc = zamba.jstep(zamba.params, jc, jnp.asarray(tok))
        th, tc, _ = tmodels.forward(zamba.tparams, torch.from_numpy(tok), zamba.tcfg, cache=tc)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), err_msg=f"step {step}", **TOL)
        _assert_tree_close(tc, jc)
    assert tc["index"].tolist() == (ragged + 8).tolist()


def test_prefill_step_maker(zamba5):
    z = zamba5
    toks = _toks(np.random.default_rng(2), 2, 5)
    jc, jl = jserve.make_prefill_step(z.jcfg, 16)(z.params, {"tokens": jnp.asarray(toks)})
    tc, tl = tserve.make_prefill_step(z.tcfg, 16, device="cpu")(
        z.tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_tree_close(tc, jc)


def test_reset_slot(zamba5):
    z = zamba5
    toks = _toks(np.random.default_rng(4), 3, 5)
    jc = jmodels.init_cache(z.jcfg, 3, 8, per_slot_index=True)
    tc = tmodels.init_cache(z.tcfg, 3, 8, per_slot_index=True, device="cpu")
    _, jc = z.jstep(z.params, jc, jnp.asarray(toks))
    _, tc, _ = tmodels.forward(z.tparams, torch.from_numpy(toks), z.tcfg, cache=tc)
    jc, tc2 = jreset_slot(jc, 1), tmodels.reset_slot(tc, 1)
    assert tc2 is tc
    _assert_tree_close(tc, jc)
    for path, leaf in tree_items(tc):
        if path == "index":
            assert leaf.tolist() == [5, 0, 5]
            continue
        row = leaf[:, 1] if path.startswith(("blocks", "shared")) else leaf[1]
        other = leaf[:, 0] if path.startswith(("blocks", "shared")) else leaf[0]
        assert float(row.abs().max()) == 0.0 and float(other.abs().max()) > 0.0, path


def test_causality(zamba5):
    z = zamba5
    toks = _toks(np.random.default_rng(5), 1, 24)
    h1, _, _ = tmodels.forward(z.tparams, torch.from_numpy(toks), z.tcfg)
    toks[0, -1] = (toks[0, -1] + 7) % VOCAB
    h2, _, _ = tmodels.forward(z.tparams, torch.from_numpy(toks), z.tcfg)
    np.testing.assert_allclose(h1[:, :-1].numpy(), h2[:, :-1].numpy(), atol=1e-4)
    assert not np.allclose(h1[:, -1].numpy(), h2[:, -1].numpy())


# ---------------------------------------------------------------- serving --
def _requests(mod, n=6, seed=1, max_new=6):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(1, VOCAB, size=int(rng.integers(2, 7))).tolist(),
                        max_new_tokens=max_new) for i in range(n)]


def _engine(z, slots=2, max_len=48, **kw):
    return tserve.ServeEngine(z.tcfg, z.tparams, batch_slots=slots, max_len=max_len,
                              eos_id=-1, device="cpu", **kw)


def _run(engine, requests, max_steps=500):
    for r in requests:
        engine.submit(r)
    engine.run_until_done(max_steps)
    return {r.req_id: list(r.output) for r in requests}


def test_greedy_streams_equal_the_jax_engine(zamba):
    """6 requests through 2 slots: every token of every stream."""
    jeng = jserve.ServeEngine(zamba.jcfg, zamba.params, batch_slots=2, max_len=48, eos_id=-1)
    want = _run(jeng, _requests(jserve))
    teng = _engine(zamba)
    got = _run(teng, _requests(tserve))
    assert got == want and teng.steps == jeng.steps
    assert all(len(v) == 6 for v in got.values())


def test_recurrent_state_reset_on_admit(zamba5):
    """tests/test_model_properties.py's slot hygiene on the port: a request
    served after a longer one in the same slot decodes as if alone."""
    def outputs_for(prompts):
        eng = _engine(zamba5, slots=1, max_len=32)
        return _run(eng, [tserve.Request(i, prompt=p, max_new_tokens=4)
                          for i, p in enumerate(prompts)])

    alone = outputs_for([[9, 8, 7]])
    after = outputs_for([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7]])
    assert alone[0] == after[1]


class TestKvShip:
    def _mk(self, z):
        return _engine(z, slots=2, max_len=64, temperature=0.7, rng_seed=3)

    def test_exported_slot_decodes_bit_identically(self, zamba5):
        """Export a mid-decode slot (KV, conv windows, SSM states, shared
        block caches), import it into another slot of a fresh engine: the
        continuation and the slot's state equal a never-migrated run."""
        z = zamba5
        ref_eng = self._mk(z)
        ref = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
        ref_eng.submit(ref)
        ref_eng.run_until_done(200)

        src = self._mk(z)
        mig = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
        src.submit(mig)
        while len(mig.output) < 4:
            src.step()
        state = src.export_slot(0)
        assert {"blocks", "tail", "shared", "tail_shared"} <= set(state)
        frozen = copy.deepcopy(state)
        src.step()                                    # the payload is a copy
        for a, b in zip(tree_leaves(state), tree_leaves(frozen)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        mig.output = mig.output[:4]
        mig.done = False
        dst = self._mk(z)
        dst.import_slot(1, state)
        dst.slots[1] = mig
        dst.run_until_done(200)
        assert mig.done and mig.output == ref.output
        got, want = dst.export_slot(1), ref_eng.export_slot(0)
        assert got["offset"] == want["offset"] and int(got["index"]) == int(want["index"])
        for key in ("blocks", "tail", "shared", "tail_shared"):
            for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
                assert torch.equal(a, b), key

    def test_import_leaves_the_neighbour_slot(self, zamba5):
        z = zamba5
        src, dst = self._mk(z), self._mk(z)
        src.submit(tserve.Request(1, prompt=[4, 5, 6, 7], max_new_tokens=3))
        dst.submit(tserve.Request(2, prompt=[9, 9], max_new_tokens=9))
        for _ in range(3):
            src.step()
            dst.step()
        keep = dst.export_slot(0)
        dst.import_slot(1, src.export_slot(0))
        for a, b in zip(tree_leaves(dst.export_slot(1)), tree_leaves(src.export_slot(0))):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        for a, b in zip(tree_leaves(dst.export_slot(0)), tree_leaves(keep)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))

    def test_a_reference_payload_continues_in_the_port(self, zamba5):
        """A slot exported by the JAX engine (as numpy) imports into the
        port's engine, which then decodes the reference's greedy tokens."""
        z = zamba5
        jeng = jserve.ServeEngine(z.jcfg, z.params, batch_slots=2, max_len=64, eos_id=-1)
        jreq = jserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
        jeng.submit(jreq)
        while len(jreq.output) < 4:
            jeng.step()
        payload = jax.tree.map(np.asarray, jeng.export_slot(0))
        assert {"shared", "tail_shared"} <= set(payload)
        done_so_far = list(jreq.output)
        jeng.run_until_done(200)

        teng = _engine(z, slots=2, max_len=64)
        treq = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
        treq.output = done_so_far
        teng.import_slot(1, cache_from_jax(payload, "cpu"))
        teng.slots[1] = treq
        teng.run_until_done(200)
        assert treq.output == jreq.output


def test_cache_from_jax_keeps_the_state_fp32():
    jcfg, _ = _configs(5)
    jc = jax.tree.map(np.asarray, jmodels.init_cache(jcfg, 2, 8, per_slot_index=True))
    got = cache_from_jax(jc, "cpu", dtype=torch.bfloat16)
    for path, leaf in tree_items(got):
        if path == "index":
            assert leaf.dtype == torch.int32
        elif path.endswith("state"):
            assert leaf.dtype == torch.float32, path
        else:
            assert leaf.dtype == torch.bfloat16, path


# --------------------------------------------------------------- training --
def _batch(B, S, seed):
    toks = np.random.default_rng(seed).integers(0, VOCAB, size=(B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def test_lm_loss_and_gradients_match_jax(zamba):
    """S = 32: every mixer on the `ssm_scan` route (its autograd Function,
    plain forward on the CPU), every period under block remat."""
    batch = _batch(2, 32, seed=6)
    jloss = lambda p: jmodels.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                      zamba.jcfg, loss_chunk=8)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(zamba.params)
    leaves = []

    def track(t):
        leaves.append(t.clone().requires_grad_(True))
        return leaves[-1]

    live = tree_map(track, zamba.tparams)
    before = tscan.ssm_scan.launches
    tl, _ = tmodels.lm_loss(live, {k: torch.from_numpy(v) for k, v in batch.items()},
                            zamba.tcfg, loss_chunk=8)
    grads = torch.autograd.grad(tl, leaves)
    assert tscan.ssm_scan.launches == before              # no kernel on the CPU
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for (path, g), want in zip(tree_items(list(grads)), jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=path,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())), rtol=1e-4)


def test_one_adamw_step_matches_the_jax_trainer(zamba):
    """One AdamW step of the reference's `Trainer` against the port's, from
    one state carried over by `state_from_jax`, on the same synthetic batch:
    loss, gradient norm and every parameter and moment leaf."""
    tc = dict(steps=1, log_every=100, loss_chunk=8)
    jt = jtrainer.make_synthetic_trainer(zamba.jcfg, jtrainer.TrainerConfig(**tc), 2, 32)
    tt = ttrainer.make_synthetic_trainer(zamba.tcfg, ttrainer.TrainerConfig(**tc), 2, 32,
                                         device="cpu")
    assert zamba.tcfg.optimizer == "adamw"
    jstate, _ = jt.init_or_restore()
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jstate = jt.run(state=jstate)
    tstate = tt.run(state=tstate)
    (jm,), (tm,) = jt.metrics_log, tt.metrics_log
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    assert np.isfinite(tm["grad_norm"])
    got = dict(tree_items(tree_to_numpy(tstate)))
    want = dict(tree_items(jax.tree.map(np.asarray, jstate)))
    assert list(got) == list(want)
    for path in got:
        # parameters: a quarter of the learning rate (see tests/test_torch_train.py)
        tol = dict(atol=2.5e-4, rtol=1e-4) if path.startswith("params") else TOL
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(want[path], np.float64), err_msg=path, **tol)
