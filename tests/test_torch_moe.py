"""The MoE family of the port against the reference, on the CPU: router,
dispatch, aux losses and expert FFNs of `models/moe.py`, then reduced
dbrx-132b and kimi-k2 through `forward`, the serving engine, `lm_loss`
with its gradients and the `Trainer`.  The same weights (made by the
reference, converted) and the same tokens go through both.

Tolerances: the dispatch plan's integers exactly; fp32 values 2e-5
(`tests/test_kernels.py::_tol`), hidden states, caches, logits and
gradients through whole models 1e-4 (the two frameworks sum in other
orders, as `tests/test_torch_transformer.py` holds the dense family), bf16
5e-2, losses 1e-5 relative.  Greedy streams are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import serve as jserve
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.train import trainer as jtrainer
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch._tree import tree_items, tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax, state_from_jax, tree_to_numpy
from repro_torch.models import moe as tmoe
from repro_torch.train import trainer as ttrainer

ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b"]
FP32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=5e-2, rtol=5e-2)
MODEL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(arch="dbrx-132b", **overrides):
    kw = {"vocab_size": 64, **overrides}
    return jmodels.reduced(jget_config(arch), **kw), tmodels.reduced(tget_config(arch), **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moe(jcfg, seed=0, dtype=jnp.float32):
    params = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    return params, params_from_jax(_np(params), "cpu")


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy(), np.float64),
                               np.asarray(jnp.asarray(want, jnp.float32), np.float64), **tol)


def _assert_tree_close(got, want, **tol):
    got, want = dict(tree_items(tree_to_numpy(got))), dict(tree_items(_np(want)))
    assert list(got) == list(want)
    for path in got:
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(want[path], np.float64), err_msg=path, **tol)


# ------------------------------------------------------------------ pieces --
@pytest.mark.parametrize("arch", ARCHS)
def test_router_probs_and_aux_losses(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe(jcfg)
    x = _x((24, jcfg.d_model), 1)
    jl, jprobs, jtop_p, jtop_ids = jmoe.router_probs(jp, jnp.asarray(x), jcfg)
    tl, tprobs, ttop_p, ttop_ids = tmoe.router_probs(tp, torch.from_numpy(x), tcfg)
    _close(tl, jl, **FP32)
    _close(tprobs, jprobs, **FP32)
    _close(ttop_p, jtop_p, **FP32)
    assert ttop_ids.tolist() == np.asarray(jtop_ids).tolist()
    jaux, jm = jmoe.aux_losses(jl, jprobs, jtop_ids, jcfg)
    taux, tm = tmoe.aux_losses(tl, tprobs, ttop_ids, tcfg)
    _close(taux, jaux, **FP32)
    for key in ("moe_balance", "moe_zloss"):
        _close(tm[key], jm[key], **FP32)


def test_capacity_equals_the_reference():
    for arch in ARCHS:
        jcfg, tcfg = jget_config(arch), tget_config(arch)
        for n in (1, 3, 8, 64, 8192):
            assert tmoe.capacity(n, tcfg) == jmoe.capacity(n, jcfg)
    # In decode the call's tokens are the 8 slots: dbrx's experts take 3 each.
    assert tmoe.capacity(8, tget_config("dbrx-132b")) == 3
    assert tmoe.capacity(8, tget_config("kimi-k2-1t-a32b")) == 1


def _plans(ids, p, jcfg, tcfg, cap):
    T = ids.shape[0]
    want = jmoe.build_dispatch(jnp.asarray(ids), jnp.asarray(p), T, jcfg, cap)
    got = tmoe.build_dispatch(torch.from_numpy(ids.copy()), torch.from_numpy(p.copy()), T, tcfg, cap)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_dispatch_is_exact(arch, capacity_factor):
    """Token sources, buffer slots and kept flags equal the reference's
    integers exactly (the stable sort's order among one expert's tokens
    included); the weights are the same floats gathered."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, _ = _moe(jcfg)
    x = _x((40, jcfg.d_model), 2)
    _, _, top_p, top_ids = jmoe.router_probs(jp, jnp.asarray(x), jcfg)
    ids, p = np.asarray(top_ids), np.asarray(top_p)
    cap = jmoe.capacity(40, jcfg)
    want, got = _plans(ids, p, jcfg, tcfg, cap)
    for w, g, name in zip(want, got, ("token_src", "buffer_idx", "keep", "weight")):
        assert g.tolist() == w.tolist(), name
    drops = not want[2].all()
    assert drops == (capacity_factor < 1.0)
    assert (want[1][~want[2]] == jcfg.n_experts * cap).all()         # the dump slot


def test_build_dispatch_with_every_token_on_one_expert():
    """The worst skew: every token's choices on experts 0 and 1; all past
    the capacity go to the dump slot, in token order."""
    jcfg, tcfg = _cfgs("dbrx-132b")
    T = 16
    ids = np.tile(np.array([[0, 1]], np.int32), (T, 1))
    p = np.full((T, 2), 0.5, np.float32)
    cap = jmoe.capacity(T, jcfg)
    want, got = _plans(ids, p, jcfg, tcfg, cap)
    for w, g in zip(want, got):
        assert g.tolist() == w.tolist()
    assert int(want[2].sum()) == 2 * cap


@pytest.mark.parametrize("ffn_type", ["swiglu", "gelu", "relu2"])
def test_expert_ffn(ffn_type):
    jcfg, tcfg = _cfgs("dbrx-132b", ffn_type=ffn_type)
    jp, tp = _moe(jcfg)
    assert sorted(tp["experts"]) == sorted(jp["experts"])
    buf = _x((jcfg.n_experts, 6, jcfg.d_model), 3)
    want = jmoe.expert_ffn(jp["experts"], jnp.asarray(buf), jcfg)
    got = tmoe.expert_ffn(tp["experts"], torch.from_numpy(buf), tcfg)
    assert got.shape == want.shape
    _close(got, want, **FP32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn(arch, bf16):
    """Output, aux loss and drop fraction, at the default capacity (some
    assignments drop) in fp32 and in bf16."""
    dt = "bfloat16" if bf16 else "float32"
    jcfg, tcfg = _cfgs(arch, compute_dtype=dt, param_dtype=dt)
    jp, tp = _moe(jcfg, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    x = _x((2, 20, jcfg.d_model), 4)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    jout, jaux, jm = jmoe.moe_ffn(jp, jx, jcfg)
    tout, taux, tm = tmoe.moe_ffn(tp, tx, tcfg)
    assert tout.shape == tx.shape and tout.dtype == tx.dtype
    _close(tout, jout, **(BF16 if bf16 else FP32))
    _close(taux, jaux, **(BF16 if bf16 else FP32))
    assert float(tm["moe_drop_frac"]) == pytest.approx(float(jm["moe_drop_frac"]))


@pytest.mark.parametrize("top_k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_equals_the_dense_oracle_when_nothing_drops(arch, top_k):
    """With a capacity nothing exceeds, the dispatch path equals every
    expert run on every token.  The reference's oracle builds its (T, E)
    weights as (T, top_k) and so runs only where top_k == n_experts: it is
    compared there, and raises below it (ROADMAP Queue 3)."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=8.0, top_k=top_k)
    jp, tp = _moe(jcfg)
    x = torch.from_numpy(_x((2, 12, jcfg.d_model), 5))
    out, _, metrics = tmoe.moe_ffn(tp, x, tcfg)
    assert float(metrics["moe_drop_frac"]) == 0.0
    oracle = tmoe.moe_ffn_dense_oracle(tp, x, tcfg)
    torch.testing.assert_close(out, oracle, **FP32)
    if top_k == tcfg.n_experts:
        _close(oracle, jmoe.moe_ffn_dense_oracle(jp, jnp.asarray(x.numpy()), jcfg), **FP32)
    else:
        with pytest.raises(ValueError):
            jmoe.moe_ffn_dense_oracle(jp, jnp.asarray(x.numpy()), jcfg)


def test_moe_ffn_gradients_match_jax():
    jcfg, tcfg = _cfgs("dbrx-132b")
    jp, tp = _moe(jcfg)
    x = _x((2, 10, jcfg.d_model), 6)
    w = _x((2, 10, jcfg.d_model), 7)

    def jloss(p, xx):
        out, aux, _ = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(out * w) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux, _ = tmoe.moe_ffn(live, tx, tcfg)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    _close(tx.grad, jgx, **MODEL)
    for (path, t), g in zip(tree_items(live), jax.tree.leaves(jgp)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), err_msg=path, **MODEL)


# ------------------------------------------------------------------ models --
def _models(arch, seed=0, **overrides):
    jcfg, tcfg = _cfgs(arch, **overrides)
    params = jmodels.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params, params_from_jax(_np(params), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_equal_the_reference(arch):
    jcfg, tcfg, params, tparams = _models(arch)
    own = tmodels.init_lm(torch.Generator("cpu").manual_seed(0), tcfg)
    want = [p for p, _ in tree_items(tparams)]
    assert [p for p, _ in tree_items(own)] == want
    assert "blocks.pos0.moe.experts.w_gate.w" in want and "blocks.pos0.moe.router.w" in want
    for (path, a), b in zip(tree_items(own), jax.tree.leaves(params)):
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}", path
    jc = jmodels.init_cache(jcfg, 3, 16, per_slot_index=True)
    tc = tmodels.init_cache(tcfg, 3, 16, per_slot_index=True, device="cpu")
    assert [p for p, _ in tree_items(tc)] == [p for p, _ in tree_items(_np(jc))]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_sequence_hidden_logits_and_aux(arch):
    jcfg, tcfg, params, tparams = _models(arch)
    toks = np.random.default_rng(0).integers(0, 64, size=(2, 12)).astype(np.int32)
    jh, _, jaux = jmodels.forward(params, jnp.asarray(toks), jcfg)
    th, _, taux = tmodels.forward(tparams, torch.from_numpy(toks), tcfg)
    _close(th, jh, **MODEL)
    _close(taux, jaux, **MODEL)
    assert float(taux) > 0                      # summed over the MoE layers
    _close(tmodels.logits_fn(tparams, th, tcfg), jmodels.logits_fn(params, jh, jcfg), **MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_eight_decode_steps_per_slot(arch):
    """Prefill 3 rows into the cache, give each row its own index, then
    decode 8 steps: hidden, logits and every cache leaf at every step."""
    jcfg, tcfg, params, tparams = _models(arch)
    rng = np.random.default_rng(1)
    B, S, L = 3, 6, 24
    toks = rng.integers(0, 64, size=(B, S)).astype(np.int32)
    jc = jmodels.init_cache(jcfg, B, L, per_slot_index=True)
    tc = tmodels.init_cache(tcfg, B, L, per_slot_index=True, device="cpu")
    jh, jc, _ = jmodels.forward(params, jnp.asarray(toks), jcfg, cache=jc)
    th, tc, _ = tmodels.forward(tparams, torch.from_numpy(toks), tcfg, cache=tc)
    _close(th, jh, **MODEL)
    _assert_tree_close(tc, jc, **MODEL)
    ragged = np.array([6, 2, 4], np.int32)
    jc = dict(jc, index=jnp.asarray(ragged))
    tc = dict(tc, index=torch.from_numpy(ragged.copy()))
    jstep = jax.jit(lambda p, c, t: jmodels.forward(p, t, jcfg, cache=c)[:2])
    for step in range(8):
        tok = rng.integers(0, 64, size=(B, 1)).astype(np.int32)
        jh, jc = jstep(params, jc, jnp.asarray(tok))
        th, tc, _ = tmodels.forward(tparams, torch.from_numpy(tok), tcfg, cache=tc)
        _close(th, jh, err_msg=f"step {step}", **MODEL)
        _close(tmodels.logits_fn(tparams, th, tcfg), jmodels.logits_fn(params, jh, jcfg),
               **MODEL)
        _assert_tree_close(tc, jc, **MODEL)
    assert tc["index"].tolist() == (ragged + 8).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_slot_depends_on_its_neighbours_as_in_the_reference(arch):
    """In decode a call's tokens are the batch's slots, so an expert's
    capacity is shared by the slots: with every slot on the last slot's
    token, every slot chooses its experts, and the last slot's assignments
    (last in the stable sort) are dropped; with other tokens beside it, they
    are not.  Both packages give the last slot the same hidden state in both
    batches, and it differs between the batches."""
    jcfg, tcfg, params, tparams = _models(arch)
    B, last = 8, np.int32(5)
    assert tmoe.capacity(B, tcfg) < B
    batches = {"same token": np.full((B, 1), last, np.int32),
               "other tokens": np.concatenate(
                   [np.random.default_rng(2).integers(0, 64, size=(B - 1, 1)),
                    [[last]]]).astype(np.int32)}
    seen = {}
    for name, toks in batches.items():
        jc = jmodels.init_cache(jcfg, B, 8, per_slot_index=True)
        tc = tmodels.init_cache(tcfg, B, 8, per_slot_index=True, device="cpu")
        jh, _, _ = jmodels.forward(params, jnp.asarray(toks), jcfg, cache=jc)
        th, _, _ = tmodels.forward(tparams, torch.from_numpy(toks), tcfg, cache=tc)
        _close(th, jh, **MODEL)
        seen[name] = (th[-1].numpy(), np.asarray(jh[-1]))
    (t_same, j_same), (t_other, j_other) = seen["same token"], seen["other tokens"]
    assert np.abs(j_same - j_other).max() > 1e-2
    assert np.abs(t_same - t_other).max() > 1e-2


def _requests(mod, n=6, seed=1, max_new=6):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(1, 64, size=int(rng.integers(2, 7))).tolist(),
                        max_new_tokens=max_new) for i in range(n)]


def _run(engine, requests, max_steps=500):
    for r in requests:
        engine.submit(r)
    engine.run_until_done(max_steps)
    return {r.req_id: list(r.output) for r in requests}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_the_jax_engine(arch):
    """6 requests through 3 slots: every token of every stream."""
    jcfg, tcfg, params, tparams = _models(arch)
    jeng = jserve.ServeEngine(jcfg, params, batch_slots=3, max_len=48, eos_id=-1)
    want = _run(jeng, _requests(jserve))
    teng = tserve.ServeEngine(tcfg, tparams, batch_slots=3, max_len=48, eos_id=-1,
                              device="cpu")
    got = _run(teng, _requests(tserve))
    assert got == want and teng.steps == jeng.steps
    assert all(len(v) == 6 for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_exported_slot_continues_bit_identically_beside_the_same_neighbours(arch):
    """A slot moved into an engine whose other slot holds the same request at
    the same index decodes on as the source would have, bit for bit."""
    _, tcfg, _, tparams = _models(arch)
    mk = lambda: tserve.ServeEngine(tcfg, tparams, batch_slots=2, max_len=48, eos_id=-1,
                                    device="cpu")
    reqs = lambda: [tserve.Request(0, [3, 4, 5, 6], max_new_tokens=10),
                    tserve.Request(1, [7, 8, 9], max_new_tokens=10)]
    ref = mk()
    want = _run(ref, reqs())
    src, moved = mk(), reqs()
    for r in moved:
        src.submit(r)
    for _ in range(7):
        src.step()
    dst = mk()
    for slot in (0, 1):
        dst.import_slot(slot, src.export_slot(slot))
        dst.slots[slot] = moved[slot]
    dst.run_until_done(100)
    assert {r.req_id: r.output for r in moved} == want


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax(arch):
    """S = 16, every MoE layer under block remat: the loss (aux included)
    and every leaf's gradient, the router's too."""
    jcfg, tcfg, params, tparams = _models(arch)
    toks = np.random.default_rng(3).integers(0, 64, size=(2, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    jloss = lambda p: jmodels.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jcfg, loss_chunk=8)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    live = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    items = list(tree_items(live))
    tl, metrics = tmodels.lm_loss(live, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  tcfg, loss_chunk=8)
    assert float(metrics["aux"].detach()) > 0
    grads = torch.autograd.grad(tl, [t for _, t in items])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for (path, _), g, want in zip(items, grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=path,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_trainer_steps_match_the_jax_trainer(arch):
    """Three Adafactor steps (the configs' optimizer) of the reference's
    `Trainer` and the port's from one converted state: losses, and every
    parameter and statistic after them."""
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.optimizer == "adafactor"
    tc = dict(steps=3, log_every=100, loss_chunk=8)
    jt = jtrainer.make_synthetic_trainer(jcfg, jtrainer.TrainerConfig(**tc), 2, 16)
    tt = ttrainer.make_synthetic_trainer(tcfg, ttrainer.TrainerConfig(**tc), 2, 16,
                                         device="cpu")
    jstate, _ = jt.init_or_restore()
    tstate = state_from_jax(_np(jstate), "cpu")
    jstate = jt.run(state=jstate)
    tstate = tt.run(state=tstate)
    assert [r["step"] for r in tt.metrics_log] == [0, 1, 2]
    for got, want in zip(tt.metrics_log, jt.metrics_log):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    got, want = dict(tree_items(tree_to_numpy(tstate))), dict(tree_items(_np(jstate)))
    assert list(got) == list(want)
    for path in got:
        # parameters: a quarter of the learning rate (see tests/test_torch_train.py)
        tol = dict(atol=2.5e-4, rtol=1e-4) if path.startswith("params") else MODEL
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(want[path], np.float64), err_msg=path, **tol)
