"""The xLSTM stack of the port (xlstm-1.3b, cut by `reduced`) against the
reference, on the CPU: the mixers' functions one by one (block-diagonal
projection, the mLSTM recurrence and chunked form, the sLSTM step, both
blocks with and without a cache), the parameter and cache trees, forward
and logits, prefill and decode with the cache leaf for leaf, causality and
slot hygiene, the serving engine's streams and slot migration, and the
training loss, gradients and three `Trainer` steps.  Weights come from the
reference's `init_lm` (converted without ``dtype``, which would round the
fp32 gate leaves of a bf16 model); inputs are drawn with numpy.

Two cuts: 2 blocks (`reduced`: one mLSTM, one sLSTM, no stacked period
longer than one) and 9 blocks (one stacked period of 7 mLSTM and 1 sLSTM,
and one mLSTM tail block).  Tolerance: fp32 2e-5 (tests/test_kernels.py's
``_tol``) for the mixers' functions; whatever goes through the stack
(hidden states, logits, cache leaves, loss, gradients) 2e-5 of the
tensor's largest magnitude plus 2e-5 of each element, because an
elementwise 2e-5 cannot hold between two fp32 stacks that add in other
orders: on the 9-block cut the reference's own fp32 forward lies 8.9e-5
from a float64 evaluation (the port's 8.6e-5; outputs up to 4.6;
tests/xlstm_fp32_spread.py).
Greedy streams must be EQUAL.
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
from repro.models import xlstm as jx
from repro.models.transformer import reset_slot as jreset_slot
from repro.train import trainer as jtrainer
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch._tree import tree_items, tree_leaves, tree_map
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax, state_from_jax, tree_to_numpy
from repro_torch.kernels import rmsnorm as trmsnorm
from repro_torch.models import xlstm as tx
from repro_torch.train import trainer as ttrainer

TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB = 64
FULL_PATTERN = tget_config("xlstm-1.3b").block_pattern


def _configs(n_layers=2, **overrides):
    if n_layers != 2:
        overrides = dict(overrides, n_layers=n_layers, block_pattern=FULL_PATTERN[:n_layers])
    jcfg = jmodels.reduced(jget_config("xlstm-1.3b"), vocab_size=VOCAB, **overrides)
    tcfg = tmodels.reduced(tget_config("xlstm-1.3b"), vocab_size=VOCAB, **overrides)
    return jcfg, tcfg


class XLSTM:
    """A reduced xLSTM in both packages, with the reference's compiled
    functions shared by the tests of a module."""

    def __init__(self, n_layers, **overrides):
        self.n_layers = n_layers
        self.jcfg, self.tcfg = _configs(n_layers, **overrides)
        self.params = jmodels.init_lm(jax.random.PRNGKey(0), self.jcfg)
        self.tparams = params_from_jax(jax.tree.map(np.asarray, self.params), "cpu")
        cfg = self.jcfg
        self.jforward = jax.jit(lambda p, t: jmodels.forward(p, t, cfg)[0])
        self.jstep = jax.jit(lambda p, c, t: jmodels.forward(p, t, cfg, cache=c)[:2])


@pytest.fixture(scope="module", params=[2, 9], ids=["2-blocks", "9-blocks"])
def xl(request):
    return XLSTM(request.param, mlstm_chunk=8)


@pytest.fixture(scope="module")
def xl2():
    return XLSTM(2)


def _np(t):
    return np.asarray(tree_to_numpy(t))


def _scaled(want):
    """2e-5 of ``want``'s largest magnitude plus 2e-5 of each element."""
    return dict(atol=2e-5 * max(1.0, float(np.abs(np.asarray(want, np.float32)).max())),
                rtol=2e-5)


def _close(got, want, err_msg="", stack=False):
    """Elementwise `TOL`; ``stack``: the `_scaled` tolerance."""
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), err_msg=err_msg,
                               **(_scaled(want) if stack else TOL))


def _assert_tree_close(got, want):
    got = dict(tree_items(tree_to_numpy(got)))
    want = dict(tree_items(jax.tree.map(np.asarray, want)))
    assert list(got) == list(want)
    for path in got:
        _close(got[path], want[path], path, stack=True)


def _toks(rng, *shape):
    return rng.integers(0, VOCAB, size=shape).astype(np.int32)


def _jax_paths(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in leaves]


def _draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ----------------------------------------------------------- the mixers --
def test_apply_blockdiag():
    rng = np.random.default_rng(0)
    w, x = _draw(rng, 16, 4, 4), _draw(rng, 2, 5, 64)
    want = jx.apply_blockdiag({"w": jnp.asarray(w)}, jnp.asarray(x), jnp.float32)
    got = tx.apply_blockdiag({"w": torch.from_numpy(w)}, torch.from_numpy(x), torch.float32)
    assert got.shape == (2, 5, 64)
    _close(got, want)


def _mlstm_inputs(rng, B=2, S=24, H=2, P=8, with_init=False):
    q, k, v = (_draw(rng, B, S, H, P) for _ in range(3))
    ig, fg = _draw(rng, B, S, H), _draw(rng, B, S, H, scale=2.0) + 1.0
    init = None
    if with_init:
        init = (_draw(rng, B, H, P, P), _draw(rng, B, H, P), _draw(rng, B, H, scale=0.5))
    return (q, k, v, ig, fg), init


def _both(arrays, init):
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    ji = None if init is None else tuple(jnp.asarray(a) for a in init)
    ti = None if init is None else tuple(torch.from_numpy(a) for a in init)
    return j, ji, t, ti


def _assert_scan_close(got, want):
    (h, final), (jh, jfinal) = got, want
    _close(h, jh, "h")
    for name, a, b in zip("Cnm", final, jfinal):
        _close(a, b, name)


@pytest.mark.parametrize("with_init", [False, True], ids=["from-zero", "from-a-state"])
def test_mlstm_recurrence(with_init):
    arrays, init = _mlstm_inputs(np.random.default_rng(1), with_init=with_init)
    j, ji, t, ti = _both(arrays, init)
    _assert_scan_close(tx.mlstm_recurrence(*t, init=ti), jx.mlstm_recurrence(*j, init=ji))


@pytest.mark.parametrize("with_init", [False, True], ids=["from-zero", "from-a-state"])
def test_mlstm_chunked(with_init):
    """Three chunks of 8: the state carried across two chunk boundaries."""
    arrays, init = _mlstm_inputs(np.random.default_rng(2), with_init=with_init)
    j, ji, t, ti = _both(arrays, init)
    want = jax.jit(jx.mlstm_chunked, static_argnums=5)(*j, 8, ji)
    _assert_scan_close(tx.mlstm_chunked(*t, 8, init=ti), want)
    with pytest.raises(ValueError):
        tx.mlstm_chunked(*t, 7)


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_mlstm_chunked_equals_the_recurrence(chunk):
    arrays, init = _mlstm_inputs(np.random.default_rng(3), with_init=True)
    _, _, t, ti = _both(arrays, init)
    h, final = tx.mlstm_chunked(*t, chunk, init=ti)
    rh, rfinal = tx.mlstm_recurrence(*t, init=ti)
    torch.testing.assert_close(h, rh, **TOL)
    for a, b in zip(final, rfinal):
        torch.testing.assert_close(a, b, **TOL)


def test_slstm_step():
    rng = np.random.default_rng(4)
    B, H, P = 3, 2, 8
    r = _draw(rng, 4, H, P, P, scale=P ** -0.5)
    carry = (_draw(rng, B, H, P), np.abs(_draw(rng, B, H, P)) + 0.5, _draw(rng, B, H, P),
             _draw(rng, B, H, P, scale=0.5))
    gx = _draw(rng, B, 4, H, P)
    jcarry, jh = jx.make_slstm_step(jnp.asarray(r))(tuple(map(jnp.asarray, carry)),
                                                      jnp.asarray(gx))
    tcarry, th = tx.make_slstm_step(torch.from_numpy(r))(tuple(map(torch.from_numpy, carry)),
                                                         torch.from_numpy(gx))
    _close(th, jh)
    for name, a, b in zip("cnhm", tcarry, jcarry):
        _close(a, b, name)


def _random_cache(rng, init_cache, cfg, batch):
    """The block's cache with every leaf drawn (m small, n positive)."""
    out = {}
    for key, leaf in init_cache(cfg, batch).items():
        a = _draw(rng, *leaf.shape, scale=0.5)
        out[key] = np.abs(a) + 0.5 if key == "n" else a
    return out


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S,cached", [(16, False), (12, False), (16, True), (1, True)],
                         ids=["chunked", "recurrence", "chunked-from-cache", "one-step"])
def test_mixer_block(kind, S, cached):
    """A block's output and new cache from converted weights; mLSTM's
    chunk is 8, so S 16 takes the chunked form and 12 and 1 the
    recurrence.  The cached block writes the port's cache in place."""
    jcfg, tcfg = _configs(mlstm_chunk=8)
    init, block = {"mlstm": (jx.init_mlstm, jx.mlstm_block),
                   "slstm": (jx.init_slstm, jx.slstm_block)}[kind]
    jp = init(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(6)
    x = _draw(rng, 2, S, jcfg.d_model)
    jcache = tcache = None
    if cached:
        cache_init = {"mlstm": jx.init_mlstm_cache, "slstm": jx.init_slstm_cache}[kind]
        drawn = _random_cache(rng, cache_init, jcfg, 2)
        jcache = {k: jnp.asarray(v) for k, v in drawn.items()}
        tcache = {k: torch.from_numpy(v.copy()) for k, v in drawn.items()}
    jout, jnew = block(jp, jnp.asarray(x), jcfg, jcache)
    tblock = {"mlstm": tx.mlstm_block, "slstm": tx.slstm_block}[kind]
    tout, tnew = tblock(tp, torch.from_numpy(x), tcfg, tcache)
    _close(tout, jout)
    if not cached:
        assert tnew is None
        return
    assert tnew is tcache and list(tnew) == list(jnew)
    for key in jnew:
        _close(tnew[key], jnew[key], key)


# ------------------------------------------------------------------ trees --
def test_layout_of_the_cuts(xl):
    layout = tmodels.stack_layout(xl.tcfg)
    if xl.n_layers == 2:
        assert (layout.period, layout.n_full, layout.tail) == (2, 1, ())
    else:
        assert (layout.period, layout.n_full, layout.tail) == (8, 1, ("mlstm",))
        assert layout.period_kinds == ("mlstm",) * 7 + ("slstm",)
    full = tmodels.stack_layout(tget_config("xlstm-1.3b"))
    assert (full.period, full.n_full, full.tail) == (8, 6, ())


def test_param_and_cache_trees_equal_the_reference(xl):
    own = tmodels.init_lm(torch.Generator("cpu").manual_seed(0), xl.tcfg)
    want = _jax_paths(xl.params)
    assert [p for p, _ in tree_items(own)] == want
    assert [p for p, _ in tree_items(xl.tparams)] == want
    for (path, a), b in zip(tree_items(own), jax.tree.leaves(xl.params)):
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}", path
    for overrides in ({}, {"compute_dtype": "bfloat16", "param_dtype": "bfloat16"}):
        jcfg, tcfg = _configs(xl.n_layers, **overrides)
        jp = jax.eval_shape(lambda: jmodels.init_lm(jax.random.PRNGKey(0), jcfg))
        tp = tmodels.init_lm(torch.Generator("cpu").manual_seed(0), tcfg, device="meta")
        for (path, a), b in zip(tree_items(tp), jax.tree.leaves(jp)):
            assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}", path
        jc = jmodels.init_cache(jcfg, 3, 16, per_slot_index=True)
        tc = tmodels.init_cache(tcfg, 3, 16, per_slot_index=True, device="cpu")
        assert [p for p, _ in tree_items(tc)] == _jax_paths(jc)
        for (path, a), b in zip(tree_items(tc), jax.tree.leaves(jc)):
            assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}", path
    fp32 = [p for p, t in tree_items(tp) if t.dtype == torch.float32]
    assert all(p.endswith(("w_gates.w", "r_gates")) for p in fp32) and fp32


def test_full_size_trees():
    """xlstm-1.3b: 6 stacked periods of 7 mLSTM and 1 sLSTM, leaf for leaf
    the reference's; about 1.4e9 parameters (tests/test_arch_smoke.py holds
    the reference to 1.0-1.8e9); C is (B, H, 1024, 1024) fp32, 16.8 MB a
    slot a layer."""
    cfg = tget_config("xlstm-1.3b")
    assert tx._head_dims(cfg) == (4096, 1024) and tx._slstm_dims(cfg) == (2048, 512)
    assert cfg.d_head == 512                        # not the mLSTM head width
    params = tmodels.init_lm(torch.Generator("cpu").manual_seed(0), cfg, device="meta")
    want = jax.eval_shape(lambda: jmodels.init_lm(jax.random.PRNGKey(0),
                                                  jget_config("xlstm-1.3b")))
    assert [p for p, _ in tree_items(params)] == _jax_paths(want)
    for (path, a), b in zip(tree_items(params), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}", path
    n = sum(t.numel() for t in tree_leaves(params))
    assert 1.0e9 < n < 1.8e9
    assert params["blocks"]["pos7"]["mixer"]["r_gates"].shape == (6, 4, 4, 512, 512)
    c = tmodels.init_cache(cfg, 8, 4, device="meta")
    C = c["blocks"]["pos0"]["mixer"]["C"]
    assert C.shape == (6, 8, 4, 1024, 1024) and C.dtype == torch.float32
    assert C[0, 0].numel() * 4 == 16_777_216
    assert set(c["blocks"]["pos7"]["mixer"]) == {"conv", "c", "n", "h", "m"}


def test_cache_from_jax_keeps_the_states_fp32():
    jcfg, _ = _configs(9, compute_dtype="bfloat16")
    jc = jax.tree.map(np.asarray, jmodels.init_cache(jcfg, 2, 8, per_slot_index=True))
    got = cache_from_jax(jc, "cpu", dtype=torch.bfloat16)
    for path, leaf in tree_items(got):
        want = torch.bfloat16 if path.endswith("conv") else (
            torch.int32 if path == "index" else torch.float32)
        assert leaf.dtype == want, path


# ---------------------------------------------------------------- forward --
@pytest.mark.parametrize("S", [32, 12], ids=["chunked", "recurrence"])
def test_forward_hidden_states_and_logits(xl, S):
    toks = _toks(np.random.default_rng(S), 2, S)
    want = xl.jforward(xl.params, jnp.asarray(toks))
    got, cache, aux = tmodels.forward(xl.tparams, torch.from_numpy(toks), xl.tcfg)
    assert cache is None and float(aux) == 0.0
    _close(got, want, stack=True)
    _close(tmodels.logits_fn(xl.tparams, got, xl.tcfg),
           jmodels.logits_fn(xl.params, want, xl.jcfg), stack=True)
    assert xl.tcfg.tie_embeddings and "unembed" not in xl.tparams


def test_prefill_then_eight_decode_steps(xl):
    """Prefill 3 rows into the cache (the chunked form from the zero
    state), give each row its own index, then decode 8 steps (the
    recurrence): hidden states, logits and every cache leaf at every step."""
    rng = np.random.default_rng(1)
    B, S, L = 3, 16, 32
    toks = _toks(rng, B, S)
    jc = jmodels.init_cache(xl.jcfg, B, L, per_slot_index=True)
    tc = tmodels.init_cache(xl.tcfg, B, L, per_slot_index=True, device="cpu")
    jh, jc = xl.jstep(xl.params, jc, jnp.asarray(toks))
    th, tc, _ = tmodels.forward(xl.tparams, torch.from_numpy(toks), xl.tcfg, cache=tc)
    _close(th, jh, stack=True)
    _assert_tree_close(tc, jc)
    ragged = np.array([16, 5, 9], np.int32)
    jc = dict(jc, index=jnp.asarray(ragged))
    tc = dict(tc, index=torch.from_numpy(ragged.copy()))
    for step in range(8):
        tok = _toks(rng, B, 1)
        jh, jc = xl.jstep(xl.params, jc, jnp.asarray(tok))
        th, tc, _ = tmodels.forward(xl.tparams, torch.from_numpy(tok), xl.tcfg, cache=tc)
        _close(th, jh, f"step {step}", stack=True)
        _close(tmodels.logits_fn(xl.tparams, th, xl.tcfg),
               jmodels.logits_fn(xl.params, jh, xl.jcfg), f"logits, step {step}", stack=True)
        _assert_tree_close(tc, jc)
    assert tc["index"].tolist() == (ragged + 8).tolist()


def test_prefill_step_maker(xl2):
    toks = _toks(np.random.default_rng(2), 2, 5)
    jc, jl = jserve.make_prefill_step(xl2.jcfg, 16)(xl2.params, {"tokens": jnp.asarray(toks)})
    tc, tl = tserve.make_prefill_step(xl2.tcfg, 16, device="cpu")(
        xl2.tparams, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, stack=True)
    _assert_tree_close(tc, jc)


def test_reset_slot_zeroes_the_states(xl):
    """Every mixer state of slot 1 (axis 1 of a stacked leaf, axis 0 of a
    tail leaf) is zeroed, as the reference's `reset_slot` does; slot 0 is
    not."""
    toks = _toks(np.random.default_rng(4), 3, 5)
    jc = jmodels.init_cache(xl.jcfg, 3, 8, per_slot_index=True)
    tc = tmodels.init_cache(xl.tcfg, 3, 8, per_slot_index=True, device="cpu")
    _, jc = xl.jstep(xl.params, jc, jnp.asarray(toks))
    _, tc, _ = tmodels.forward(xl.tparams, torch.from_numpy(toks), xl.tcfg, cache=tc)
    jc, tc2 = jreset_slot(jc, 1), tmodels.reset_slot(tc, 1)
    assert tc2 is tc
    _assert_tree_close(tc, jc)
    for path, leaf in tree_items(tc):
        if path == "index":
            assert leaf.tolist() == [5, 0, 5]
            continue
        row = leaf[:, 1] if path.startswith("blocks") else leaf[1]
        other = leaf[:, 0] if path.startswith("blocks") else leaf[0]
        assert float(row.abs().max()) == 0.0 and float(other.abs().max()) > 0.0, path


def test_causality(xl2):
    """tests/test_model_properties.py::TestCausality for xlstm on the port."""
    toks = _toks(np.random.default_rng(5), 1, 24)
    h1, _, _ = tmodels.forward(xl2.tparams, torch.from_numpy(toks), xl2.tcfg)
    toks[0, -1] = (toks[0, -1] + 7) % VOCAB
    h2, _, _ = tmodels.forward(xl2.tparams, torch.from_numpy(toks), xl2.tcfg)
    np.testing.assert_allclose(h1[:, :-1].numpy(), h2[:, :-1].numpy(), atol=1e-4)
    assert not np.allclose(h1[:, -1].numpy(), h2[:, -1].numpy())


# ---------------------------------------------------------------- serving --
def _requests(mod, n=6, seed=1, max_new=6):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(1, VOCAB, size=int(rng.integers(2, 7))).tolist(),
                        max_new_tokens=max_new) for i in range(n)]


def _engine(x, slots=2, max_len=48, **kw):
    return tserve.ServeEngine(x.tcfg, x.tparams, batch_slots=slots, max_len=max_len,
                              eos_id=-1, device="cpu", **kw)


def _run(engine, requests, max_steps=500):
    for r in requests:
        engine.submit(r)
    engine.run_until_done(max_steps)
    return {r.req_id: list(r.output) for r in requests}


def test_greedy_streams_equal_the_jax_engine(xl):
    """6 requests through 2 slots: every token of every stream."""
    jeng = jserve.ServeEngine(xl.jcfg, xl.params, batch_slots=2, max_len=48, eos_id=-1)
    want = _run(jeng, _requests(jserve))
    teng = _engine(xl)
    got = _run(teng, _requests(tserve))
    assert got == want and teng.steps == jeng.steps
    assert all(len(v) == 6 for v in got.values())


def test_recurrent_state_reset_on_admit(xl2):
    """tests/test_model_properties.py::TestSlotHygiene for xlstm on the
    port: a request served after a longer one in the same slot decodes as
    if alone."""
    def outputs_for(prompts):
        eng = _engine(xl2, slots=1, max_len=32)
        return _run(eng, [tserve.Request(i, prompt=p, max_new_tokens=4)
                          for i, p in enumerate(prompts)])

    alone = outputs_for([[9, 8, 7]])
    after = outputs_for([[1, 2, 3, 4, 5, 6, 7, 8], [9, 8, 7]])
    assert alone[0] == after[1]


def test_exported_slot_decodes_bit_identically(xl):
    """Export a mid-decode slot (conv windows, C, n, m, and sLSTM's c, n, h,
    m), import it into another slot of a fresh engine: the continuation and
    the slot's state equal a never-migrated run, bit for bit."""
    mk = lambda: _engine(xl, slots=2, max_len=64, temperature=0.7, rng_seed=3)
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
    paths = [p for p, _ in tree_items(state)]
    for leaf in ("mixer.C", "mixer.n", "mixer.m", "pos7.mixer.c", "pos7.mixer.h"):
        assert any(leaf in p for p in paths) or xl.n_layers == 2, leaf
    frozen = copy.deepcopy(state)
    src.step()                                    # the payload is a copy
    for a, b in zip(tree_leaves(state), tree_leaves(frozen)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    mig.output = mig.output[:4]
    mig.done = False
    dst = mk()
    dst.import_slot(1, state)
    dst.slots[1] = mig
    dst.run_until_done(200)
    assert mig.done and mig.output == ref.output
    got, want = dst.export_slot(1), ref_eng.export_slot(0)
    assert got["offset"] == want["offset"] and int(got["index"]) == int(want["index"])
    for key in ("blocks", "tail"):
        for a, b in zip(tree_leaves(got[key]), tree_leaves(want[key])):
            assert torch.equal(a, b), key


def test_a_reference_payload_continues_in_the_port(xl2):
    """A slot exported by the JAX engine (as numpy) imports into the port's
    engine, which then decodes the reference's greedy tokens."""
    jeng = jserve.ServeEngine(xl2.jcfg, xl2.params, batch_slots=2, max_len=64, eos_id=-1)
    jreq = jserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
    jeng.submit(jreq)
    while len(jreq.output) < 4:
        jeng.step()
    payload = jax.tree.map(np.asarray, jeng.export_slot(0))
    done_so_far = list(jreq.output)
    jeng.run_until_done(200)

    teng = _engine(xl2, slots=2, max_len=64)
    treq = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
    treq.output = done_so_far
    teng.import_slot(1, cache_from_jax(payload, "cpu"))
    teng.slots[1] = treq
    teng.run_until_done(200)
    assert treq.output == jreq.output


# --------------------------------------------------------------- training --
def _batch(B, S, seed):
    toks = np.random.default_rng(seed).integers(0, VOCAB, size=(B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def test_lm_loss_and_gradients_match_jax(xl):
    """S = 32: every mLSTM block in the chunked form (4 chunks of 8), every
    period under block remat; both mixer norms through `rms_norm`'s
    hand-written gradient (its plain forward on the CPU)."""
    batch = _batch(2, 32, seed=6)
    jloss = lambda p: jmodels.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                      xl.jcfg, loss_chunk=8)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(xl.params)
    leaves = []

    def track(t):
        leaves.append(t.clone().requires_grad_(True))
        return leaves[-1]

    live = tree_map(track, xl.tparams)
    before = trmsnorm.rms_norm.launches
    tl, _ = tmodels.lm_loss(live, {k: torch.from_numpy(v) for k, v in batch.items()},
                            xl.tcfg, loss_chunk=8)
    grads = torch.autograd.grad(tl, leaves)
    assert trmsnorm.rms_norm.launches == before             # no kernel on the CPU
    _close(tl.detach(), jl, stack=True)
    # On the 9-block cut no elementwise 2e-5 can hold: the reference's own
    # fp32 gradients lie up to 4.1 times that from a float64 evaluation (the
    # port's 2.2 times; tests/xlstm_fp32_spread.py), so they are held at
    # tests/test_torch_train.py's 1e-4.
    tol = 2e-5 if xl.n_layers == 2 else 1e-4
    for (path, g), want in zip(tree_items(list(grads)), jax.tree.leaves(jg)):
        assert bool(torch.isfinite(g).all()), path
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=path,
                                   atol=tol * max(1.0, float(np.abs(want).max())), rtol=tol)


def test_three_trainer_steps_match_the_jax_trainer(xl2):
    """Three AdamW steps of the reference's `Trainer` against the port's,
    from one state carried over by `state_from_jax`, on the same synthetic
    batches: each step's loss, and every parameter and moment leaf."""
    tc = dict(steps=3, log_every=100, loss_chunk=8)
    jcfg, tcfg = _configs(mlstm_chunk=8)
    jt = jtrainer.make_synthetic_trainer(jcfg, jtrainer.TrainerConfig(**tc), 2, 32)
    tt = ttrainer.make_synthetic_trainer(tcfg, ttrainer.TrainerConfig(**tc), 2, 32,
                                         device="cpu")
    assert tcfg.optimizer == "adamw"
    jstate, _ = jt.init_or_restore()
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jstate = jt.run(state=jstate)
    tstate = tt.run(state=tstate)
    assert [r["step"] for r in tt.metrics_log] == [0, 1, 2]
    for got, want in zip(tt.metrics_log, jt.metrics_log):
        _close(got["loss"], want["loss"], stack=True)
        assert np.isfinite(got["grad_norm"])
    got = dict(tree_items(tree_to_numpy(tstate)))
    want = dict(tree_items(jax.tree.map(np.asarray, jstate)))
    assert list(got) == list(want)
    for path in got:
        # parameters: a quarter of the learning rate (see tests/test_torch_train.py)
        tol = dict(atol=2.5e-4, rtol=1e-4) if path.startswith("params") else TOL
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(want[path], np.float64), err_msg=path, **tol)


def test_bf16_forward_keeps_the_gates_fp32():
    """Under bf16 parameters the gate projections and recurrent weights
    stay fp32 and the hidden states come out bf16 and finite."""
    jcfg, tcfg = _configs(compute_dtype="bfloat16", param_dtype="bfloat16")
    params = jmodels.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    assert tparams["blocks"]["pos1"]["mixer"]["r_gates"].dtype == torch.float32
    assert tparams["blocks"]["pos0"]["mixer"]["w_gates"]["w"].dtype == torch.float32
    toks = _toks(np.random.default_rng(7), 2, 16)
    got, _, _ = tmodels.forward(tparams, torch.from_numpy(toks), tcfg)
    want = jax.jit(lambda p, t: jmodels.forward(p, t, jcfg)[0])(params, jnp.asarray(toks))
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=5e-2, rtol=5e-2)
