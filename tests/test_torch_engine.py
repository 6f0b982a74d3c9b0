"""`ServeEngine` of the port against the reference engine, and its own
slot-lifecycle, sampling and kv-ship properties, on the CPU.

Greedy token streams must be EQUAL to the JAX engine's on converted
weights; if a stream ever differs because two logits lie within 1e-4 of
each other, change the seed below, not a tolerance.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import serve as jserve
from repro.configs import get_config as jget_config
from repro_torch import models as tmodels
from repro_torch import serve as tserve
from repro_torch._tree import tree_leaves
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_jax, params_from_jax, tree_to_numpy

SEED = 0


def _models(arch="qwen1.5-0.5b", **overrides):
    jcfg = jmodels.reduced(jget_config(arch), vocab_size=64, **overrides)
    tcfg = tmodels.reduced(tget_config(arch), vocab_size=64)
    params = jmodels.init_lm(jax.random.PRNGKey(SEED), jcfg)
    return jcfg, tcfg, params, params_from_jax(jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def qwen():
    return _models("qwen1.5-0.5b")


def _requests(mod, n=6, seed=1, max_new=6):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(1, 64, size=int(rng.integers(2, 7))).tolist(),
                        max_new_tokens=max_new) for i in range(n)]


def _engine(tcfg, tparams, slots=2, max_len=48, **kw):
    return tserve.ServeEngine(tcfg, tparams, batch_slots=slots, max_len=max_len,
                              eos_id=-1, device="cpu", **kw)


def _run(engine, requests, max_steps=500):
    for r in requests:
        engine.submit(r)
    engine.run_until_done(max_steps)
    return {r.req_id: list(r.output) for r in requests}


@pytest.mark.parametrize("arch,attn_impl", [("qwen1.5-0.5b", "ref"),
                                            ("qwen1.5-0.5b", "flash_decode"),
                                            ("granite-3-2b", "ref"),
                                            ("granite-3-2b", "flash_decode")])
def test_greedy_streams_equal_the_jax_engine(arch, attn_impl):
    """6 requests through 2 slots: every token of every stream."""
    max_len = 64 if attn_impl == "flash_decode" else 48   # Pallas wants Sk % block == 0
    jcfg, tcfg, params, tparams = _models(arch, attn_impl=attn_impl)
    jeng = jserve.ServeEngine(jcfg, params, batch_slots=2, max_len=max_len, eos_id=-1)
    want = _run(jeng, _requests(jserve))
    teng = _engine(tcfg, tparams, max_len=max_len)
    got = _run(teng, _requests(tserve))
    assert got == want
    assert teng.steps == jeng.steps
    assert [r.req_id for r in teng.finished] == [r.req_id for r in jeng.finished]
    assert all(len(v) == 6 for v in got.values())


def test_eos_and_slot_offsets_follow_the_reference(qwen):
    """eos ends a request; offsets and fed tokens match step for step."""
    jcfg, tcfg, params, tparams = qwen
    first = _run(_engine(tcfg, tparams), _requests(tserve, n=2))
    eos = first[0][2]                       # the third token request 0 generates
    jeng = jserve.ServeEngine(jcfg, params, batch_slots=2, max_len=48, eos_id=eos)
    teng = tserve.ServeEngine(tcfg, tparams, batch_slots=2, max_len=48, eos_id=eos,
                              device="cpu")
    for eng, mod in ((jeng, jserve), (teng, tserve)):
        for r in _requests(mod, n=4):
            eng.submit(r)
    while jeng.queue or any(jeng.slots):
        jeng.step()
        teng.step()
        assert teng.offsets.tolist() == jeng.offsets.tolist()
        np.testing.assert_array_equal(teng._slot_tokens(), jeng._slot_tokens())
        assert teng.cache["index"].tolist() == np.asarray(jeng.cache["index"]).tolist()
    assert not teng.queue and not any(teng.slots)
    assert [(r.req_id, r.output) for r in teng.finished] == \
           [(r.req_id, r.output) for r in jeng.finished]
    assert len(teng.finished[0].output) <= 6


def test_admission_into_a_freed_slot_is_fifo(qwen):
    _, tcfg, _, tparams = qwen
    eng = _engine(tcfg, tparams, slots=2)
    reqs = [tserve.Request(i, [3, 4], max_new_tokens=n) for i, n in enumerate([2, 6, 3, 3])]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert [s.req_id for s in eng.slots] == [0, 1] and [r.req_id for r in eng.queue] == [2, 3]
    while eng.slots[0] is reqs[0]:
        eng.step()
    eng.step()                                  # the freed slot 0 takes request 2, not 3
    assert eng.slots[0] is reqs[2] and eng.slots[1] is reqs[1]
    assert [r.req_id for r in eng.queue] == [3]
    eng.run_until_done(200)
    assert [r.req_id for r in eng.finished] == [0, 2, 1, 3]


def test_a_reused_slot_decodes_as_a_fresh_engine_does(qwen):
    _, tcfg, _, tparams = qwen
    eng = _engine(tcfg, tparams, slots=1)
    a = tserve.Request(0, [5, 6, 7, 8, 9], max_new_tokens=8)
    b = tserve.Request(1, [11, 12], max_new_tokens=5)
    _run(eng, [a, b])
    fresh = tserve.Request(1, [11, 12], max_new_tokens=5)
    _run(_engine(tcfg, tparams, slots=1), [fresh])
    assert b.output == fresh.output and len(b.output) == 5


def test_run_until_done_max_steps_drops_nothing(qwen):
    _, tcfg, _, tparams = qwen
    eng = _engine(tcfg, tparams, slots=2)
    reqs = _requests(tserve, n=5)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_done(max_steps=7)
    assert eng.steps == 7
    held = [s for s in eng.slots if s is not None]
    assert len(done) + len(held) + len(eng.queue) == 5
    eng.run_until_done(500)
    assert sorted(r.req_id for r in eng.finished) == [0, 1, 2, 3, 4]
    assert {r.req_id: r.output for r in reqs} == _run(_engine(tcfg, tparams), _requests(tserve, n=5))


def test_max_len_ends_a_request(qwen):
    _, tcfg, _, tparams = qwen
    eng = _engine(tcfg, tparams, slots=1, max_len=8)
    r = tserve.Request(0, [1, 2, 3], max_new_tokens=100)
    _run(eng, [r])
    assert r.done and int(eng.offsets[0]) == 7 and len(r.output) == 5


def test_idle_slots_running_past_max_len_change_nothing(qwen):
    """An empty slot's index keeps counting past max_len while the other
    slot works: no error, and no one's output changes."""
    _, tcfg, _, tparams = qwen
    eng = _engine(tcfg, tparams, slots=2, max_len=16)
    runs = [tserve.Request(i, [4, 5, 6], max_new_tokens=12) for i in range(3)]
    for r in runs:                          # one at a time: slot 1 stays empty
        eng.submit(r)
        eng.run_until_done(500)
        assert r.done and eng.slots == [None, None]
    assert int(eng.cache["index"][1]) == eng.steps == 42 > 16    # ran past the end
    alone = tserve.Request(0, [4, 5, 6], max_new_tokens=12)
    _run(_engine(tcfg, tparams, slots=2, max_len=16), [alone])
    assert all(r.output == alone.output for r in runs) and len(alone.output) == 12
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(eng.cache["blocks"]))


def test_index_past_max_len_matches_the_reference_cache(qwen):
    """The clamped write of a row past the end leaves the same cache."""
    jcfg, tcfg, params, tparams = qwen
    jeng = jserve.ServeEngine(jcfg, params, batch_slots=2, max_len=8, eos_id=-1)
    teng = _engine(tcfg, tparams, slots=2, max_len=8)
    for eng, mod in ((jeng, jserve), (teng, tserve)):
        eng.submit(mod.Request(0, [3, 4], max_new_tokens=1))        # frees slot 0 early
        eng.submit(mod.Request(1, [5, 6, 7], max_new_tokens=40))    # runs to max_len
        eng.run_until_done(100)
    # slot 0 idled on while slot 1 worked: its index is past the end
    assert teng.cache["index"].tolist() == np.asarray(jeng.cache["index"]).tolist()
    got = tree_to_numpy(teng.cache["blocks"])
    want = jax.tree.map(np.asarray, jeng.cache["blocks"])
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


class TestSampling:
    def _stream(self, tcfg, tparams, slots, others, place=0, **kw):
        eng = _engine(tcfg, tparams, slots=slots, temperature=0.7, rng_seed=3, **kw)
        me = tserve.Request(5, [7, 8, 9], max_new_tokens=10)
        before, after = others[:place], others[place:]
        for r in before:
            eng.submit(r)
        eng.submit(me)
        for r in after:
            eng.submit(r)
        eng.run_until_done(500)
        assert me.done
        return me.output

    def test_stream_is_the_same_alone_in_a_batch_and_in_another_slot(self, qwen):
        _, tcfg, _, tparams = qwen
        alone = self._stream(tcfg, tparams, 1, [])
        others = lambda: [tserve.Request(10 + i, [20 + i, 3], max_new_tokens=14) for i in range(3)]
        assert self._stream(tcfg, tparams, 4, others()) == alone           # slot 0, full batch
        assert self._stream(tcfg, tparams, 4, others(), place=2) == alone  # slot 2
        assert self._stream(tcfg, tparams, 2, others(), place=3) == alone  # queued, later step
        assert len(set(alone)) > 1

    def test_seed_and_request_id_change_the_stream(self, qwen):
        _, tcfg, _, tparams = qwen
        run = lambda seed, rid: _run(
            _engine(tcfg, tparams, slots=1, temperature=0.7, rng_seed=seed),
            [tserve.Request(rid, [7, 8, 9], max_new_tokens=12)])[rid]
        base = run(3, 5)
        assert run(3, 5) == base
        assert run(4, 5) != base and run(3, 6) != base

    def test_sample_function(self):
        logits = torch.tensor([[0.0, 5.0, 1.0], [9.0, 0.0, 0.0]])
        assert tserve.sample(logits, None, 0.0).tolist() == [1, 0]
        g = lambda: torch.Generator("cpu").manual_seed(11)
        a = tserve.sample(logits, g(), 1.0)
        assert a.tolist() == tserve.sample(logits, g(), 1.0).tolist()
        # the draws follow softmax(logits / T)
        gen = torch.Generator("cpu").manual_seed(0)
        row = torch.tensor([0.0, 1.0, 2.0])
        draws = torch.stack([tserve.sample(row, gen, 1.0) for _ in range(4000)])
        freq = torch.bincount(draws, minlength=3).float() / 4000
        np.testing.assert_allclose(freq.numpy(), torch.softmax(row, 0).numpy(), atol=0.03)


class TestKvShip:
    def _mk(self, tcfg, tparams):
        return _engine(tcfg, tparams, slots=2, max_len=64, temperature=0.7, rng_seed=3)

    def test_exported_slot_decodes_bit_identically(self, qwen):
        """Export a mid-decode slot, import it into another slot of a fresh
        engine: the sampled continuation and the slot's KV state equal a
        never-migrated run exactly."""
        _, tcfg, _, tparams = qwen
        ref_eng = self._mk(tcfg, tparams)
        ref = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
        ref_eng.submit(ref)
        ref_eng.run_until_done(200)

        src = self._mk(tcfg, tparams)
        mig = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
        src.submit(mig)
        while len(mig.output) < 4:                    # mid-decode
            src.step()
        state = src.export_slot(0)
        dst = self._mk(tcfg, tparams)
        dst.import_slot(1, state)                     # any free slot works
        dst.slots[1] = mig
        dst.offsets[1] = state["offset"]
        dst.run_until_done(200)
        assert mig.done
        assert mig.output == ref.output
        got, want = dst.export_slot(1), ref_eng.export_slot(0)
        assert got["offset"] == want["offset"] and int(got["index"]) == int(want["index"])
        assert got["tail"] == want["tail"] == []
        for a, b in zip(tree_leaves(got["blocks"]), tree_leaves(want["blocks"])):
            assert torch.equal(a, b)

    def test_payload_does_not_change_when_the_source_steps_on(self, qwen):
        _, tcfg, _, tparams = qwen
        src = self._mk(tcfg, tparams)
        src.submit(tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10))
        for _ in range(5):
            src.step()
        state = src.export_slot(0)
        frozen = copy.deepcopy(state)
        for _ in range(4):
            src.step()
        assert int(state["index"]) == int(frozen["index"]) == 5
        for a, b in zip(tree_leaves(state["blocks"]), tree_leaves(frozen["blocks"])):
            assert torch.equal(a, b)
        assert int(src.cache["index"][0]) == 9      # the source itself moved on

    def test_import_overwrites_slot_state_and_offset(self, qwen):
        _, tcfg, _, tparams = qwen
        src, dst = self._mk(tcfg, tparams), self._mk(tcfg, tparams)
        src.submit(tserve.Request(1, prompt=[4, 5, 6, 7], max_new_tokens=3))
        dst.submit(tserve.Request(2, prompt=[9, 9], max_new_tokens=9))
        for _ in range(3):
            src.step()
            dst.step()
        keep = dst.export_slot(0)
        dst.import_slot(1, src.export_slot(0))
        assert int(dst.offsets[1]) == 3 and dst.cache["index"].tolist() == [3, 3]
        for a, b in zip(tree_leaves(dst.export_slot(1)["blocks"]),
                        tree_leaves(src.export_slot(0)["blocks"])):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(dst.export_slot(0)["blocks"]), tree_leaves(keep["blocks"])):
            assert torch.equal(a, b)                # the neighbour slot is untouched

    def test_a_reference_payload_continues_in_the_port(self, qwen):
        """A slot exported by the JAX engine (as numpy) imports into the
        port's engine, which then decodes the reference's greedy tokens."""
        jcfg, tcfg, params, tparams = qwen
        jeng = jserve.ServeEngine(jcfg, params, batch_slots=2, max_len=64, eos_id=-1)
        jreq = jserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
        jeng.submit(jreq)
        while len(jreq.output) < 4:
            jeng.step()
        payload = jax.tree.map(np.asarray, jeng.export_slot(0))
        done_so_far = list(jreq.output)
        jeng.run_until_done(200)

        teng = _engine(tcfg, tparams, slots=2, max_len=64)
        treq = tserve.Request(5, prompt=[7, 8, 9], max_new_tokens=10)
        treq.output = done_so_far
        teng.import_slot(1, cache_from_jax(payload, "cpu"))
        teng.slots[1] = treq
        teng.run_until_done(200)
        assert treq.output == jreq.output
