"""Checkpoints of the port against the reference's, on the CPU: the same
on-disk format both ways.

A train state saved by either package restores in the other bit for bit
(bf16 / fp32 weights and moments, the int8 blocks of `adam8bit`, the int32
step counters), under both codecs; the port's manifest equals the
reference's and each shard's decompressed msgpack payload is the same
bytes.  A training job moves from the reference's `Trainer` to the port's
and back through checkpoints, and follows the uninterrupted reference run:
losses at 1e-5 relative, as `tests/test_torch_train.py` holds three steps
from one state (the two frameworks sum in other orders)."""

import json
import os
import zlib

import jax
import msgpack
import numpy as np
import pytest
import torch
import zstandard

from repro.ckpt import checkpoint as jck
from repro.configs import get_config as jget_config
from repro.models import reduced as jreduced
from repro.train import init_state as jinit_state
from repro.train import make_optimizer as jmake_optimizer
from repro.train import state_shapes as jstate_shapes
from repro.train import trainer as jtrainer
from repro_torch._tree import tree_items
from repro_torch.ckpt import checkpoint as tck
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import state_from_jax
from repro_torch.models import reduced as treduced
from repro_torch.train import make_optimizer as tmake_optimizer
from repro_torch.train import state_shapes as tstate_shapes
from repro_torch.train import trainer as ttrainer

OPTIMIZERS = ["adamw", "adafactor", "adam8bit"]
CODECS = ["zstd", "zlib"]
LOSS_TOL = dict(rtol=1e-5)


@pytest.fixture
def codec(request, monkeypatch):
    """Both packages write with ``request.param``."""
    monkeypatch.setattr(jck, "_DEFAULT_CODEC", request.param)
    monkeypatch.setattr(tck, "_DEFAULT_CODEC", request.param)
    return request.param


def _cfgs(**overrides):
    kw = {"vocab_size": 64, "param_dtype": "bfloat16", **overrides}
    return (jreduced(jget_config("granite-3-2b"), **kw),
            treduced(tget_config("granite-3-2b"), **kw))


def _states(name, seed=0):
    """A reference train state with bf16 weights, and the port's copy."""
    jcfg, _ = _cfgs()
    jstate = jinit_state(jax.random.PRNGKey(seed), jcfg, jmake_optimizer(name))
    # Moments of zeros would hide a byte-order or type slip: fill them.
    rng = np.random.default_rng(seed)
    jstate = jax.tree.map(
        lambda a: a if a.ndim == 0 else
        (rng.standard_normal(a.shape) * 3).astype(a.dtype), jstate)
    return jstate, state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")


def _assert_equal_to(tstate, jstate):
    got = list(tree_items(tstate))
    want = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert [p for p, _ in got] == [p for p, _ in tree_items(want)]
    for (path, a), (_, b) in zip(got, tree_items(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def _payloads(path):
    """Each shard's decompressed msgpack payload, by file name."""
    codec = json.load(open(os.path.join(path, "manifest.json")))["codec"]
    inflate = zstandard.ZstdDecompressor().decompress if codec == "zstd" else zlib.decompress
    return {f: inflate(open(os.path.join(path, f), "rb").read())
            for f in sorted(os.listdir(path)) if f.startswith("shard_")}


# ------------------------------------------------------------ one package --
def test_roundtrip(tmp_path):
    _, tstate = _states("adamw")
    path = tck.save(str(tmp_path), 3, tstate, extra={"step": 3})
    got = tck.restore(path, tstate)
    for (p, a), (_, b) in zip(tree_items(got), tree_items(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
        assert a.data_ptr() != b.data_ptr()
    assert tck.read_extra(path) == {"step": 3}
    raw = tck._load_raw(path)
    assert list(raw) == [p for p, _ in tree_items(tstate, sep="/")]
    assert all(torch.equal(raw[p], t) for p, t in tree_items(tstate, sep="/"))


def test_atomicity_uncommitted_ignored(tmp_path):
    _, tstate = _states("adamw")
    tck.save(str(tmp_path), 1, tstate)
    # A crashed save: a directory without the COMMIT marker.
    os.makedirs(tmp_path / "step_00000002")
    (tmp_path / "step_00000002" / "manifest.json").write_text("{}")
    assert tck.latest_checkpoint(str(tmp_path)).endswith("step_00000001")
    assert [s for s, _ in tck.list_checkpoints(str(tmp_path))] == [1]
    assert tck.latest_checkpoint(str(tmp_path / "none")) is None


def test_manager_retention_restore_and_timings(tmp_path):
    _, tstate = _states("adafactor")
    mgr = tck.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tstate, {"step": s})
    mgr.wait()
    assert [s for s, _ in tck.list_checkpoints(str(tmp_path))] == [3, 4]
    nbytes = tck.tree_nbytes(tstate)
    assert mgr.last_snapshot_s > 0 and mgr.last_save["payload_bytes"] == nbytes
    assert mgr.last_save["seconds"] >= sum(mgr.last_save[k] for k in
                                           ("to_host", "pack", "compress", "write"))
    got, extra = mgr.restore_latest(tstate_shapes(_cfgs()[1], tmake_optimizer("adafactor")))
    assert extra == {"step": 4}
    assert mgr.last_restore["payload_bytes"] == nbytes
    assert mgr.last_restore["file_bytes"] == mgr.last_save["file_bytes"] > 0
    assert all(mgr.last_restore[k] > 0 for k in ("read", "decompress", "unpack", "to_device"))
    for (p, a), (_, b) in zip(tree_items(got), tree_items(tstate)):
        assert a.device.type == "cpu" and torch.equal(a, b), p
    assert tck.CheckpointManager(str(tmp_path / "empty")).restore_latest(tstate) is None


def test_save_async_snapshots_before_it_returns(tmp_path):
    """The port's optimizers update the state in place: what is saved is
    the state when `save_async` was called, not when the thread wrote it."""
    _, tstate = _states("adamw")
    want = {p: t.clone() for p, t in tree_items(tstate)}
    mgr = tck.CheckpointManager(str(tmp_path))
    mgr.save_async(1, tstate)
    for _, t in tree_items(tstate):
        t.add_(1)                               # the next step, in place
    mgr.wait()
    got = tck.restore(tck.latest_checkpoint(str(tmp_path)), tstate)
    for p, t in tree_items(got):
        assert torch.equal(t, want[p]), p


def test_restore_checks_shapes_and_leaves(tmp_path):
    _, tstate = _states("adamw")
    path = tck.save(str(tmp_path), 1, tstate)
    bad = dict(tstate, step=torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="step"):
        tck.restore(path, bad)
    with pytest.raises(KeyError, match="extra"):
        tck.restore(path, dict(tstate, extra=torch.zeros(())))
    # A cast to the target's type, as the reference's astype.
    got = tck.restore(path, {"step": torch.zeros((), dtype=torch.int64)})
    assert got["step"].dtype == torch.int64 and int(got["step"]) == int(tstate["step"])


def test_zstd_checkpoint_without_zstandard_raises(tmp_path, monkeypatch):
    _, tstate = _states("adamw")
    monkeypatch.setattr(tck, "_DEFAULT_CODEC", "zstd")
    path = tck.save(str(tmp_path), 1, tstate)
    monkeypatch.setattr(tck, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard is not installed"):
        tck.restore(path, tstate)
    with pytest.raises(RuntimeError, match="zstandard not installed"):
        tck.save(str(tmp_path), 2, tstate)


def test_a_leaf_past_msgpack_limit_is_refused(tmp_path, monkeypatch):
    """msgpack stores at most 4 GiB in one item; the port names the leaf."""
    _, tstate = _states("adamw")
    monkeypatch.setattr(tck, "_MAX_BIN", 1000)
    with pytest.raises(ValueError, match="4 GiB"):
        tck.save(str(tmp_path), 1, tstate)
    assert tck.list_checkpoints(str(tmp_path)) == []


# --------------------------------------------------------- both packages --
@pytest.mark.parametrize("codec", CODECS, indirect=True)
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_checkpoints_cross_both_ways(tmp_path, codec, name):
    jstate, tstate = _states(name)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    jpath = jck.save(str(tmp_path / "jax"), 7, jstate, {"step": 8})
    tpath = tck.save(str(tmp_path / "port"), 7, tstate, {"step": 8})
    # JAX -> port, into real tensors and into the meta state_shapes tree.
    _assert_equal_to(tck.restore(jpath, tstate), jstate)
    meta = tstate_shapes(_cfgs()[1], tmake_optimizer(name))
    _assert_equal_to(tck.restore(jpath, meta, device="cpu"), jstate)
    # port -> JAX
    jback = jck.restore(tpath, jax.eval_shape(lambda: jstate))
    for path, a, b in zip([p for p, _ in tree_items(tstate)], jax.tree.leaves(jback),
                          jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b)), path
    assert jck.read_extra(tpath) == tck.read_extra(jpath) == {"step": 8}


@pytest.mark.parametrize("shard_bytes", [256 * 1024 * 1024, 40_000])
@pytest.mark.parametrize("codec", CODECS, indirect=True)
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_manifest_and_payloads_are_the_same_bytes(tmp_path, monkeypatch, codec, name,
                                                  shard_bytes):
    """Leaf order decides the shards: with small shards too, the manifests
    are equal and each shard's payload is byte for byte the reference's."""
    monkeypatch.setattr(jck, "_SHARD_BYTES", shard_bytes)
    monkeypatch.setattr(tck, "_SHARD_BYTES", shard_bytes)
    jstate, tstate = _states(name)
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    jpath = jck.save(str(tmp_path / "jax"), 2, jstate, {"step": 3})
    tpath = tck.save(str(tmp_path / "port"), 2, tstate, {"step": 3})
    jman = json.load(open(os.path.join(jpath, "manifest.json")))
    tman = json.load(open(os.path.join(tpath, "manifest.json")))
    assert tman == jman and tman["codec"] == codec
    assert {leaf["dtype"] for leaf in tman["leaves"]} >= {"bfloat16", "int32"}
    jp, tp = _payloads(jpath), _payloads(tpath)
    assert list(tp) == list(jp) and (len(tp) > 1) == (shard_bytes < 1_000_000)
    for f in jp:
        assert tp[f] == jp[f], f
        assert [i["path"] for i in msgpack.unpackb(tp[f])] == \
            [leaf["path"] for leaf in tman["leaves"] if tck._shard_name(leaf["shard"], codec) == f]
    assert tck.checkpoint_nbytes(tpath) == jck.checkpoint_nbytes(jpath)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_sizes_equal_the_reference(name):
    jcfg, tcfg = _cfgs()
    want = jck.tree_nbytes(jstate_shapes(jcfg, jmake_optimizer(name)))
    got = tck.tree_nbytes(tstate_shapes(tcfg, tmake_optimizer(name)))
    assert got == want
    for n in (0, 1, want, tck._SHARD_BYTES, tck._SHARD_BYTES + 1, 25_300_000_000):
        assert tck.shard_count(n) == jck.shard_count(n)
    numpy_like = {"a": np.zeros((3, 5), np.float32), "b": np.zeros((7,), np.int8)}
    assert tck.tree_nbytes(numpy_like) == jck.tree_nbytes(numpy_like) == 67


# ------------------------------------------------------------------ trainer --
class _Crash(Exception):
    pass


def _crash_at(step):
    def hook(tr, s, state, rec):
        if s == step:
            raise _Crash
    return hook


def test_restart_resumes_deterministically(tmp_path):
    """The twin of tests/test_ckpt_runtime.py's test: 12 steps straight
    against a run stopped at step 9 and resumed from its step-6 checkpoint.
    On the CPU the resumed losses are the uninterrupted run's, bit for bit."""
    _, cfg = _cfgs(param_dtype="float32")

    def make(ckpt_dir, hooks=()):
        tcfg = ttrainer.TrainerConfig(steps=12, ckpt_every=6, log_every=1000,
                                      ckpt_dir=ckpt_dir, seed=3)
        return ttrainer.make_synthetic_trainer(cfg, tcfg, global_batch=4, seq_len=32,
                                               step_hooks=list(hooks), device="cpu")

    full = make(str(tmp_path / "a"))
    full.run()
    assert [s for s, _ in tck.list_checkpoints(str(tmp_path / "a"))] == [6, 12]
    crashed = make(str(tmp_path / "b"), [_crash_at(9)])
    with pytest.raises(_Crash):
        crashed.run()
    crashed.ckpt.wait()                       # the step-6 save commits
    resumed = make(str(tmp_path / "b"))
    state, start = resumed.init_or_restore()
    assert start == 7 and int(state["step"]) == 7
    resumed.run(state=state, start_step=start)
    got = {m["step"]: m["loss"] for m in resumed.metrics_log}
    assert sorted(got) == list(range(7, 12))
    for m in full.metrics_log[7:]:
        assert got[m["step"]] == m["loss"], m["step"]


@pytest.mark.parametrize("codec", ["zlib"], indirect=True)
def test_a_job_moves_from_jax_to_the_port_and_back(tmp_path, codec):
    """The reference's `Trainer` runs steps 0-3 and stops after its step-2
    checkpoint; the port's `Trainer` resumes at step 3 from it and stops at
    step 5 after its step-4 checkpoint; the reference resumes at step 5 and
    ends at 8.  Every loss follows an uninterrupted reference run."""
    jcfg, tcfg = _cfgs(param_dtype="float32")
    kw = dict(steps=8, ckpt_every=2, log_every=1000, seed=1, loss_chunk=8)
    shared = str(tmp_path / "job")

    def jmake(ckpt_dir, hooks=()):
        return jtrainer.make_synthetic_trainer(
            jcfg, jtrainer.TrainerConfig(ckpt_dir=ckpt_dir, **kw), 2, 16,
            step_hooks=list(hooks))

    straight = jmake(str(tmp_path / "straight"))
    straight.run()
    want = {m["step"]: m["loss"] for m in straight.metrics_log}

    first = jmake(shared, [_crash_at(3)])
    with pytest.raises(_Crash):
        first.run()
    first.ckpt.wait()
    port = ttrainer.make_synthetic_trainer(
        tcfg, ttrainer.TrainerConfig(ckpt_dir=shared, **kw), 2, 16,
        step_hooks=[_crash_at(5)], device="cpu")
    with pytest.raises(_Crash):
        port.run()
    port.ckpt.wait()
    back = jmake(shared)
    back.run()
    got = {m["step"]: m["loss"] for m in port.metrics_log}
    assert sorted(got) == [3, 4, 5]
    got.update({m["step"]: m["loss"] for m in back.metrics_log})
    assert sorted(got) == [3, 4, 5, 6, 7]
    for step, loss in got.items():
        np.testing.assert_allclose(loss, want[step], err_msg=f"step {step}", **LOSS_TOL)
    assert [s for s, _ in tck.list_checkpoints(shared)] == [4, 6, 8]


def test_each_shard_file_is_its_payload_compressed_alone(tmp_path, monkeypatch):
    """A multi-shard zlib save goes through the pool of compressing threads:
    each shard file, in shard order, is exactly ``zlib.compress(payload, 6)``
    of its own payload, so the threads changed no byte; and a restore
    through the pool gives every leaf back."""
    monkeypatch.setattr(tck, "_DEFAULT_CODEC", "zlib")
    monkeypatch.setattr(tck, "_SHARD_BYTES", 40_000)
    _, tstate = _states("adamw")
    stats = {}
    path = tck.save(str(tmp_path), 4, tstate, stats=stats)
    files = sorted(f for f in os.listdir(path) if f.startswith("shard_"))
    assert len(files) > 2 and files == [tck._shard_name(i, "zlib") for i in range(len(files))]
    leaves = dict(tree_items(tstate, sep="/"))
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    for shard, f in enumerate(files):
        items = [{"path": leaf["path"], "data": leaves[leaf["path"]].contiguous().reshape(-1)
                  .view(torch.uint8).numpy().tobytes()}
                 for leaf in manifest["leaves"] if leaf["shard"] == shard]
        want = zlib.compress(msgpack.packb(items, use_bin_type=True), 6)
        assert open(os.path.join(path, f), "rb").read() == want, f
    assert stats["file_bytes"] == sum(os.path.getsize(os.path.join(path, f)) for f in files)
    assert set(stats) == {"to_host", "pack", "compress", "write", "payload_bytes", "file_bytes"}
    back = tck.restore(path, tstate)
    for (p, a), (_, b) in zip(tree_items(back), tree_items(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
