"""The Mamba2 and xLSTM mixers split over "model" in the port, on 4 gloo
ranks, against the JAX package's sharded runs and the port's own unsharded
runs.

Under a sharding context whose "model" axis divides a mixer's heads, each
rank computes its own heads of it, as the reference's rule table cuts the
mixers' leaves: Mamba2's z, x and dt columns of its heads with B and C
whole, its conv channels and scan, the gated norm from the ranks' summed
sums of squares and its rows of ``out_proj``; the mLSTM's and sLSTM's
heads with their q/k/v blocks, gates and recurrent weights.  Reduced
zamba2-7b (4 Mamba2 layers and the shared attention block) and reduced
xlstm-1.3b (an mLSTM and an sLSTM block) train `TP_STEPS` AdamW steps on
(1, 4) and (2, 2), and their loss and gradients at the initial parameters
are taken on both; the engine serves both on (2, 2) from caches of the
ranks' channels and heads, and moves a slot to one device and back.

Tolerances (fp32), as for the other tensor-parallel layers
(`tests/test_torch_tensor_parallel.py`): losses 1e-5 and gradient norms
1e-4 relative, parameters within a quarter of the learning rate
(`torch_dist_util.check_tensor_parallel`); gradients 1e-4; the engine's
logits 2e-5, its streams, payloads and moved slots exact."""

import pickle

import numpy as np
import pytest

import torch_dist_util as du

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
MESH_IDS = lambda s: f"{s[0]}x{s[1]}"


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    work = tmp_path_factory.mktemp("jax")
    ref = du.run_jax("jax_tensor_parallel_mixers", work)
    with open(work / "ref.pkl", "wb") as f:
        pickle.dump(ref, f)
    return work / "ref.pkl", ref


@pytest.fixture(scope="module")
def ranks(jax_refs, tmp_path_factory):
    return du.run_ranks("rank_tensor_parallel_mixers", 4, tmp_path_factory.mktemp("ranks"),
                        ref_file=str(jax_refs[0]))


@pytest.mark.parametrize("shape", du.TP_MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", du.MIXER_ARCHS)
def test_a_split_mixer_train_step_follows_the_unsharded_run(ranks, arch, shape):
    du.check_tensor_parallel(ranks, arch, shape)


@pytest.mark.parametrize("shape", du.TP_MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", du.MIXER_ARCHS)
def test_a_split_mixer_train_step_follows_the_jax_packages_on_the_same_mesh(
        jax_refs, ranks, arch, shape):
    want = jax_refs[1][arch]["runs"][shape]
    for r in ranks:
        got = r[(arch, shape)]
        du.same_log(got["sharded"], want["log"])
        assert list(got["params"]) == list(want["params"])
        for p, w in want["params"].items():
            np.testing.assert_allclose(got["params"][p], w, atol=2.5e-4, rtol=0, err_msg=p)


@pytest.mark.parametrize("shape", du.TP_MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", du.MIXER_ARCHS)
def test_the_split_mixers_gradients_are_the_references(jax_refs, ranks, arch, shape):
    """Every leaf's gradient of `batch_np` (0)'s loss at the initial
    parameters, the mixers' shards among them, is the reference's sharded
    run's: B's and C's columns (and the mLSTM gates' rows) summed over the
    ranks' heads."""
    want = jax_refs[1][arch]["runs"][shape]
    for r in ranks:
        got = r[(arch, shape)]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert list(got["grads"]) == list(want["grads"])
        for p, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][p], w, err_msg=p, **GRAD_TOL)


@pytest.mark.parametrize("shape", du.TP_MESHES, ids=MESH_IDS)
def test_each_rank_computes_its_mamba2_heads(ranks, shape):
    """Reduced zamba2's Mamba2 mixer (4 heads of 64, d_inner 256, state 16)
    on n "model" ranks: the scan runs at 4/n heads, the cache holds
    256/n + 2 x 16 conv channels and 4/n heads' states, and the rule
    table's shards stay cut (``in_proj``'s 548 columns, ``out_proj``'s 256
    rows)."""
    n_data, n = shape
    for r in ranks:
        got = r[("zamba2-7b", shape)]
        assert got["seen"] == [("mamba2", 4 // n)]
        assert got["cache"]["pos0/mixer/conv"] == (2, 4 // n_data, 3, 256 // n + 32)
        assert got["cache"]["pos0/mixer/state"] == (2, 4 // n_data, 4 // n, 64, 16)
        assert got["local"]["pos0/mixer/in_proj/w"] == (2, 128 // n_data, 548 // n)
        assert got["local"]["pos0/mixer/out_proj/w"] == (2, 256 // n, 128 // n_data)


@pytest.mark.parametrize("shape", du.TP_MESHES, ids=MESH_IDS)
def test_each_rank_computes_its_xlstm_heads(ranks, shape):
    """Reduced xlstm's mLSTM (4 heads of 64) and sLSTM (4 heads of 32)
    mixers on n "model" ranks: each recurrence runs at 4/n heads, the
    caches hold the rank's channels and heads, and the block-diagonal q/k/v
    its 64/n blocks of 4."""
    n_data, n = shape
    for r in ranks:
        got = r[("xlstm-1.3b", shape)]
        assert got["seen"] == [("mlstm", 4 // n), ("slstm", 4 // n)]
        rows = 4 // n_data
        assert got["cache"]["pos0/mixer/conv"] == (1, rows, 3, 256 // n)
        assert got["cache"]["pos0/mixer/C"] == (1, rows, 4 // n, 64, 64)
        assert got["cache"]["pos1/mixer/conv"] == (1, rows, 3, 128 // n)
        assert got["cache"]["pos1/mixer/h"] == (1, rows, 4 // n, 32)
        assert got["local"]["pos0/mixer/wq/w"] == (1, 64 // n, 4, 4)


@pytest.mark.parametrize("arch", du.MIXER_ARCHS)
def test_the_engine_on_2x2_serves_split_mixers_as_unsharded(jax_refs, ranks, arch):
    """4 slots on (2, 2): each rank holds 2 slots' rows of its mixers'
    channels and heads.  Greedy streams equal the unsharded engine's and
    the reference engine's; one decode step's logits equal an unsharded
    engine's into which every slot was imported (2e-5)."""
    for r in ranks:
        got = r[(arch, "engine")]
        assert got["streams"]["mesh"] == got["streams"]["whole"]
        assert got["streams"]["mesh"] == jax_refs[1][arch]["streams"]
        assert all(len(s) == 6 for s in got["streams"]["mesh"].values())
        mine, whole = got["logits"]
        assert got["rows"] == 2 and mine.shape == whole.shape == (2, 1, 64)
        np.testing.assert_allclose(mine, whole, **TOL)


@pytest.mark.parametrize("arch", du.MIXER_ARCHS)
def test_a_slot_exported_on_2x2_is_the_one_device_payload(ranks, arch):
    """A sampled request exported mid-decode on (2, 2) gives the one-device
    payload (every leaf's shape an unsharded engine's); imported into one
    device it exports back bit for bit and goes on to the tokens of the
    request that never moved; imported into another (2, 2) engine it
    continues bit for bit."""
    for r in ranks:
        got = r[(arch, "engine")]
        assert got["whole_shapes"] == got["one_device_shapes"]
        state, back, on_one, kept_tokens = got["one_device"]
        assert list(state) == list(back)
        for p in state:
            assert state[p].tobytes() == back[p].tobytes(), p
        assert len(kept_tokens) == 10 and on_one == kept_tokens
        moved, kept, moved_bits, kept_bits = got["moved"]
        assert moved == kept
        assert list(moved_bits) == list(kept_bits)
        for p in kept_bits:
            assert moved_bits[p].tobytes() == kept_bits[p].tobytes(), p
