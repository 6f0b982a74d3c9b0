"""Tensor-parallel compute in the port, on 4 gloo ranks, against the JAX
package's sharded runs and the port's own unsharded runs.

Under a sharding context each rank computes its own share of the step, as
the reference's SPMD program does from the same rule table: its attention
heads, FFN columns and, where the axis divides it, vocab slice over
"model"; its data rank's rows of a MoE layer's buffer for the experts it
holds.  Reduced qwen1.5-0.5b (MHA, QKV bias, a tied vocab of 64 that
splits), reduced granite-3-2b (GQA 4/2, a vocab of 67 that does not
split, as its own 49155 does not), reduced seamless-m4t-large-v2 (a
non-causal encoder, cross-attention, a GELU FFN) and reduced
nemotron-4-15b (a squared-ReLU FFN) train `TP_STEPS` AdamW steps on
(1, 4) and (2, 2): on (1, 4) granite's and nemotron's two kv heads are
shared by pairs of ranks, each holding half a head's columns.  Reduced qwen2-vl (M-RoPE, Hkv 2) on
(1, 4), with 4 query heads (ranks share a kv head) and with 6 (the heads
do not divide; each rank computes the whole attention): loss and
gradients.  A dbrx MoE cut on (2, 2), 2 of its 4 experts
a rank, at the config's capacity and at a tight one (assignments drop):
outputs, aux loss, drops and gradients.  The engine on (2, 2): greedy
streams, logits and a slot moved between the data ranks; seamless's
prefill and decode steps with a cross cache.

Tolerances (fp32): losses 1e-5 and gradient norms 1e-4 relative,
parameters within a quarter of the learning rate, as the sharded train
checks (`torch_dist_util.check_*`, shared with `tools/multi_gpu_check.py`);
the MoE layer's outputs and gradients 2e-5 (the reference's own EP test);
gradients of the whole model 1e-4 (tests/test_torch_train.py's); the
engine's logits 2e-5, its streams and moved slot exact."""

import pickle

import numpy as np
import pytest
import torch

import torch_dist_util as du

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    work = tmp_path_factory.mktemp("jax")
    ref = du.run_jax("jax_tensor_parallel", work)
    with open(work / "ref.pkl", "wb") as f:
        pickle.dump(ref, f)
    return work / "ref.pkl", ref


@pytest.fixture(scope="module")
def ranks(jax_refs, tmp_path_factory):
    return du.run_ranks("rank_tensor_parallel", 4, tmp_path_factory.mktemp("ranks"),
                        ref_file=str(jax_refs[0]))


@pytest.mark.parametrize("shape", du.TP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(du.TP_VOCAB))
def test_a_tensor_parallel_train_step_follows_the_unsharded_run(ranks, arch, shape):
    du.check_tensor_parallel(ranks, arch, shape)


@pytest.mark.parametrize("shape", du.TP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(du.TP_VOCAB))
def test_a_tensor_parallel_train_step_follows_the_jax_packages_on_the_same_mesh(
        jax_refs, ranks, arch, shape):
    want = jax_refs[1][arch]["runs"][shape]
    for r in ranks:
        got = r[(arch, shape)]
        du.same_log(got["sharded"], want["log"])
        assert list(got["params"]) == list(want["params"])
        for p, w in want["params"].items():
            np.testing.assert_allclose(got["params"][p], w, atol=2.5e-4, rtol=0, err_msg=p)


@pytest.mark.parametrize("shape", du.TP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(du.TP_VOCAB))
def test_each_rank_holds_its_share_of_the_weights(ranks, arch, shape):
    """The rule table's cut, kept where the rank computes: a layer's query
    columns (4 heads x 32) and FFN hidden (256) over "model", d_model (128)
    over "data"; the vocab over "model" where it divides (qwen's 64), whole
    where it does not (granite's 67)."""
    n_data, n_model = shape
    local = ranks[0][(arch, shape)]["local"]
    assert local["wq"] == (2, 128 // n_data, 128 // n_model)
    assert local["w_up"] == (2, 128 // n_data, 256 // n_model)
    vocab = du.TP_VOCAB[arch]
    assert local["embed"] == ((vocab // n_model if vocab % n_model == 0 else vocab),
                              128 // n_data)


@pytest.mark.parametrize("case", list(du.TP_VL))
def test_qwen2_vl_heads_on_1x4_give_the_references_gradients(jax_refs, ranks, case):
    """Reduced qwen2-vl (2 kv heads of 32, M-RoPE) on (1, 4): with 4 query
    heads each rank has one, and pairs of ranks read one kv head whose
    columns the rule cut in half; with 6 the heads do not divide and every
    rank computes the whole attention from the gathered weights.  The loss
    and every gradient are the reference's sharded run's."""
    want = jax_refs[1][case]
    for r in ranks:
        got = r[case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert list(got["grads"]) == list(want["grads"])
        for p, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][p], w, err_msg=p, **GRAD_TOL)


def _assembled(ranks, case, key):
    """The whole batch's rows of the ranks' ``key``: data rank i (ranks 2i,
    2i + 1) holds rows 2i, 2i + 1; the model ranks agree exactly."""
    per = [r["moe"][case][key] for r in ranks]
    np.testing.assert_array_equal(per[1], per[0])
    np.testing.assert_array_equal(per[3], per[2])
    return np.concatenate([per[0], per[2]])


@pytest.mark.parametrize("case", du.MOE_TP_CASES)
def test_the_moe_layer_on_2x2_is_the_whole_batchs(jax_refs, ranks, case):
    """Each rank fills and multiplies only its own rows for 2 of the 4
    experts: outputs, drops and the aux loss (the mean of the data ranks')
    are the single-program layer's over the whole batch, in the port and in
    the reference, whose sharded layer equals its own; at the tight
    capacity assignments drop."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models.moe import moe_ffn

    ref = jax_refs[1]["moe"][case]
    cfg = du.moe_cut("torch", case)
    y, aux, metrics = moe_ffn(params_from_jax(ref["params"], "cpu"),
                              torch.from_numpy(ref["x"]), cfg)
    got = _assembled(ranks, case, "y")
    np.testing.assert_allclose(got, y.numpy(), **TOL)
    np.testing.assert_allclose(got, ref["y"], **TOL)
    np.testing.assert_allclose(ref["on_mesh"], ref["y"], **TOL)
    rs = [r["moe"][case] for r in ranks]
    np.testing.assert_allclose((rs[0]["aux"] + rs[2]["aux"]) / 2, float(aux), rtol=1e-5)
    np.testing.assert_allclose((rs[0]["aux"] + rs[2]["aux"]) / 2, ref["aux"], rtol=1e-5)
    np.testing.assert_allclose((rs[0]["drops"] + rs[2]["drops"]) / 2,
                               float(metrics["moe_drop_frac"]), atol=1e-7)
    np.testing.assert_allclose((rs[0]["drops"] + rs[2]["drops"]) / 2, ref["drops"], atol=1e-7)
    assert all(r["experts_local"] == (2, 32, 32) for r in rs)
    if case == "tight":
        assert ref["drops"] > 0


@pytest.mark.parametrize("case", du.MOE_TP_CASES)
def test_the_moe_layers_gradients_on_2x2_are_the_whole_batchs(jax_refs, ranks, case):
    """The gradients, averaged over the data ranks as the train step does,
    are the whole batch's: the input's rows and the router's of sum(y^2)
    as they are, the experts' (a mean over the data ranks already) times
    2; the aux loss's, whose whole-batch value is the mean of the ranks'."""
    ref = jax_refs[1]["moe"][case]
    rs = [r["moe"][case] for r in ranks]
    np.testing.assert_allclose(_assembled(ranks, case, "gx"), ref["gx"], **TOL)
    np.testing.assert_allclose(rs[0]["grouter"] + rs[2]["grouter"], ref["grouter"], **TOL)
    for k, want in ref["gexperts"].items():
        for r in rs:
            np.testing.assert_allclose(2 * r["gexperts"][k], want, err_msg=k, **TOL)
    np.testing.assert_allclose(_assembled(ranks, case, "gx_aux") / 2, ref["gx_aux"], **TOL)
    np.testing.assert_allclose((rs[0]["grouter_aux"] + rs[2]["grouter_aux"]) / 2,
                               ref["grouter_aux"], **TOL)


@pytest.fixture(scope="module")
def engine_ranks(tmp_path_factory):
    return du.run_ranks("rank_engine_on_a_mesh", 4, tmp_path_factory.mktemp("engine"))


def test_the_engine_on_a_mesh_serves_the_unsharded_engines_streams(engine_ranks):
    """4 slots on (2, 2): each rank holds 2 slots' rows of 2 of the 4 kv
    heads; greedy streams equal the unsharded engine's, and the decode
    step's logits the unsharded step's on the same cache (2e-5)."""
    for r in engine_ranks:
        assert r["streams"]["mesh"] == r["streams"]["whole"]
        assert all(len(s) == 6 for s in r["streams"]["mesh"].values())
        assert r["rows"] == 2 and r["kv_heads"] == (2, 2, 48, 2, 32)
        got, want = r["logits"]
        assert got.shape == want.shape == (2, 1, 64)
        np.testing.assert_allclose(got, want, **TOL)


def test_seamless_serves_on_a_mesh_from_its_cross_cache(engine_ranks):
    """Reduced seamless-m4t-large-v2 on (2, 2): the prefill encodes each
    data rank's 2 rows of 16 frames and fills a cross cache of the rank's
    2 of 4 kv heads; its logits and one decode step's, read from that
    cache, equal the unsharded steps' (2e-5)."""
    for r in engine_ranks:
        c = r["cross"]
        assert c["cross_kv"] == (2, 2, du.TP_FRAMES, 2, 32)
        for got, want in (c["first"], c["next"]):
            assert got.shape == want.shape == (2, 1, 64)
            np.testing.assert_allclose(got, want, **TOL)


def test_a_slot_moved_between_data_ranks_continues_bit_for_bit(engine_ranks):
    """A sampled request exported mid-decode from slot 0 (data rank 0) and
    imported into slot 3 (data rank 1) of another engine on the mesh: its
    tokens and its slot's final state (each rank's kv heads) equal a run
    that never moved."""
    for r in engine_ranks:
        moved, kept, moved_bits, kept_bits, (offset, want_offset) = r["moved"]
        assert len(kept) == 10 and moved == kept and offset == want_offset
        assert list(moved_bits) == list(kept_bits)
        for p in kept_bits:
            assert moved_bits[p].tobytes() == kept_bits[p].tobytes(), p
