"""The port's parallel layer against the reference's, on gloo ranks: the
MoE layer on a (2, 4) mesh (its expert-parallel branch, and its
single-program path over the whole batch), the int8 compressed mean over 2
and 4 ranks, and the GPipe pipeline on a (4, 2) mesh.  The reference's
multi-device results come from one JAX subprocess with 8 host devices.

Tolerances (fp32): outputs and gradients 2e-5 (the reference's own EP
test; the two frameworks sum in other orders), the pipeline's gradients
1e-5 absolute and 1e-4 relative as the reference's test; the compressed
mean within one int8 step of each block's scale."""

import pickle

import numpy as np
import pytest
import torch

from repro.parallel import pipeline as jpipe
from repro_torch.convert import params_from_jax
from repro_torch.models.moe import aux_losses, moe_ffn, router_probs
from repro_torch.parallel import collectives as tcoll
from repro_torch.parallel import pipeline as tpipe

import torch_dist_util as du

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    work = tmp_path_factory.mktemp("jax")
    return {name: du.run_jax(f"jax_{name}", work / name)
            for name in ("moe_ep", "collectives", "pipeline")}


# ------------------------------------------------------------------ MoE --
@pytest.fixture(scope="module")
def moe_ranks(jax_refs, tmp_path_factory):
    work = tmp_path_factory.mktemp("moe")
    ref_file = work / "ref.pkl"
    with open(ref_file, "wb") as f:
        pickle.dump(jax_refs["moe_ep"], f)
    return du.run_ranks("rank_moe_ep", 8, work / "ranks", ref_file=str(ref_file))


def _assembled(ranks, case, key="y"):
    """The (4, 16, d) whole of the ranks' outputs: data rank i holds rows
    2i, 2i + 1 (each model rank the same)."""
    per = [r[case][key] for r in ranks]
    for i in range(2):
        for j in range(1, 4):
            np.testing.assert_array_equal(per[4 * i + j], per[4 * i])
    return np.concatenate([per[0], per[4]])


@pytest.mark.parametrize("case", list(du.MOE_CAPACITY))
def test_moe_ep_matches_the_reference(jax_refs, moe_ranks, case):
    """The EP output equals the reference's EP output at every capacity; with
    no drops it also equals the single-program `moe_ffn`; the aux loss is
    the reference's EP aux (each rank's, averaged over the mesh).  At the
    tight capacity assignments drop per source rank, so the output differs
    from the single-program path's (whose capacity is over all tokens)."""
    ref = jax_refs["moe_ep"][case]
    got = _assembled(moe_ranks, case)
    assert all(r[case]["ep"] == 1.0 for r in moe_ranks)
    np.testing.assert_allclose(got, ref["ep"], **TOL)
    assert all(r[case]["aux"] == moe_ranks[0][case]["aux"] for r in moe_ranks)
    np.testing.assert_allclose(moe_ranks[0][case]["aux"], ref["aux_ep"], rtol=1e-5)
    single, _, _ = moe_ffn(params_from_jax(ref["params"], "cpu"), torch.from_numpy(ref["x"]),
                           du.moe_cut("torch", case))
    if case == "no_drops":
        assert all(r[case]["drops"] == 0 for r in moe_ranks)
        np.testing.assert_allclose(got, single.numpy(), **TOL)
        np.testing.assert_allclose(got, ref["single"], **TOL)
    elif case == "tight":
        assert all(r[case]["drops"] > 0 for r in moe_ranks)
        assert np.abs(got - single.numpy()).max() > 1e-3


def _whole_grads(ref, cfg):
    """Gradients, on the single-program path, of J1 = sum(y^2) / n_dp and
    of J2 = the mean over the (2, 4) mesh's token blocks of each block's
    aux loss (what the EP branch's aux is)."""
    params = params_from_jax(ref["params"], "cpu")
    leaves = [params["router"]["w"]] + [params["experts"][k]["w"]
                                        for k in sorted(params["experts"])]
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    y, _, _ = moe_ffn(params, x, cfg)
    g1 = torch.autograd.grad(y.square().sum() / 2, [x] + leaves)
    blocks = [x[2 * i:2 * i + 2, 4 * j:4 * j + 4].reshape(-1, x.shape[-1])
              for i in range(2) for j in range(4)]
    auxes = []
    for xb in blocks:
        logits, probs, _, ids = router_probs(params, xb, cfg)
        auxes.append(aux_losses(logits, probs, ids, cfg)[0])
    g2 = torch.autograd.grad(torch.stack(auxes).mean(), [x, leaves[0]])
    return g1, g2


def test_moe_ep_gradients_match_the_single_program_path(jax_refs, moe_ranks):
    """With no drops: the experts' gradients (mean over the data ranks)
    equal the whole objective's; the router's and the input's, averaged
    over the data ranks as the train step does, too; and the aux loss's
    gradients are those of the mean of the ranks' aux losses."""
    ref = jax_refs["moe_ep"]["no_drops"]
    cfg = du.moe_cut("torch", "no_drops")
    (gx, grouter, *gexp), (gx_aux, grouter_aux) = _whole_grads(ref, cfg)
    r = [m["no_drops"] for m in moe_ranks]
    for k, want in zip(sorted(r[0]["gexperts"]), gexp):
        for m in r:
            np.testing.assert_allclose(m["gexperts"][k], want.numpy(), **TOL)
    np.testing.assert_allclose((r[0]["grouter"] + r[4]["grouter"]) / 2, grouter.numpy(), **TOL)
    np.testing.assert_allclose(np.concatenate([r[0]["gx"], r[4]["gx"]]) / 2, gx.numpy(), **TOL)
    np.testing.assert_allclose((r[0]["grouter_aux"] + r[4]["grouter_aux"]) / 2,
                               grouter_aux.numpy(), **TOL)
    np.testing.assert_allclose(np.concatenate([r[0]["gx_aux"], r[4]["gx_aux"]]) / 2,
                               gx_aux.numpy(), **TOL)


def _single_program(ref, cfg):
    """The port's `moe_ffn` outside any context on the whole (4, 16, d)
    input: output, aux loss, drop fraction, and the gradients of sum(y^2)
    (input, router, experts) and of the aux loss (input, router)."""
    params = params_from_jax(ref["params"], "cpu")
    leaves = [params["router"]["w"]] + [params["experts"][k]["w"]
                                        for k in sorted(params["experts"])]
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    y, aux, metrics = moe_ffn(params, x, cfg)
    g = torch.autograd.grad(y.square().sum(), [x] + leaves, retain_graph=True)
    ga = torch.autograd.grad(aux, [x, leaves[0]])
    return y.detach(), float(aux), float(metrics["moe_drop_frac"]), g, ga


@pytest.mark.parametrize("case", list(du.MOE_CAPACITY))
def test_moe_single_program_path_on_a_mesh_is_over_the_whole_batch(jax_refs, moe_ranks, case):
    """Under the default strategy on a (2, 4) mesh each data rank holds half
    the rows, and the layer is the whole batch's, as the reference's (whose
    sharded run equals its single-program one): the capacity is the whole
    batch's and a rank's assignments queue after the earlier rows', so the
    outputs and the drops are the single-program path's; the mean over the
    data ranks of their aux losses is the whole batch's aux loss.  At the
    tight capacity assignments drop, and the outputs still agree."""
    ref = jax_refs["moe_ep"][case]
    np.testing.assert_allclose(ref["auto"], ref["single"], **TOL)
    got = _assembled(moe_ranks, case, "auto_y")
    np.testing.assert_allclose(got, ref["single"], **TOL)
    y, aux, drops, _, _ = _single_program(ref, du.moe_cut("torch", case))
    np.testing.assert_allclose(got, y.numpy(), **TOL)
    r0, r4 = moe_ranks[0][case], moe_ranks[4][case]
    np.testing.assert_allclose((r0["auto_aux"] + r4["auto_aux"]) / 2, ref["aux_single"],
                               rtol=1e-5)
    np.testing.assert_allclose((r0["auto_aux"] + r4["auto_aux"]) / 2, aux, rtol=1e-5)
    np.testing.assert_allclose((r0["auto_drops"] + r4["auto_drops"]) / 2, drops, atol=1e-7)
    assert all(r[case]["auto_ep"] == 0.0 for r in moe_ranks)
    if case == "tight":
        assert drops > 0


@pytest.mark.parametrize("case", ["default", "tight"])
def test_moe_single_program_path_on_a_mesh_has_the_whole_batchs_gradients(moe_ranks, jax_refs,
                                                                         case):
    """The gradients, averaged over the data ranks as the train step does,
    are the single-program path's on the whole batch: the input's rows and
    the router's of sum(y^2) as they are (each rank's outputs are its own
    rows), the experts' (a mean over the data ranks already) times 2; and
    the aux loss's, whose whole-batch value is the mean of the ranks'."""
    ref = jax_refs["moe_ep"][case]
    _, _, _, (gx, grouter, *gexp), (gx_aux, grouter_aux) = _single_program(
        ref, du.moe_cut("torch", case))
    r = [m[case] for m in moe_ranks]
    np.testing.assert_allclose(np.concatenate([r[0]["auto_gx"], r[4]["auto_gx"]]), gx.numpy(),
                               **TOL)
    np.testing.assert_allclose(r[0]["auto_grouter"] + r[4]["auto_grouter"], grouter.numpy(),
                               **TOL)
    for k, want in zip(sorted(r[0]["auto_gexperts"]), gexp):
        for m in r:
            np.testing.assert_allclose(2 * m["auto_gexperts"][k], want.numpy(), **TOL)
    np.testing.assert_allclose(np.concatenate([r[0]["auto_gx_aux"], r[4]["auto_gx_aux"]]) / 2,
                               gx_aux.numpy(), **TOL)
    np.testing.assert_allclose((r[0]["auto_grouter_aux"] + r[4]["auto_grouter_aux"]) / 2,
                               grouter_aux.numpy(), **TOL)


# ---------------------------------------------------------- collectives --
@pytest.fixture(scope="module", params=[2, 4])
def coll_ranks(request, tmp_path_factory):
    n = request.param
    return n, du.run_ranks("rank_collectives", n, tmp_path_factory.mktemp(f"coll{n}"))


def test_compressed_mean_of_a_replicated_input_matches_the_reference(jax_refs, coll_ranks):
    """Every rank holds the same x (the reference's layout): the port's mean
    and residual agree with the reference's within one int8 step."""
    n, ranks = coll_ranks
    same = du.collective_inputs(0)[0]
    for name in ("zero", "err"):
        want_m, want_e = jax_refs["collectives"][(n, name)]
        step = du.block_steps(same, n)
        for r in ranks:
            m, e = r[("same", name)]
            assert np.all(np.abs(m - want_m) <= step + 1e-7), (n, name)
            assert np.all(np.abs(e - want_e) <= step + 1e-7), (n, name)


def test_compressed_mean_of_distinct_inputs_and_its_residual(coll_ranks):
    du.check_compressed_mean(coll_ranks[1])


def test_error_feedback_converges_and_the_tree_api(coll_ranks):
    du.check_error_feedback(coll_ranks[1])


def test_compressed_mean_over_one_rank_returns_its_inputs():
    class OneRank:
        mesh_dim_names = ("pod", "data")

        def size(self, k):
            return 1

    x, e = torch.ones(3, 5), torch.zeros(3, 5)
    m, e1 = tcoll.compressed_psum_mean(x, e, OneRank(), "pod")
    assert m is x and e1 is e


# -------------------------------------------------------------- pipeline --
@pytest.fixture(scope="module")
def pipe_ranks(tmp_path_factory):
    return du.run_ranks("rank_pipeline", 8, tmp_path_factory.mktemp("pipe"))


def test_pipeline_outputs_match_the_unpipelined_run_and_the_reference(jax_refs, pipe_ranks):
    du.check_pipeline_outputs(pipe_ranks)
    for r in pipe_ranks:
        np.testing.assert_allclose(r["out"], jax_refs["pipeline"]["out"], atol=1e-5, rtol=1e-5)


def test_pipeline_gradients_match_the_unpipelined_run_and_the_reference(jax_refs, pipe_ranks):
    """Each stage's gradient equals the unpipelined run's gradient of its
    layers, and the reference's."""
    du.check_pipeline_gradients(pipe_ranks)
    for r in pipe_ranks:
        s = r["stage"]
        np.testing.assert_allclose(r["grad"][s], jax_refs["pipeline"]["grad"][s],
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("stages,micro", [(4, 6), (1, 4), (8, 1), (2, 30)])
def test_bubble_fraction_equals_the_reference(stages, micro):
    assert tpipe.bubble_fraction(stages, micro) == jpipe.bubble_fraction(stages, micro)


def test_stage_helpers_match_the_reference():
    parts = [{"w": torch.ones(2, 3) * i} for i in range(4)]
    assert tpipe.stack_stages(parts)["w"].shape == (4, 2, 3)
    layers = torch.arange(8 * 3.0).reshape(8, 3)
    np.testing.assert_array_equal(
        tpipe.split_layers_to_stages({"w": layers}, 4)["w"].numpy(),
        np.asarray(jpipe.split_layers_to_stages({"w": layers.numpy()}, 4)["w"]))
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.split_layers_to_stages(layers, 3)
