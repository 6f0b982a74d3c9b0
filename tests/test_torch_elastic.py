"""Elastic rescale in the port, on gloo ranks, against the JAX package.

The reference's scenario (tests/test_elastic_multidevice.py) on 8 ranks:
reduced granite-3-2b (vocab 64) trains 4 steps on a (4, 2) mesh from the
reference's initial state, saves, loses 4 ranks, is rescaled onto (2, 2)
by `ElasticSupervisor` and trains 3 more steps.  The losses agree with the
JAX package's unsharded run on the same batches (fp32; 1e-5 relative: the
ranks' parts of each reduction are summed in another order); every
restored leaf is bit for bit the saved one; the JAX package restores the
port's sharded checkpoint, and the port restores the JAX package's (4, 2)
checkpoint onto (2, 2) and onto (1, 1), bit for bit.  A dbrx cut trains
with Adafactor on (2, 2): with the default strategy, at its config's
capacity and aux losses, it agrees with the JAX package's run and its own
unsharded one; with the expert-parallel strategy, with its unsharded run
(1e-5 relative loss, 1e-4 relative gradient norm).  Each optimizer's
sharded update follows its unsharded one.  The checks against the port's
own unsharded runs are `torch_dist_util`'s ``check_*``, which
`tools/multi_gpu_check.py` runs on GPUs."""

import pickle

import numpy as np
import pytest

from repro.ckpt import restore as jrestore
from repro.train import make_optimizer as jmake_optimizer
from repro.train import state_shapes as jstate_shapes
from repro_torch.train import trainer as ttrainer

import torch_dist_util as du


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    work = tmp_path_factory.mktemp("jax")
    refs = du.run_jax("jax_training", work)
    for name, ref in refs.items():
        with open(work / f"{name}.pkl", "wb") as f:
            pickle.dump(ref, f)
    return work, refs


@pytest.fixture(scope="module")
def scenario(jax_refs, tmp_path_factory):
    work, refs = jax_refs
    return refs["elastic"], du.run_ranks("rank_elastic", 8, tmp_path_factory.mktemp("ranks"),
                                         ref_file=str(work / "elastic.pkl"))


def test_rescaled_job_follows_the_reference_losses(scenario):
    ref, ranks = scenario
    du.check_rescale_losses(ranks, ref["losses"])


def test_the_rescale_restores_every_leaf_bit_for_bit(scenario):
    _, ranks = scenario
    assert ranks[0]["shape"] == (2, 2)
    du.check_rescale_restores(ranks)


def test_the_jax_package_restores_the_ports_sharded_checkpoint(scenario):
    _, ranks = scenario
    cfg = du.granite_cut("jax")
    opt = jmake_optimizer("adamw", lr=1e-3)
    path = f"{ranks[0]['ckpt']}/step_{du.ELASTIC_SAVE:08d}"
    state = jrestore(path, jstate_shapes(cfg, opt))
    got = {p: np.asarray(a) for p, a in du.jax_flat(state).items()}
    saved = ranks[0]["saved"]
    assert list(got) == list(saved)
    for p in saved:
        assert got[p].tobytes() == saved[p].tobytes(), p


@pytest.mark.parametrize("mesh", ["2x2", "1x1"])
def test_the_port_restores_the_jax_packages_4x2_checkpoint(scenario, mesh):
    ref, ranks = scenario
    step, leaves = ranks[0][f"jax_on_{mesh}"]
    assert step == du.ELASTIC_SAVE
    assert list(leaves) == list(ref["saved"])
    for p, want in ref["saved"].items():
        assert leaves[p].tobytes() == want.tobytes(), p


@pytest.fixture(scope="module")
def training_cases(jax_refs, tmp_path_factory):
    work, _ = jax_refs
    return du.run_ranks("rank_training_cases", 4, tmp_path_factory.mktemp("train"), steps=3,
                        ref_file=str(work / "dbrx.pkl"))


@pytest.fixture(scope="module")
def dbrx_ep(training_cases):
    return [r["dbrx_ep"] for r in training_cases]


def test_a_dbrx_cut_trains_expert_parallel_as_its_unsharded_run(dbrx_ep):
    du.check_dbrx_ep(dbrx_ep)


def test_a_dbrx_cut_trains_on_a_mesh_as_the_jax_package_over_the_whole_batch(jax_refs,
                                                                             training_cases):
    """The default strategy, the config's capacity (assignments drop) and
    aux losses on (2, 2): each data rank routes half the batch, and the
    MoE layer's capacity, drops and load balance are the whole batch's, so
    the losses and gradient norms are the JAX package's unsharded run's
    (which its own sharded run equals) and the port's unsharded run's."""
    runs = [r["dbrx"] for r in training_cases]
    du.check_dbrx(runs)
    for r in runs:
        du.same_log(r["sharded"], jax_refs[1]["dbrx"]["log"])


@pytest.fixture(scope="module")
def optimizers(training_cases):
    return [r["optimizers"] for r in training_cases]


@pytest.mark.parametrize("name", du.OPTIMIZER_CASES)
def test_each_optimizer_trains_sharded_as_unsharded(optimizers, name):
    """`torch_dist_util.check_optimizer`: the parameters within a quarter
    of the learning rate of the unsharded run's, as tests/test_torch_train.py
    holds the port to the reference."""
    du.check_optimizer(optimizers, name)


def test_trainer_takes_a_device_mesh_and_refuses_anything_else():
    from repro_torch.data import pipeline as tdata
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    cfg = reduced(get_config("granite-3-2b"))
    data = tdata.SyntheticLM(tdata.DataConfig(vocab_size=cfg.vocab_size, global_batch=1,
                                              seq_len=8))
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttrainer.Trainer(cfg, ttrainer.TrainerConfig(), data, mesh=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        ttrainer.Trainer(cfg, ttrainer.TrainerConfig(), data,
                         strategy=ttrainer.ShardingStrategy(), device="cpu")
