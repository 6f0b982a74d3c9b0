"""The port's sharding rules against the reference's: for all ten configs,
the three optimizers and three meshes, the param, optimizer, state, batch
and cache specs equal the reference's `NamedSharding.spec` leaf for leaf;
the placements a spec gives; and, on 8 gloo ranks, each rank's shard of a
reduced granite state equals the reference's shard on the device of the
same index, bit for bit.

The reference's specs need a `jax.sharding.Mesh` of the right shape only:
its devices are the one CPU device repeated.  The port's state shapes come
from the reference's (as ``meta`` tensors) for the parameters, and from the
port's own optimizers for the optimizer state, whose leaf paths and shapes
must equal the reference's."""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import models as jmodels
from repro import train as jtrain
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.parallel import sharding as jsh
from repro_torch import models as tmodels
from repro_torch import train as ttrain
from repro_torch._tree import tree_items
from repro_torch.configs import get_config as tget_config
from repro_torch.parallel import sharding as tsh
from repro_torch.runtime.elastic import MeshPlan

import torch_dist_util as du

MESHES = {"1x1": ((1, 1), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OPTIMIZERS = ("adamw", "adafactor", "adam8bit")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32,
                 "int8": torch.int8}


def _jmesh(name):
    shape, names = MESHES[name]
    devs = np.array([jax.devices()[0]] * int(np.prod(shape)), dtype=object).reshape(shape)
    return Mesh(devs, names)


def _meta(tree):
    """A JAX shape tree as the port's ``meta`` tensors (lists for tuples)."""
    def leaf(s):
        return torch.empty(tuple(s.shape), dtype=_TORCH_DTYPES[str(s.dtype)], device="meta")
    return jax.tree.map(leaf, tree, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference param shapes, {optimizer: reference opt shapes})."""
    cfg = jget_config(arch)
    params = jax.eval_shape(lambda k: jmodels.init_lm(k, cfg), jax.random.PRNGKey(0))
    opts = {name: jax.eval_shape(jtrain.make_optimizer(name).init, params)
            for name in OPTIMIZERS}
    return params, opts


def _jspecs(tree):
    return {p: tuple(s.spec) for p, s in du.jax_flat(tree).items()}


def _tspecs(tree):
    return {p: tuple(s) for p, s in tree_items(tree, sep="/")}


def _same(got, want):
    assert list(got) == list(want)
    bad = {p: (got[p], want[p]) for p in got if got[p] != want[p]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_leaf_for_leaf(arch, mesh):
    jmesh, shape, names = _jmesh(mesh), *MESHES[mesh]
    tmesh = MeshPlan(shape, names)
    jstrat, tstrat = jsh.default_strategy(jmesh), tsh.default_strategy(tmesh)
    assert tuple(tstrat.dp) == tuple(jstrat.dp)
    jparams, jopts = _shapes(arch)
    tparams = _meta(jparams)
    tcfg = tget_config(arch)
    for name in OPTIMIZERS:
        tstate = {"params": tparams, "opt": ttrain.make_optimizer(name).init(tparams),
                  "step": torch.zeros((), dtype=torch.int32, device="meta")}
        jstate = {"params": jparams, "opt": jopts[name],
                  "step": jax.ShapeDtypeStruct((), jnp.int32)}
        got_shapes = {p: tuple(t.shape) for p, t in tree_items(tstate["opt"], sep="/")}
        want_shapes = {p: tuple(s.shape) for p, s in du.jax_flat(jstate["opt"]).items()}
        assert got_shapes == want_shapes, name
        _same(_tspecs(tsh.state_specs(tstate, tmesh, tstrat)),
              _jspecs(jsh.state_specs(jstate, jmesh, jstrat)))
    # Batches: tokens, and each family's extra inputs.
    B, S = 8, 64
    jbatch = {"inputs": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "targets": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "positions": jax.ShapeDtypeStruct((3, B, S), jnp.int32),
              "encoder_embeds": jax.ShapeDtypeStruct((B, 32, tcfg.d_model), jnp.float32)}
    _same(_tspecs(tsh.batch_specs(_meta(jbatch), tmesh, tstrat)),
          _jspecs(jsh.batch_specs(jbatch, jmesh, jstrat)))
    # Caches at batch 8 and at batch 1 (the sequence over every axis).
    jcfg = jget_config(arch)
    cross = 64 if jcfg.n_encoder_layers else 0
    for batch in (8, 1):
        jcache = jax.eval_shape(lambda: jmodels.init_cache(jcfg, batch, 256, cross_len=cross)
                                if cross else jmodels.init_cache(jcfg, batch, 256))
        tcache = tmodels.init_cache(tcfg, batch, 256, cross_len=cross, device="meta")
        _same(_tspecs(tsh.cache_specs(tcache, tmesh, tstrat, batch)),
              _jspecs(jsh.cache_specs(jcache, jmesh, jstrat, batch)))


def test_the_strategy_and_its_logical_axes_match_the_reference():
    for mesh in MESHES:
        j, t = jsh.default_strategy(_jmesh(mesh)), tsh.default_strategy(MeshPlan(*MESHES[mesh]))
        for logical in (None, "dp", "tp", "fsdp", "ep", "seq"):
            assert t.axis(logical) == j.axis(logical), (mesh, logical)
    assert tsh.ShardingStrategy(moe="ep_shardmap").moe == jsh.ShardingStrategy(
        moe="ep_shardmap").moe


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names, shape = ("pod", "data", "model"), (2, 2, 2)

    pl = tsh.placements(tsh.P(("pod", "data"), None, "model"), Mesh3)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(None, "data"), Mesh3) == (Replicate(), Shard(1), Replicate())
    assert tsh.placements(tsh.P(), Mesh3) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.placements(tsh.P(("data", "pod")), Mesh3)


@pytest.fixture(scope="module")
def state_shards(tmp_path_factory):
    work = tmp_path_factory.mktemp("shards")
    ref = du.run_jax("jax_state_shards", work / "jax")
    state_file = work / "state.pkl"
    with open(state_file, "wb") as f:
        pickle.dump(ref["state"], f)
    ranks = du.run_ranks("rank_state_shards", 8, work / "ranks", state_file=str(state_file))
    return ref, ranks


def test_each_rank_holds_the_reference_devices_shard(state_shards):
    """Rank r's local tensor of every state leaf is, bit for bit, what the
    reference puts on device r of the same (4, 2) mesh."""
    ref, ranks = state_shards
    ranks = [shards for shards, _ in ranks]
    assert set(ranks[0]) == set(ref["shards"])
    cut = 0
    for path, per_device in ref["shards"].items():
        for r in range(8):
            want, got = np.asarray(per_device[r]), ranks[r][path]
            assert got.shape == want.shape and got.dtype == want.dtype, (path, r)
            assert got.tobytes() == want.tobytes(), (path, r)
        cut += ranks[0][path].size < _whole_size(ref["state"], path)
    assert cut > 0          # some leaves are cut over the mesh


def _whole_size(state, path):
    node = state
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return np.asarray(node).size


def test_distribute_and_gather_keep_a_tree_on_one_rank(state_shards):
    """On a one-rank mesh (built by all 8 ranks, holding rank 0) the local
    tensors are the whole tensors, and a gathered tree equals the one
    distributed."""
    _, ranks = state_shards
    assert ranks[0][1] is True and all(r[1] is None for r in ranks[1:])


def test_the_context_checks_ranks_and_returns_its_input():
    """`constrain` returns its input (the port computes on local tensors)
    and keeps the reference's rank check inside a context; outside one,
    `constrain`, `constrain_like_params` and `gather_params` are no-ops."""
    from repro.parallel import context as jctx
    from repro_torch.parallel import context as tctx

    x = torch.ones(2, 3)
    tree = {"w": x}
    assert tctx.current() is None and tctx.constrain(x, ("dp",)) is x
    assert tctx.gather_params(tree) is tree and tctx.constrain_like_params(tree) is tree
    plan = MeshPlan(*MESHES["4x2"])
    with tctx.activation_sharding(plan, tsh.default_strategy(plan)):
        assert tctx.current()[0] is plan
        assert tctx.constrain(x, ("dp", "tp")) is x
        with pytest.raises(ValueError, match="rank mismatch"):
            tctx.constrain(x, ("dp",))
    jmesh = _jmesh("4x2")
    with jctx.activation_sharding(jmesh, jsh.default_strategy(jmesh)):
        with pytest.raises(ValueError, match="rank mismatch"):
            jctx.constrain(jnp.ones((2, 3)), ("dp",))
    assert tctx.current() is None
