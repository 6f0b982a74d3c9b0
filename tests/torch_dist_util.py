"""Multi-rank helpers of the port's tests, and of `tools/multi_gpu_check.py`.

`run_ranks` spawns ``world`` ranks in a subprocess with a time limit, so
that a hang fails instead of stalling the suite: gloo ranks (one thread
each) on the CPU, or NCCL ranks (one GPU each) with ``device_type="cuda"``.
Each rank calls one of the ``rank_*`` functions below and its result comes
back through a file.  `run_jax` runs one of the ``jax_*`` functions in a
subprocess whose JAX has 8 host devices, for the JAX package's multi-device
references.  The ``check_*`` functions hold the ranks' results against the
port's own unsharded runs (raising AssertionError); the tests call them
beside their checks against the JAX package, and the GPU tool calls them
alone.  Every function imports only what it uses: the ranks and the checks
import no JAX.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}",
               OMP_NUM_THREADS="1", **extra)
    return env


def _run(code, workdir, timeout, env):
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=timeout, cwd=str(workdir))
    if proc.returncode != 0:
        raise AssertionError(f"subprocess failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    return proc


def run_ranks(fn: str, world: int, workdir, timeout: float = 240, device_type: str = "cpu",
              **kw):
    """``fn(rank, world, workdir, device_type=device_type, **kw)`` on
    ``world`` ranks of ``device_type``; returns the list of the ranks'
    results."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "kw.json").write_text(json.dumps(dict(kw, device_type=device_type)))
    code = f"import torch_dist_util as u; u._spawn({fn!r}, {world}, {str(workdir)!r})"
    try:
        _run(code, workdir, timeout, _env())
    except AssertionError as e:
        errors = "".join(f"\nrank {p.stem[6:]}: {p.read_text()[-3000:]}"
                         for p in sorted(workdir.glob("error_*.txt")))
        raise AssertionError(f"{e}{errors}") from None
    out = []
    for r in range(world):
        with open(workdir / f"result_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def run_jax(fn: str, workdir, timeout: float = 300, **kw):
    """``fn(workdir, **kw)`` in a JAX with 8 host CPU devices; its result."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "kw.json").write_text(json.dumps(kw))
    code = f"import torch_dist_util as u; u._jax_main({fn!r}, {str(workdir)!r})"
    _run(code, workdir, timeout,
         _env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"))
    with open(workdir / "jax_result.pkl", "rb") as f:
        return pickle.load(f)


def _spawn(fn, world, workdir):
    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(fn, world, workdir), nprocs=world)


def _rank_main(rank, fn, world, workdir):
    import warnings

    import torch
    import torch.distributed as dist

    from repro_torch.runtime.elastic import backend_for

    warnings.simplefilter("ignore", FutureWarning)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False        # fp32 as on the CPU
    torch.backends.cudnn.allow_tf32 = False
    kw = json.loads((Path(workdir) / "kw.json").read_text())
    if kw["device_type"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    # A collective that waits longer than this for its peers fails the run.
    dist.init_process_group(backend_for(kw["device_type"]), init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=kw.pop("collective_timeout_s", 600)))
    try:
        result = globals()[fn](rank, world, Path(workdir), **kw)
    except BaseException:
        # Leave at once: tearing the group down would wait for the other
        # ranks, which wait in a collective for this one.
        (Path(workdir) / f"error_{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()
    with open(Path(workdir) / f"result_{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def _jax_main(fn, workdir):
    kw = json.loads((Path(workdir) / "kw.json").read_text())
    result = globals()[fn](Path(workdir), **kw)
    with open(Path(workdir) / "jax_result.pkl", "wb") as f:
        pickle.dump(result, f)


# ----------------------------------------------------------------- shared --
def granite_cut(pkg):
    """The reduced granite-3-2b (vocab 64) of the elastic scenarios, in the
    package ``pkg`` ("jax" or "torch")."""
    if pkg == "jax":
        from repro.configs import get_config
        from repro.models import reduced
    else:
        from repro_torch.configs import get_config
        from repro_torch.models import reduced
    return reduced(get_config("granite-3-2b"), vocab_size=64)


def batch_np(i):
    """The elastic scenario's batch of step ``i``: (8, 32) tokens."""
    t = np.random.default_rng(i).integers(0, 64, size=(8, 33)).astype(np.int32)
    return {"inputs": t[:, :-1], "targets": t[:, 1:]}


class Batches:
    """Step-indexed batches (`batch_np`) for the port's `Trainer`."""

    def batch_at(self, i):
        return batch_np(i)


def to_np(t):
    """A tensor of any device as a numpy array."""
    return t.detach().cpu().numpy()


def jax_flat(tree):
    """{"/"-joined leaf path: leaf} of a JAX tree (a NamedSharding or a
    ShapeDtypeStruct is a leaf)."""
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    key = lambda path: "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
    return {key(p): leaf for p, leaf in flat}


def bits(tree):
    """{path: raw bytes} of a port tree (bf16 leaves as int16), for
    bit-for-bit comparison."""
    import torch

    from repro_torch._tree import tree_items
    from repro_torch.parallel.comm import is_dtensor

    out = {}
    for p, t in tree_items(tree, sep="/"):
        t = (t.full_tensor() if is_dtensor(t) else t).detach().cpu()
        out[p] = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().copy()
    return out


# ------------------------------------------------------ sharding: shards --
def jax_state_shards(workdir):
    """Reduced granite's AdamW state, put on a (4, 2) mesh of the 8
    devices: the whole leaves and each device's shard of each leaf."""
    import jax
    from jax.sharding import Mesh

    from repro.parallel.sharding import default_strategy, state_specs
    from repro.train import init_state, make_optimizer, state_shapes

    cfg, opt = granite_cut("jax"), make_optimizer("adamw", lr=1e-3)
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    state = init_state(jax.random.PRNGKey(0), cfg, opt)
    specs = state_specs(state_shapes(cfg, opt), mesh, default_strategy(mesh))
    placed = jax.device_put(state, specs)
    shards = {p: {s.device.id: np.asarray(s.data) for s in a.addressable_shards}
              for p, a in jax_flat(placed).items()}
    return {"state": jax.tree.map(np.asarray, state), "shards": shards}


def rank_state_shards(rank, world, workdir, state_file, device_type):
    """Each rank's local shard of the reference's state, placed by the
    port's `state_specs` on a (4, 2) mesh."""
    from repro_torch._tree import tree_items
    from repro_torch.convert import state_from_jax
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, state_specs
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import make_optimizer, state_shapes

    mesh = MeshPlan((4, 2), ("data", "model")).build(device_type=device_type)
    with open(state_file, "rb") as f:
        state = state_from_jax(pickle.load(f), mesh_device(mesh))
    cfg, opt = granite_cut("torch"), make_optimizer("adamw", lr=1e-3)
    specs = state_specs(state_shapes(cfg, opt), mesh, default_strategy(mesh))
    placed = distribute_tree(state, specs, mesh)
    out = {p: to_np(t.to_local()) for p, t in tree_items(placed, sep="/")}
    one = MeshPlan((1, 1), ("data", "model")).build(devices=[0], device_type=device_type)
    return out, (_one_rank_roundtrip(one, cfg) if rank == 0 else None)


def _one_rank_roundtrip(mesh, cfg):
    """On a one-rank mesh each DTensor's local tensor is the whole tensor
    itself (same storage), and a gathered tree equals the one distributed."""
    import torch

    from repro_torch._tree import tree_items
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import (default_strategy, distribute_tree, gather_tree,
                                               state_specs)
    from repro_torch.train import init_state, make_optimizer

    device = mesh_device(mesh)
    state = init_state(torch.Generator(device).manual_seed(0), cfg, make_optimizer("adam8bit"),
                       device=device)
    placed = distribute_tree(state, state_specs(state, mesh, default_strategy(mesh)), mesh)
    whole = dict(tree_items(state))
    same_storage = all(t.to_local().data_ptr() == whole[p].data_ptr()
                       for p, t in tree_items(placed))
    back = dict(tree_items(gather_tree(placed)))
    return same_storage and all(torch.equal(back[p], whole[p]) for p in whole)


# ---------------------------------------------------------------- MoE EP --
MOE_CAPACITY = {"no_drops": None, "default": "config", "tight": 0.5}


def moe_cut(pkg, case):
    """The reference test's MoE cut (dbrx, d 64, ff 32, 4 experts, top 2)
    at the capacity of ``case``: "no_drops" high enough that nothing drops,
    "default" the config's, "tight" a factor of 0.5 (assignments drop)."""
    import dataclasses

    if pkg == "jax":
        from repro.configs import get_config
        from repro.models import reduced
    else:
        from repro_torch.configs import get_config
        from repro_torch.models import reduced
    cfg = reduced(get_config("dbrx-132b"), d_model=64, d_ff=32, n_experts=4, top_k=2)
    factor = MOE_CAPACITY[case]
    if factor == "config":
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k if factor is None else factor)


def jax_moe_ep(workdir):
    """The reference's MoE FFN on (4, 16, 64) tokens, single-program, and on
    a (2, 4) mesh both through its expert-parallel branch and through its
    default (``auto_spmd``) one, at each capacity of `MOE_CAPACITY`; its
    params and input."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.models.moe import init_moe, moe_ffn
    from repro.parallel.context import activation_sharding
    from repro.parallel.sharding import ShardingStrategy

    out = {}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    strat = ShardingStrategy(dp=("data",), tp="model", fsdp="data", ep="model",
                             moe="ep_shardmap")
    auto = ShardingStrategy(dp=("data",), tp="model", fsdp="data", ep="model")
    for case in MOE_CAPACITY:
        cfg = moe_cut("jax", case)
        key = jax.random.PRNGKey(0)
        params = init_moe(key, cfg, jnp.float32)
        x = jax.random.normal(jax.random.fold_in(key, 1), (4, 16, cfg.d_model))
        ref, aux_ref, _ = moe_ffn(params, x, cfg)
        put = lambda a, *spec: jax.device_put(a, NamedSharding(mesh, P(*spec)))
        ew = params["experts"]
        ps = {"router": params["router"],
              "experts": {"w_gate": {"w": put(ew["w_gate"]["w"], "model", "data", None)},
                          "w_up": {"w": put(ew["w_up"]["w"], "model", "data", None)},
                          "w_down": {"w": put(ew["w_down"]["w"], "model", None, "data")}}}
        with mesh, activation_sharding(mesh, strat):
            ep, aux_ep, meta = jax.jit(lambda p, x: moe_ffn(p, x, cfg))(
                ps, put(x, "data", None, None))
        assert "moe_ep" in meta
        with mesh, activation_sharding(mesh, auto):
            whole, _, meta = jax.jit(lambda p, x: moe_ffn(p, x, cfg))(
                ps, put(x, "data", None, None))
        assert "moe_ep" not in meta
        out[case] = dict(params=jax.tree.map(np.asarray, params), x=np.asarray(x),
                         single=np.asarray(ref), aux_single=float(aux_ref),
                         ep=np.asarray(ep), aux_ep=float(aux_ep), auto=np.asarray(whole))
    return out


def rank_moe_ep(rank, world, workdir, ref_file, device_type):
    """The port's `moe_ffn` on a (2, 4) mesh, each rank holding its data
    rank's (2, 16, 64) rows: under an ``ep_shardmap`` context each rank's
    output and aux loss, and (no drops) the gradients of sum(y^2) and of
    the aux loss, each separately; and the same under the default
    strategy (the single-program path, ``auto_*``), at every capacity."""
    import torch

    from repro_torch.convert import params_from_jax
    from repro_torch.models.moe import moe_ffn
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.context import activation_sharding
    from repro_torch.parallel.sharding import ShardingStrategy, distribute_tree, param_specs
    from repro_torch.runtime.elastic import MeshPlan

    with open(ref_file, "rb") as f:
        ref = pickle.load(f)
    mesh = MeshPlan((2, 4), ("data", "model")).build(device_type=device_type)
    device = mesh_device(mesh)
    i = mesh.get_local_rank(0)
    out = {}
    for case in MOE_CAPACITY:
        cfg = moe_cut("torch", case)
        got = {}
        for prefix, strat in (("", ShardingStrategy(dp=("data",), moe="ep_shardmap")),
                              ("auto_", ShardingStrategy(dp=("data",)))):
            whole = params_from_jax(ref[case]["params"], device)
            specs = param_specs({"moe": whole}, mesh, strat)["moe"]["experts"]
            experts = distribute_tree(whole["experts"], specs, mesh)
            leaves = {k: v["w"].detach().requires_grad_(True) for k, v in experts.items()}
            router = whole["router"]["w"].requires_grad_(True)
            params = {"router": {"w": router},
                      "experts": {k: {"w": v} for k, v in leaves.items()}}
            x = torch.from_numpy(ref[case]["x"][2 * i:2 * i + 2]).to(device).requires_grad_(True)
            with activation_sharding(mesh, strat):
                y, aux, metrics = moe_ffn(params, x, cfg)
                got.update({prefix + "y": to_np(y), prefix + "aux": float(aux),
                            prefix + "ep": float(metrics.get("moe_ep", 0.0)),
                            prefix + "drops": float(metrics["moe_drop_frac"])})
                if case == "no_drops" or prefix:
                    names = sorted(leaves)
                    g = torch.autograd.grad(y.square().sum(),
                                            [x, router] + [leaves[k] for k in names],
                                            retain_graph=True)
                    ga = torch.autograd.grad(aux, [x, router])
                    got.update({prefix + "gx": to_np(g[0]), prefix + "grouter": to_np(g[1]),
                                prefix + "gexperts": {k: to_np(t.full_tensor())
                                                      for k, t in zip(names, g[2:])},
                                prefix + "gx_aux": to_np(ga[0]),
                                prefix + "grouter_aux": to_np(ga[1])})
        out[case] = got
    return out


# ------------------------------------------------------------ collectives --
def collective_inputs(rank):
    """(x replicated on every rank, x of this rank, err) of the tests."""
    rng = np.random.default_rng(0)
    same = rng.normal(size=(33, 70)).astype(np.float32)
    mine = np.random.default_rng(100 + rank).normal(size=(33, 70)).astype(np.float32)
    err = (np.random.default_rng(200 + rank).normal(size=(33, 70)) * 1e-3).astype(np.float32)
    return same, mine, err


def jax_collectives(workdir):
    """The reference's compressed mean of the replicated input over a
    "pod" axis of 2 and of 4 (the rest of the 8 devices on "data"), from a
    zero error and from a given one."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.parallel.collectives import compressed_psum_mean

    same, _, err = collective_inputs(0)
    out = {}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()).reshape(n, 8 // n), ("pod", "data"))
        f = jax.jit(lambda x, e: compressed_psum_mean(x, e, mesh, "pod"))
        for name, e in (("zero", np.zeros_like(same)), ("err", err)):
            m, e1 = f(jnp.asarray(same), jnp.asarray(e))
            out[(n, name)] = (np.asarray(m), np.asarray(e1))
    return out


def rank_collectives(rank, world, workdir, device_type):
    """The port's compressed mean over a "pod" axis of ``world`` ranks: of
    the replicated input (from a zero error and from rank 0's error), of
    each rank's own input, twenty error-feedback steps of it, and the tree
    API."""
    import torch

    from repro_torch.parallel.collectives import (compressed_psum_mean, init_error_feedback,
                                                  pod_sync_grads)
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.runtime.elastic import MeshPlan

    mesh = MeshPlan((world,), ("pod",)).build(device_type=device_type)
    on = lambda a: torch.from_numpy(a).to(mesh_device(mesh))
    same, mine, err = (on(a) for a in collective_inputs(rank))
    err0 = on(collective_inputs(0)[2])
    out = {}
    for name, e in (("zero", torch.zeros_like(same)), ("err", err0)):
        m, e1 = compressed_psum_mean(same, e, mesh, "pod")
        out[("same", name)] = (to_np(m), to_np(e1))
    m, e1 = compressed_psum_mean(mine, err, mesh, "pod")
    out["mine"] = (to_np(mine), to_np(err), to_np(m), to_np(e1),
                   to_np(_residual(mine + err, world)))
    acc, e = torch.zeros_like(mine), torch.zeros_like(mine)
    for _ in range(20):
        m, e = compressed_psum_mean(mine, e, mesh, "pod")
        acc += m
    out["running_mean"] = to_np(acc / 20)
    grads = {"a": mine, "b": [on(np.random.default_rng(rank).normal(size=(257,))
                                 .astype(np.float32))]}
    g, e = pod_sync_grads(grads, init_error_feedback(grads), mesh, "pod")
    out["tree"] = (sorted(g), to_np(g["a"]), to_np(g["b"][0]), to_np(e["b"][0]))
    return out


def _residual(y, n):
    """y - dequant(quant(y)), y's chunks quantized as the compressed mean
    does (n chunks, blocks of 256), on y's device: its arithmetic is the
    device's (a GPU divides by a scalar through its reciprocal)."""
    import torch

    from repro_torch.parallel import collectives as tcoll

    flat = torch.nn.functional.pad(y.reshape(-1), (0, (-y.numel()) % (n * tcoll._BLOCK)))
    q, scale = tcoll._quantize(flat.reshape(n, -1))
    return y - tcoll._dequantize(q, scale, (flat.numel(),))[: y.numel()].reshape(y.shape)


def block_steps(x, n):
    """Each element's int8 step (its block's scale) when ``x``'s chunks are
    quantized as the compressed mean does (n chunks, blocks of 256)."""
    import torch

    from repro_torch.parallel import collectives as tcoll

    flat = torch.from_numpy(x).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % (n * tcoll._BLOCK)))
    _, scale = tcoll._quantize(flat.reshape(n, -1))
    return scale.expand(-1, tcoll._BLOCK).reshape(-1)[: x.size].reshape(x.shape).numpy()


def check_compressed_mean(ranks):
    """Each rank's own x: every rank gets the same mean, within one int8
    step of each block of the exact mean of (x + err); and the residual is
    exactly x + err - dequant(quant(x + err)), recomputed on the rank."""
    n = len(ranks)
    means = [r["mine"][2] for r in ranks]
    for m in means[1:]:
        np.testing.assert_array_equal(m, means[0])
    ys = [r["mine"][0] + r["mine"][1] for r in ranks]
    exact = np.mean(ys, axis=0)
    steps = np.max([block_steps(y, n) for y in ys], axis=0)
    assert np.all(np.abs(means[0] - exact) <= steps), np.abs(means[0] - exact).max()
    for r in ranks:
        _, _, _, new_err, residual = r["mine"]
        np.testing.assert_array_equal(new_err, residual)
        assert np.abs(new_err).max() > 0


def check_error_feedback(ranks):
    """Twenty steps of the same inputs with error feedback: the running mean
    lies within half an int8 step of the exact mean (error does not
    accumulate); `pod_sync_grads` keeps the tree."""
    exact = np.mean([r["mine"][0] for r in ranks], axis=0)
    q_res = max(np.abs(r["mine"][0]).max() for r in ranks) / 127.0
    drift = np.abs(ranks[0]["running_mean"] - exact).max()
    assert drift < 0.5 * q_res, (drift, q_res)
    keys, a, b, eb = ranks[0]["tree"]
    assert keys == ["a", "b"] and a.shape == (33, 70) and b.shape == (257,)
    assert all(np.array_equal(r["tree"][2], b) for r in ranks)
    assert np.abs(eb).max() > 0


# --------------------------------------------------------------- pipeline --
PIPE = dict(L=8, S=4, M=6, B=4, D=16)


def pipe_inputs():
    rng = np.random.default_rng(0)
    L, M, B, D = PIPE["L"], PIPE["M"], PIPE["B"], PIPE["D"]
    layers = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    x = rng.normal(size=(M, B, D)).astype(np.float32)
    tgt = rng.normal(size=(M, B, D)).astype(np.float32)
    return layers, x, tgt


def jax_pipeline(workdir):
    """The reference's pipeline on a (4, 2) ("pod", "data") mesh: outputs
    and the gradient of the mean squared error against ``tgt``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.parallel.pipeline import pipeline_apply, split_layers_to_stages

    layers, x, tgt = (jnp.asarray(a) for a in pipe_inputs())
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("pod", "data"))
    stage = split_layers_to_stages(layers, PIPE["S"])

    def stage_fn(w, h):
        for i in range(w.shape[0]):
            h = jnp.tanh(h @ w[i])
        return h

    run = lambda p: pipeline_apply(p, x, stage_fn, mesh, "pod", "data")
    out = jax.jit(run)(stage)
    grad = jax.jit(jax.grad(lambda p: jnp.mean((run(p) - tgt) ** 2)))(stage)
    return {"out": np.asarray(out), "grad": np.asarray(grad)}


def rank_pipeline(rank, world, workdir, device_type):
    """The port's pipeline of `PIPE`'s 4 stages on a (4, world / 4)
    ("pod", "data") mesh: the outputs on this rank, and the gradient of
    the same loss for this rank's stage, summed over the data ranks (each
    ran its part of the batch)."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.pipeline import pipeline_apply, split_layers_to_stages
    from repro_torch.runtime.elastic import MeshPlan

    mesh = MeshPlan((PIPE["S"], world // PIPE["S"]), ("pod", "data")).build(
        device_type=device_type)
    layers, x, tgt = (torch.from_numpy(a).to(mesh_device(mesh)) for a in pipe_inputs())
    stage = split_layers_to_stages(layers, PIPE["S"]).requires_grad_(True)

    def stage_fn(w, h):
        for i in range(w.shape[0]):
            h = torch.tanh(h @ w[i])
        return h

    out = pipeline_apply(stage, x, stage_fn, mesh, "pod", "data")
    torch.mean((out - tgt) ** 2).backward()
    grad = stage.grad.clone()
    if mesh.size(1) > 1:
        dist.all_reduce(grad, group=mesh.get_group(1))
    return {"out": to_np(out), "stage": mesh.get_local_rank(0), "grad": to_np(grad)}


def unpipelined():
    """The pipeline's layers run in one piece on the CPU: the outputs, and
    the gradient of the same loss cut into the stages' parts."""
    import torch

    layers, x, tgt = (torch.from_numpy(a) for a in pipe_inputs())
    layers.requires_grad_(True)
    h = x.reshape(-1, x.shape[-1])
    for i in range(layers.shape[0]):
        h = torch.tanh(h @ layers[i])
    out = h.reshape(x.shape)
    torch.mean((out - tgt) ** 2).backward()
    S = PIPE["S"]
    return out.detach().numpy(), layers.grad.reshape(S, -1, *layers.shape[1:]).numpy()


def check_pipeline_outputs(ranks):
    """Every rank's outputs equal the unpipelined run's (1e-5)."""
    want = unpipelined()[0]
    for r in ranks:
        np.testing.assert_allclose(r["out"], want, atol=1e-5, rtol=1e-5)


def check_pipeline_gradients(ranks):
    """Each stage's gradient (only its own slice is nonzero) equals the
    unpipelined run's gradient of its layers (1e-5 absolute, 1e-4
    relative), and every stage ran."""
    want_grad = unpipelined()[1]
    for r in ranks:
        s = r["stage"]
        others = [k for k in range(PIPE["S"]) if k != s]
        assert np.abs(r["grad"][others]).max() == 0
        np.testing.assert_allclose(r["grad"][s], want_grad[s], atol=1e-5, rtol=1e-4)
    assert sorted({r["stage"] for r in ranks}) == list(range(PIPE["S"]))


# ---------------------------------------------------------------- elastic --
ELASTIC_STEPS, ELASTIC_SAVE = 7, 4


def jax_training(workdir):
    """The reference's sides of `rank_elastic` and `rank_dbrx`, in one
    subprocess."""
    return {"elastic": jax_elastic(workdir), "dbrx": jax_dbrx()}


def jax_elastic(workdir):
    """The reference's side of the rescale scenario: the initial state, the
    unsharded run's losses over every step, and a checkpoint of step 4
    saved from a (4, 2) mesh with its whole leaves."""
    import jax
    from jax.sharding import Mesh

    from repro.ckpt import save
    from repro.parallel.context import activation_sharding
    from repro.parallel.sharding import default_strategy, state_specs
    from repro.train import init_state, make_optimizer, make_train_step, state_shapes

    cfg, opt = granite_cut("jax"), make_optimizer("adamw", lr=1e-3)
    step_fn = make_train_step(cfg, opt)
    state0 = init_state(jax.random.PRNGKey(0), cfg, opt)
    jit_step = jax.jit(step_fn)
    state, losses = state0, []
    for i in range(ELASTIC_STEPS):
        state, m = jit_step(state, batch_np(i))
        losses.append(float(m["loss"]))
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    strat = default_strategy(mesh)
    specs = state_specs(state_shapes(cfg, opt), mesh, strat)
    sharded = jax.jit(step_fn, in_shardings=(specs, None), out_shardings=(specs, None))
    state = jax.device_put(state0, specs)
    with mesh, activation_sharding(mesh, strat):
        for i in range(ELASTIC_SAVE):
            state, m = sharded(state, batch_np(i))
    ckpt = workdir / "ckpt"
    ckpt.mkdir()
    save(str(ckpt), ELASTIC_SAVE, state, extra={"step": ELASTIC_SAVE})
    return {"state0": jax.tree.map(np.asarray, state0), "losses": losses, "ckpt": str(ckpt),
            "saved": {p: np.asarray(a) for p, a in jax_flat(state).items()}}


def rank_elastic(rank, world, workdir, device_type, ref_file=None):
    """The port's side on ``world`` ranks: train on (world / 2, 2) from the
    reference's initial state (from the port's seed 0 without
    ``ref_file``), save at step 4 (every rank gathers, one writes), lose
    half the ranks, rescale onto (world / 4, 2) through
    `ElasticSupervisor`, check every restored leaf, train 3 more steps.
    With ``ref_file``, also restore the reference's (4, 2) checkpoint onto
    (2, 2) and onto (1, 1); without it, rank 0 also runs the whole job
    unsharded (``plain_losses``)."""
    import torch

    from repro_torch.convert import state_from_jax
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, state_specs
    from repro_torch.runtime.elastic import ElasticSupervisor, MeshPlan, reshard_restore
    from repro_torch.train import (Trainer, TrainerConfig, init_state, make_optimizer,
                                   state_shapes)

    ref = None
    if ref_file is not None:
        with open(ref_file, "rb") as f:
            ref = pickle.load(f)
    cfg, opt = granite_cut("torch"), make_optimizer("adamw", lr=1e-3)
    plan = MeshPlan((world // 2, 2), ("data", "model"))
    mesh = plan.build(device_type=device_type)
    device = mesh_device(mesh)

    def fresh():
        if ref is not None:
            return state_from_jax(ref["state0"], device)
        return init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)

    specs = state_specs(state_shapes(cfg, opt), mesh, default_strategy(mesh))
    state = distribute_tree(fresh(), specs, mesh)
    tcfg = lambda steps, **kw: TrainerConfig(steps=steps, log_every=10 ** 9, **kw)
    ckpt = workdir / "ckpt"
    # The trainer's checkpoint manager saves at the end (step 4).
    first = Trainer(cfg, tcfg(ELASTIC_SAVE, ckpt_dir=str(ckpt), ckpt_every=10 ** 9),
                    Batches(), mesh=mesh, optimizer=opt)
    state = first.run(state=state)
    saved = bits(state)
    out = {"losses": [r["loss"] for r in first.metrics_log], "ckpt": str(ckpt),
           "saved": saved if rank == 0 else None}

    sup = ElasticSupervisor(str(ckpt), cfg, opt, plan, device_type=device_type)
    state2, step, mesh2, strat2 = sup.rescale(n_lost_devices=world // 2)
    out.update(step=step, shape=tuple(mesh2.shape), in_mesh=state2 is not None,
               rescales=sup.rescales)
    if state2 is not None:
        restored = bits(state2)
        out["restored_equal"] = _same_bits(restored, saved)
        out["local_shapes"] = {p: tuple(t.to_local().shape)
                               for p, t in _items(state2["params"])}
        again = Trainer(cfg, tcfg(ELASTIC_STEPS), Batches(), mesh=mesh2, strategy=strat2,
                        optimizer=opt)
        again.run(state=state2, start_step=step)
        out["losses"] += [r["loss"] for r in again.metrics_log]
        if ref is not None:
            jstate, jstep, _ = reshard_restore(ref["ckpt"], cfg, opt, mesh2)
            jbits = bits(jstate)               # every rank of the mesh gathers
            out["jax_on_2x2"] = (jstep, jbits if rank == 0 else None)
    if ref is not None:
        one = MeshPlan((1, 1), ("data", "model")).build(devices=[0], device_type=device_type)
        if rank == 0:
            jstate, jstep, _ = reshard_restore(ref["ckpt"], cfg, opt, one)
            out["jax_on_1x1"] = (jstep, bits(jstate))
    elif rank == 0:
        plain = Trainer(cfg, tcfg(ELASTIC_STEPS), Batches(), optimizer=opt, device=device)
        plain.run(state=fresh())
        out["plain_losses"] = [r["loss"] for r in plain.metrics_log]
    return out


def check_rescale_losses(ranks, want_losses):
    """The rescale scenario's losses against ``want_losses`` (the whole
    job's, 1e-5 relative: the ranks' parts of each reduction are summed in
    another order): the survivors trained every step, the lost ranks the
    first 4."""
    kept = len(ranks) // 2
    for r in ranks[:kept]:
        assert len(r["losses"]) == ELASTIC_STEPS
        np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5)
    for r in ranks[kept:]:
        np.testing.assert_allclose(r["losses"], want_losses[:ELASTIC_SAVE], rtol=1e-5)


def check_rescale_restores(ranks):
    """Every rank rescaled at step 4 onto (world / 4, 2), the survivors
    restored every leaf bit for bit, and an FFN weight (L, d, ff) is cut to
    (L, d / (world / 4), ff / 2) on each survivor."""
    world = len(ranks)
    kept, shape = world // 2, (world // 4, 2)
    for r in ranks:
        assert r["step"] == ELASTIC_SAVE and r["shape"] == shape
        assert r["rescales"] == [(ELASTIC_SAVE, shape)]
    assert [r["in_mesh"] for r in ranks] == [True] * kept + [False] * kept
    assert all(r["restored_equal"] for r in ranks[:kept])
    w = "blocks/pos0/ffn/w_gate/w"
    whole = ranks[0]["saved"][f"params/{w}"].shape
    assert ranks[0]["local_shapes"][w] == (whole[0], whole[1] // shape[0], whole[2] // 2)


def rank_live_bridge(rank, world, workdir, device_type):
    """The port's twin of the reference's live-bridge smoke
    (tests/test_elastic_bridge.py::test_live_backend_multidevice_bridge) on
    ``world`` ranks: reduced granite trains 4 steps on (world / 2, 2) from
    the port's seed 0 on a pod of ``world`` chips; a planner `Move` onto a
    pod of world / 2 chips goes through `LiveElasticBackend`.  First its
    destination dies after the snapshot: `rollback` re-installs the source
    checkpoint on the source mesh.  Then `execute_move`: snapshot -> mesh
    resize to (world / 4, 2) -> `reshard_restore`, and 3 more steps."""
    import dataclasses

    import torch

    from repro_torch.core.cluster import JobSpec, PodSpec, build_fleet_topology
    from repro_torch.core.migration import Move
    from repro_torch.core.placement import PlacementEngine
    from repro_torch.fleet.elastic_bridge import LiveElasticBackend, execute_move
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, state_specs
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import Trainer, TrainerConfig, init_state, make_optimizer, state_shapes

    cfg, opt = granite_cut("torch"), make_optimizer("adamw", lr=1e-3)
    plan = MeshPlan((world // 2, 2), ("data", "model"))
    mesh = plan.build(device_type=device_type)
    device = mesh_device(mesh)
    specs = state_specs(state_shapes(cfg, opt), mesh, default_strategy(mesh))
    state = init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)
    tcfg = lambda steps: TrainerConfig(steps=steps, log_every=10 ** 9)
    first = Trainer(cfg, tcfg(ELASTIC_SAVE), Batches(), mesh=mesh, optimizer=opt)
    state = first.run(state=distribute_tree(state, specs, mesh))
    saved = bits(state)

    pods = [PodSpec("big", world, 1.2), PodSpec("small", world // 2, 0.5)]
    engine = PlacementEngine(build_fleet_topology(pods), all_sites=True)
    req = JobSpec(0, "granite", "t", chips=world // 2, step_time_s=1.0, step_slo_s=None,
                  budget_usd_month=10 ** 9).request()
    old = next(c for c in engine.enumerate_feasible(req) if c.node.site_id == "big")
    engine.commit(req, old)
    new = next(c for c in engine.enumerate_feasible(req) if c.node.site_id == "small")
    mv = Move(0, old, new, 1.0)

    ckpt = workdir / "ckpt"
    ckpt.mkdir(exist_ok=True)
    backend = LiveElasticBackend()
    backend.register_job(0, str(ckpt), cfg, opt, plan, device_type=device_type)
    backend.update_state(0, state, step=ELASTIC_SAVE)
    snap = backend.snapshot(req, mv, 0.0)
    backend.rollback(req, mv, snap, 1.0)
    back = backend.resumed[0]
    out = {"snapshot": (snap.nbytes, snap.n_shards, snap.mesh_shape, snap.path is not None),
           "rollback": (back.plan.shape, tuple(back.mesh.shape), back.step,
                        _same_bits(bits(back.state), saved))}
    phases = execute_move(backend, req, mv)
    resumed = backend.resumed[0]
    out.update(phases=dataclasses.asdict(phases), shape=resumed.plan.shape,
               mesh_shape=tuple(resumed.mesh.shape), step=resumed.step,
               in_mesh=resumed.state is not None, losses=[])
    if resumed.state is not None:
        out["restored_equal"] = _same_bits(bits(resumed.state), saved)
        again = Trainer(cfg, tcfg(ELASTIC_SAVE + 3), Batches(), mesh=resumed.mesh,
                        strategy=resumed.strategy, optimizer=opt)
        again.run(state=resumed.state, start_step=resumed.step)
        out["losses"] = [r["loss"] for r in again.metrics_log]
    return out


def _same_bits(a, b):
    return list(a) == list(b) and all(a[p].tobytes() == b[p].tobytes() for p in a)


def _items(tree):
    from repro_torch._tree import tree_items
    return tree_items(tree, sep="/")


# --------------------------------------------------------------- training --
OPTIMIZER_CASES = ("adamw", "adafactor", "adam8bit", "adamw_microbatch2")
DBRX_STEPS = 3


def rank_training_cases(rank, world, workdir, steps, device_type, ref_file=None):
    """`rank_optimizers`, `rank_dbrx_ep` and `rank_dbrx` in one run of 4
    ranks (``ref_file``: `jax_dbrx`'s result)."""
    return {"optimizers": rank_optimizers(rank, world, workdir, steps, device_type),
            "dbrx_ep": rank_dbrx_ep(rank, world, workdir, steps, device_type),
            "dbrx": rank_dbrx(rank, world, workdir, device_type, ref_file)}


def dbrx_cut(pkg):
    """A dbrx cut (vocab 64, Adafactor) at its config's capacity factor and
    aux losses, in the package ``pkg``."""
    if pkg == "jax":
        from repro.configs import get_config
        from repro.models import reduced
    else:
        from repro_torch.configs import get_config
        from repro_torch.models import reduced
    return reduced(get_config("dbrx-132b"), vocab_size=64)


def jax_dbrx():
    """The reference's dbrx cut trained unsharded on `batch_np`'s batches
    (its default strategy on a mesh computes the same: the MoE layer is
    over the whole batch): the initial state, losses and gradient norms."""
    import jax

    from repro.train import init_state, make_optimizer, make_train_step

    cfg, opt = dbrx_cut("jax"), make_optimizer("adafactor", lr=1e-3)
    state0 = init_state(jax.random.PRNGKey(0), cfg, opt)
    step = jax.jit(make_train_step(cfg, opt))
    state, log = state0, []
    for i in range(DBRX_STEPS):
        state, m = step(state, batch_np(i))
        log.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    return {"state0": jax.tree.map(np.asarray, state0), "log": log}


def rank_dbrx(rank, world, workdir, device_type, ref_file=None):
    """The dbrx cut (`dbrx_cut`: the config's capacity, so that assignments
    drop, and its aux losses) trained on a (2, 2) mesh with the default
    strategy (the single-program MoE path, over the whole batch) on
    `batch_np`'s batches, from the reference's initial state (the port's
    seed 0 without ``ref_file``); on rank 0 also unsharded."""
    import torch

    from repro_torch.convert import state_from_jax
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, state_specs
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import (Trainer, TrainerConfig, init_state, make_optimizer,
                                   state_shapes)

    cfg, opt = dbrx_cut("torch"), make_optimizer("adafactor", lr=1e-3)
    mesh = MeshPlan((2, 2), ("data", "model")).build(device_type=device_type)
    device = mesh_device(mesh)

    def fresh():
        if ref_file is not None:
            with open(ref_file, "rb") as f:
                return state_from_jax(pickle.load(f)["state0"], device)
        return init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)

    tcfg = TrainerConfig(steps=DBRX_STEPS, log_every=10 ** 9)
    specs = state_specs(state_shapes(cfg, opt), mesh, default_strategy(mesh))
    sharded = Trainer(cfg, tcfg, Batches(), mesh=mesh, optimizer=opt)
    sharded.run(state=distribute_tree(fresh(), specs, mesh))
    out = {"sharded": sharded.metrics_log}
    if rank == 0:
        plain = Trainer(cfg, tcfg, Batches(), optimizer=opt, device=device)
        plain.run(state=fresh())
        out["plain"] = plain.metrics_log
    return out


def same_log(got, want):
    """Losses 1e-5 and gradient norms 1e-4 relative, step by step."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)


def check_dbrx(results):
    """Every rank's sharded run of `rank_dbrx` follows the unsharded one."""
    for r in results:
        same_log(r["sharded"], results[0]["plain"])


def rank_dbrx_ep(rank, world, workdir, steps, device_type):
    """A dbrx cut (Adafactor) trained on a (2, 2) mesh with the
    expert-parallel strategy, and, on rank 0, the same run unsharded.  No
    assignment drops and the aux loss is off: the EP branch's capacity is
    per source rank and its aux is a mean of the ranks' aux losses (as the
    reference's), not the whole batch's."""
    import dataclasses

    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import default_strategy
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import TrainerConfig, make_synthetic_trainer

    cfg = dbrx_cut("torch")
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k,
                              aux_loss_coef=0.0, router_z_loss=0.0)
    assert cfg.optimizer == "adafactor"
    mesh = MeshPlan((2, 2), ("data", "model")).build(device_type=device_type)
    strat = dataclasses.replace(default_strategy(mesh), moe="ep_shardmap")
    tcfg = TrainerConfig(steps=steps, log_every=10 ** 9)
    ep = make_synthetic_trainer(cfg, tcfg, 8, 16, mesh=mesh, strategy=strat)
    state = ep.run()
    out = {"ep": ep.metrics_log, "experts_local": tuple(
        state["params"]["blocks"]["pos0"]["moe"]["experts"]["w_gate"]["w"].to_local().shape)}
    if rank == 0:
        plain = make_synthetic_trainer(cfg, tcfg, 8, 16, device=mesh_device(mesh))
        plain.run()
        out["plain"] = plain.metrics_log
    return out


def check_dbrx_ep(results):
    """Every rank's expert-parallel run follows the unsharded one, and the
    experts (E, d, ff) of a layer are cut E over "model", d over "data"."""
    for r in results:
        assert [m["step"] for m in r["ep"]] == list(range(len(results[0]["plain"])))
        same_log(r["ep"], results[0]["plain"])
    layers, E, d, ff = results[0]["experts_local"]
    assert (E, d) == (2, 64) and ff == 256


def rank_trainer_on_a_mesh(rank, world, workdir, device_type):
    """A `Trainer` on a one-rank mesh; its state saved by `ckpt.save` (a
    sharded tree) and restored into the mesh's placements."""
    from repro_torch.ckpt import restore, save
    from repro_torch.parallel.comm import is_dtensor
    from repro_torch.parallel.sharding import layouts, state_specs
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import TrainerConfig, make_synthetic_trainer, state_shapes

    mesh = MeshPlan((1, 1), ("data", "model")).build(device_type=device_type)
    trainer = make_synthetic_trainer(granite_cut("torch"), TrainerConfig(steps=2, log_every=9),
                                     2, 8, mesh=mesh)
    state = trainer.run()
    path = save(str(workdir), 2, state)
    shapes = state_shapes(trainer.cfg, trainer.optimizer)
    back = restore(path, shapes, placements=layouts(
        state_specs(shapes, mesh, trainer.strategy), mesh))
    return {"all_dtensors": all(is_dtensor(t) for _, t in _items(state)),
            "restored_equal": _same_bits(bits(back), bits(state)),
            "restored_dtensors": all(is_dtensor(t) for _, t in _items(back)),
            "steps": [r["step"] for r in trainer.metrics_log],
            "losses": [r["loss"] for r in trainer.metrics_log]}


def rank_optimizers(rank, world, workdir, steps, device_type):
    """Reduced granite trained on a (2, 2) mesh with each optimizer (AdamW
    also in 2 microbatches), and on rank 0 unsharded: the logs and the
    final parameters."""
    import dataclasses

    from repro_torch.convert import tree_to_numpy
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import TrainerConfig, make_synthetic_trainer

    mesh = MeshPlan((2, 2), ("data", "model")).build(device_type=device_type)
    out = {}
    for name in OPTIMIZER_CASES:
        cfg = dataclasses.replace(granite_cut("torch"), optimizer=name.split("_")[0])
        tcfg = TrainerConfig(steps=steps, log_every=10 ** 9,
                             n_microbatch=2 if name.endswith("2") else 1)
        sharded = make_synthetic_trainer(cfg, tcfg, 8, 16, mesh=mesh)
        params = bits(sharded.run()["params"])
        out[name] = {"sharded": sharded.metrics_log, "params": params}
        if rank == 0:
            plain = make_synthetic_trainer(cfg, tcfg, 8, 16, device=mesh_device(mesh))
            out[name].update(plain=plain.metrics_log, plain_params=dict(
                _items(tree_to_numpy(plain.run()["params"]))))
    return out


def check_optimizer(results, name):
    """Reduced granite on a (2, 2) mesh: the global norm, Adafactor's row and
    column means and RMS clip, and adam8bit's blocks (local where a cut
    falls on a block edge, the whole leaf elsewhere) reduce across the
    ranks, so the losses and gradient norms follow the unsharded run (in 2
    microbatches too: each rank takes its part of each microbatch; 1e-5
    and 1e-4 relative) and the parameters lie within a quarter of the
    learning rate of it."""
    plain, plain_params = results[0][name]["plain"], results[0][name]["plain_params"]
    for r in results:
        got = r[name]
        same_log(got["sharded"], plain)
        assert list(got["params"]) == list(plain_params)
        for p, want in plain_params.items():
            np.testing.assert_allclose(got["params"][p], want, atol=2.5e-4, rtol=0, err_msg=p)


# ----------------------------------------------------------------- launch --
# The reduced granite's train cell of the launch tests: (8, 256) tokens.
LAUNCH_BATCH, LAUNCH_SEQ = 8, 256


def rank_op_stats(rank, world, workdir, device_type):
    """One sharded train step of the reduced granite on (world / 2, 2),
    seeded weights and tokens, under `launch.op_stats.OpStats`: the
    tally's row (its wire bytes are what the collectives moved)."""
    import torch

    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.op_stats import OpStats
    from repro_torch.launch.plans import CellPlan
    from repro_torch.models import ShapeConfig
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.runtime.elastic import MeshPlan

    mesh = MeshPlan((world // 2, 2), ("data", "model")).build(device_type=device_type)
    device = mesh_device(mesh)
    shape = ShapeConfig("train_4k", "train", LAUNCH_SEQ, LAUNCH_BATCH)
    run, _ = build_step(granite_cut("torch"), shape, mesh, CellPlan(), device=device,
                        generator=torch.Generator(device).manual_seed(0))
    with OpStats(mesh) as tally:
        loss = run()
    return dict(tally.row(), loss=float(loss))


def jax_hlo_stats(workdir, mesh_shape):
    """The reference's train step of the reduced granite at (LAUNCH_BATCH,
    LAUNCH_SEQ), lowered and compiled as its dry run does
    (`repro.launch.dryrun._lower_train`) on a ``mesh_shape`` ("data",
    "model") mesh of host devices: `hlo_stats.module_stats` of it."""
    import repro.launch.dryrun as jdry          # sets the host device count first

    import jax
    from jax.sharding import Mesh

    from repro.launch.hlo_stats import module_stats
    from repro.launch.plans import CellPlan
    from repro.launch.specs import train_batch_specs
    from repro.models import ShapeConfig

    cfg = granite_cut("jax")
    shape = ShapeConfig("train_4k", "train", LAUNCH_SEQ, LAUNCH_BATCH)
    jdry.input_specs = lambda arch, name: {"batch": train_batch_specs(cfg, shape)}
    n = int(np.prod(mesh_shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(mesh_shape), ("data", "model"))
    with mesh:
        compiled = jdry._lower_train(cfg, shape, mesh, CellPlan()).compile()
    return module_stats(compiled.as_text(), n)


def rank_serve_on_a_mesh(rank, world, workdir, device_type):
    """The reduced granite served on (world / 2, 2) by the steps' mesh form
    (`serve.engine.make_prefill_step` / `make_decode_step` with ``mesh=``):
    a prefill of (4, 8) tokens and three greedy decode steps, each fed the
    unsharded run's tokens; (this rank's logits, the same rows of the
    unsharded steps' logits) of each step."""
    import torch

    from repro_torch.models import init_lm
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, param_specs
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    mesh = MeshPlan((world // 2, 2), ("data", "model")).build(device_type=device_type)
    cfg = granite_cut("torch")
    params = init_lm(torch.Generator("cpu").manual_seed(0), cfg, device="cpu")
    placed = distribute_tree(params, param_specs(params, mesh, default_strategy(mesh)), mesh)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 64, size=(4, 8))
                              .astype(np.int32))
    rows = slice(mesh.get_coordinate()[0] * 2, mesh.get_coordinate()[0] * 2 + 2)
    cache_w, whole = make_prefill_step(cfg, 16, device="cpu")(params, {"tokens": tokens})
    cache_m, mine = make_prefill_step(cfg, 16, device="cpu", mesh=mesh)(placed,
                                                                        {"tokens": tokens})
    pairs = [(mine, whole[rows])]
    decode_w, decode_m = make_decode_step(cfg), make_decode_step(cfg, mesh=mesh)
    for _ in range(3):
        nxt = torch.argmax(whole, -1)
        cache_w, whole = decode_w(params, cache_w, nxt)
        cache_m, mine = decode_m(placed, cache_m, nxt)
        pairs.append((mine, whole[rows]))
    return [(to_np(a), to_np(b)) for a, b in pairs]


# -------------------------------------------------------- tensor parallel --
#: The tensor-parallel cases: reduced qwen1.5-0.5b (MHA, QKV bias, tied
#: vocab of 64 that splits over 2 and 4), reduced granite-3-2b (GQA 4/2,
#: a vocab of 67 that splits over neither, as its own 49155 does not),
#: reduced seamless-m4t-large-v2 (an encoder, cross-attention in every
#: decoder block, a GELU FFN) and reduced nemotron-4-15b (a squared-ReLU
#: FFN, GQA 4/2).
TP_VOCAB = {"qwen1.5-0.5b": 64, "granite-3-2b": 67, "seamless-m4t-large-v2": 64,
            "nemotron-4-15b": 64}
TP_MESHES = ((1, 4), (2, 2))
TP_STEPS = 2
TP_FRAMES = 16          # an encoder-decoder's stub frames a row
#: Reduced qwen2-vl (M-RoPE, 2 kv heads of 32) on (1, 4): with its 4 query
#: heads pairs of ranks share a kv head whose columns the rule cut in half;
#: with 6 the query heads do not divide over 4 (as its own 12 do not over
#: 8), and every rank computes the whole attention from gathered weights.
TP_VL = {"vl_shared_kv": {}, "vl_whole_heads": {"n_heads": 6}}


def tp_cut(pkg, arch, **overrides):
    """The reduced ``arch`` of the tensor-parallel tests, in ``pkg``."""
    if pkg == "jax":
        from repro.configs import get_config
        from repro.models import reduced
    else:
        from repro_torch.configs import get_config
        from repro_torch.models import reduced
    return reduced(get_config(arch), vocab_size=TP_VOCAB.get(arch, 64), **overrides)


def tp_batch(cfg, i):
    """`batch_np` (``i``), with an encoder-decoder's ``encoder_embeds``
    ((8, `TP_FRAMES`, d_model) from the step's seed) where ``cfg`` (of
    either package) has an encoder."""
    batch = batch_np(i)
    if cfg.n_encoder_layers:
        rng = np.random.default_rng(1000 + i)
        batch["encoder_embeds"] = rng.standard_normal(
            (8, TP_FRAMES, cfg.d_model)).astype(np.float32)
    return batch


class TPBatches:
    """Step-indexed batches (`tp_batch`) of ``cfg`` for the port's `Trainer`."""

    def __init__(self, cfg):
        self.cfg = cfg

    def batch_at(self, i):
        return tp_batch(self.cfg, i)


def jax_tensor_parallel(workdir):
    """The reference's side of `rank_tensor_parallel`: for each case its
    initial AdamW state and `TP_STEPS` steps of its train step jitted with
    the state's shardings on each mesh of `TP_MESHES` (4 of the 8 host
    devices), on `tp_batch`'s batches: logs and final parameters; and
    reduced qwen2-vl's loss and gradients at its initial parameters on
    (1, 4) in each case of `TP_VL`."""
    import jax
    from jax.sharding import Mesh

    from repro.models import init_lm, lm_loss
    from repro.parallel.context import activation_sharding
    from repro.parallel.sharding import default_strategy, param_specs, state_specs
    from repro.train import init_state, make_optimizer, make_train_step, state_shapes

    mesh_of = lambda shape: Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    out = {}
    for arch in TP_VOCAB:
        cfg, opt = tp_cut("jax", arch), make_optimizer("adamw", lr=1e-3)
        step_fn = make_train_step(cfg, opt)
        state0 = init_state(jax.random.PRNGKey(0), cfg, opt)
        runs = {}
        for shape in TP_MESHES:
            mesh = mesh_of(shape)
            strat = default_strategy(mesh)
            specs = state_specs(state_shapes(cfg, opt), mesh, strat)
            sharded = jax.jit(step_fn, in_shardings=(specs, None), out_shardings=(specs, None))
            state, log = jax.device_put(state0, specs), []
            with mesh, activation_sharding(mesh, strat):
                for i in range(TP_STEPS):
                    state, m = sharded(state, tp_batch(cfg, i))
                    log.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
            runs[shape] = {"log": log, "params": {p: np.asarray(a) for p, a in
                                                  jax_flat(state["params"]).items()}}
        out[arch] = {"state0": jax.tree.map(np.asarray, state0), "runs": runs}

    mesh = mesh_of((1, 4))
    strat = default_strategy(mesh)
    for case, overrides in TP_VL.items():
        cfg = tp_cut("jax", "qwen2-vl-2b", **overrides)
        params = init_lm(jax.random.PRNGKey(0), cfg)
        specs = param_specs(jax.eval_shape(lambda: params), mesh, strat)
        fn = jax.jit(jax.value_and_grad(lambda p, b: lm_loss(p, b, cfg)[0]),
                     in_shardings=(specs, None))
        with mesh, activation_sharding(mesh, strat):
            loss, grads = fn(jax.device_put(params, specs), batch_np(0))
        out[case] = {"params": jax.tree.map(np.asarray, params), "loss": float(loss),
                     "grads": {p: np.asarray(a) for p, a in jax_flat(grads).items()}}
    out["moe"] = jax_moe_tp()
    return out


def rank_tensor_parallel(rank, world, workdir, device_type, ref_file=None, steps=TP_STEPS):
    """Each case of `TP_VOCAB` trained `steps` AdamW steps by `Trainer` on
    each mesh of `TP_MESHES` from the reference's initial state (the port's
    seed 0 without ``ref_file``), on `tp_batch`'s batches: the logs, the
    final parameters and the local shape of a layer's query, FFN and
    vocab weights; on rank 0 also the unsharded run.  With ``ref_file``,
    also reduced qwen2-vl's loss and gradients on (1, 4) in each case of
    `TP_VL`, and the MoE layer on (2, 2) (`rank_moe_tp`)."""
    import torch

    from repro_torch.convert import params_from_jax, state_from_jax, tree_to_numpy
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, state_specs
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import (Trainer, TrainerConfig, init_state, make_optimizer,
                                   state_shapes)

    ref = None
    if ref_file is not None:
        with open(ref_file, "rb") as f:
            ref = pickle.load(f)
    meshes = {shape: MeshPlan(shape, ("data", "model")).build(device_type=device_type)
              for shape in TP_MESHES}
    device = mesh_device(meshes[TP_MESHES[0]])
    tcfg = TrainerConfig(steps=steps, log_every=10 ** 9)
    out = {}
    for arch in TP_VOCAB:
        cfg, opt = tp_cut("torch", arch), make_optimizer("adamw", lr=1e-3)

        def fresh():
            if ref is not None:
                return state_from_jax(ref[arch]["state0"], device)
            return init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)

        for shape, mesh in meshes.items():
            specs = state_specs(state_shapes(cfg, opt), mesh, default_strategy(mesh))
            trainer = Trainer(cfg, tcfg, TPBatches(cfg), mesh=mesh, optimizer=opt)
            state = trainer.run(state=distribute_tree(fresh(), specs, mesh))
            layer = state["params"]["blocks"]["pos0"]
            out[(arch, shape)] = {
                "sharded": trainer.metrics_log, "params": bits(state["params"]),
                "local": {"wq": tuple(layer["attn"]["wq"]["w"].to_local().shape),
                          "w_up": tuple(layer["ffn"]["w_up"]["w"].to_local().shape),
                          "embed": tuple(state["params"]["embed"]["embedding"]
                                         .to_local().shape)}}
        if rank == 0:
            plain = Trainer(cfg, tcfg, TPBatches(cfg), optimizer=opt, device=device)
            out[arch] = {"plain": plain.metrics_log, "plain_params": dict(
                _items(tree_to_numpy(plain.run(state=fresh())["params"])))}
    if ref is not None:
        for case, overrides in TP_VL.items():
            out[case] = _loss_and_grads(tp_cut("torch", "qwen2-vl-2b", **overrides),
                                        params_from_jax(ref[case]["params"], device),
                                        meshes[(1, 4)])
        out["moe"] = rank_moe_tp(meshes[(2, 2)], ref["moe"])
    return out


def _loss_and_grads(cfg, params, mesh):
    """The loss of `batch_np` (0) and its gradients (whole tensors) with
    ``params`` placed by `param_specs` on ``mesh``, as the sharded train
    step takes them: the rank's rows under the context, the loss averaged
    over the data ranks."""
    import torch

    from repro_torch.models import lm_loss
    from repro_torch.parallel.context import activation_sharding
    from repro_torch.parallel.sharding import (batch_mesh_dims, default_strategy,
                                               distribute_tree, local_batch, param_specs)
    from repro_torch.train.train_step import _dp_mean

    strat = default_strategy(mesh)
    placed = distribute_tree(params, param_specs(params, mesh, strat), mesh)
    leaves = []

    def track(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]

    from repro_torch._tree import tree_map
    live = tree_map(track, placed)
    batch = {k: torch.from_numpy(v).to(params["embed"]["embedding"].device)
             for k, v in batch_np(0).items()}
    cut = batch_mesh_dims(batch, mesh, strat)
    with activation_sharding(mesh, strat, batch_dims=cut):
        loss, _ = lm_loss(live, local_batch(batch, mesh, strat), cfg)
        grads = torch.autograd.grad(loss, leaves)
    loss = _dp_mean({"loss": loss.detach()}, mesh, strat)["loss"]
    paths = [p for p, _ in _items(placed)]
    return {"loss": float(loss),
            "grads": {p: to_np(g.full_tensor()) for p, g in zip(paths, grads)}}


def check_tensor_parallel(results, arch, shape):
    """`rank_tensor_parallel`'s run of ``arch`` on ``shape``: on every rank
    the losses (1e-5) and gradient norms (1e-4 relative) follow the
    unsharded run, and the parameters lie within a quarter of the learning
    rate of it (2.5e-4)."""
    plain, plain_params = results[0][arch]["plain"], results[0][arch]["plain_params"]
    for r in results:
        got = r[(arch, shape)]
        same_log(got["sharded"], plain)
        assert list(got["params"]) == list(plain_params)
        for p, want in plain_params.items():
            np.testing.assert_allclose(got["params"][p], want, atol=2.5e-4, rtol=0, err_msg=p)


# The MoE layer on (2, 2): each rank its data rank's rows and 2 of the 4
# experts, at the config's capacity and at a tight one (assignments drop).
MOE_TP_CASES = ("default", "tight")


def jax_moe_tp():
    """The reference's MoE layer on (4, 16, 64) tokens of `moe_cut` at each
    case of `MOE_TP_CASES`: single-program output, aux loss, drop fraction,
    the gradients of sum(y^2) (input, router, experts) and of the aux loss
    (input, router); and its output on a (2, 2) mesh under the default
    strategy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.models.moe import init_moe, moe_ffn
    from repro.parallel.context import activation_sharding
    from repro.parallel.sharding import ShardingStrategy

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for case in MOE_TP_CASES:
        cfg = moe_cut("jax", case)
        key = jax.random.PRNGKey(0)
        params = init_moe(key, cfg, jnp.float32)
        x = jax.random.normal(jax.random.fold_in(key, 1), (4, 16, cfg.d_model))
        y, aux, metrics = moe_ffn(params, x, cfg)
        g = jax.grad(lambda p, x: jnp.sum(moe_ffn(p, x, cfg)[0] ** 2), argnums=(0, 1))(params, x)
        ga = jax.grad(lambda p, x: moe_ffn(p, x, cfg)[1], argnums=(0, 1))(params, x)
        put = lambda a, *spec: jax.device_put(a, NamedSharding(mesh, P(*spec)))
        with mesh, activation_sharding(mesh, ShardingStrategy(dp=("data",))):
            on_mesh = jax.jit(lambda p, x: moe_ffn(p, x, cfg)[0])(params,
                                                                  put(x, "data", None, None))
        out[case] = dict(
            params=jax.tree.map(np.asarray, params), x=np.asarray(x), y=np.asarray(y),
            aux=float(aux), drops=float(metrics["moe_drop_frac"]), on_mesh=np.asarray(on_mesh),
            gx=np.asarray(g[1]), grouter=np.asarray(g[0]["router"]["w"]),
            gexperts={k: np.asarray(v["w"]) for k, v in g[0]["experts"].items()},
            gx_aux=np.asarray(ga[1]), grouter_aux=np.asarray(ga[0]["router"]["w"]))
    return out


def rank_moe_tp(mesh, ref):
    """The port's `moe_ffn` on the (2, 2) ``mesh`` under the default
    strategy, each rank its data rank's (2, 16, 64) rows of ``ref``'s
    input and, of the experts placed by the rule table, its 2 of 4: the
    output, aux loss and drop fraction, the gradients of sum(y^2) (rows of
    the input, router, experts) and of the aux loss (input, router), and
    the experts' local shape."""
    import torch

    from repro_torch.convert import params_from_jax
    from repro_torch.models.moe import moe_ffn
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.context import activation_sharding
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, param_specs

    device, strat = mesh_device(mesh), default_strategy(mesh)
    i = mesh.get_local_rank(0)
    out = {}
    for case in MOE_TP_CASES:
        cfg = moe_cut("torch", case)
        whole = params_from_jax(ref[case]["params"], device)
        specs = param_specs({"moe": whole}, mesh, strat)["moe"]["experts"]
        experts = distribute_tree(whole["experts"], specs, mesh)
        names = sorted(experts)
        leaves = {k: experts[k]["w"].detach().requires_grad_(True) for k in names}
        router = whole["router"]["w"].requires_grad_(True)
        params = {"router": {"w": router}, "experts": {k: {"w": v} for k, v in leaves.items()}}
        x = torch.from_numpy(ref[case]["x"][2 * i:2 * i + 2]).to(device).requires_grad_(True)
        with activation_sharding(mesh, strat):
            y, aux, metrics = moe_ffn(params, x, cfg)
            g = torch.autograd.grad(y.square().sum(), [x, router] + [leaves[k] for k in names],
                                    retain_graph=True)
            ga = torch.autograd.grad(aux, [x, router])
        out[case] = {"y": to_np(y), "aux": float(aux), "drops": float(metrics["moe_drop_frac"]),
                     "gx": to_np(g[0]), "grouter": to_np(g[1]),
                     "gexperts": {k: to_np(t.full_tensor()) for k, t in zip(names, g[2:])},
                     "gx_aux": to_np(ga[0]), "grouter_aux": to_np(ga[1]),
                     "experts_local": tuple(leaves["w_up"].to_local().shape)}
    return out


def rank_engine_on_a_mesh(rank, world, workdir, device_type):
    """Reduced qwen1.5-0.5b (vocab 64, split over "model") served by
    `ServeEngine` on a (2, 2) mesh of 4 slots and unsharded: the greedy
    streams of 6 requests, and the logits of the mesh form of the decode
    step beside the unsharded step's on the same cache; then a sampled
    request moved mid-decode from slot 0 of one mesh engine into slot 3
    (held by the other data rank) of another, beside the same request
    never moved: its tokens and the slot's state at the end.  Then
    reduced seamless-m4t-large-v2 (4 rows of `TP_FRAMES` stub frames)
    through the prefill and decode steps on the mesh and unsharded (the
    engine takes no cross length, as the reference's): the prefill's
    and one decode step's logits of the rank's rows, and the shape of its
    cross cache."""
    import torch

    from repro_torch.models import init_lm
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, param_specs
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.serve.engine import (Request, ServeEngine, make_decode_step,
                                          make_prefill_step)

    mesh = MeshPlan((2, 2), ("data", "model")).build(device_type=device_type)
    cfg = tp_cut("torch", "qwen1.5-0.5b")
    params = init_lm(torch.Generator("cpu").manual_seed(0), cfg, device="cpu")
    placed = distribute_tree(params, param_specs(params, mesh, default_strategy(mesh)), mesh)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 64, size=int(rng.integers(2, 7))).tolist() for _ in range(6)]
    engine = lambda p, **kw: ServeEngine(cfg, p, batch_slots=4, max_len=48, eos_id=-1,
                                         device="cpu", **kw)
    streams = {}
    for name, eng in (("mesh", engine(placed, mesh=mesh)), ("whole", engine(params))):
        reqs = [Request(i, list(p), max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done(500)
        streams[name] = {r.req_id: list(r.output) for r in reqs}
        if name == "mesh":
            rows, heads = eng.cache["index"].shape[0], eng.cache["blocks"]["pos0"]["attn"]["k"]
            tokens = torch.from_numpy(rng.integers(0, 64, size=(4, 1)).astype(np.int32))
            cache = eng.cache
    # The decode step's logits on the mesh engine's last cache, against the
    # unsharded step's on that cache's whole (every rank's rows and heads).
    whole_cache = _whole_cache(cache, mesh)
    _, want = make_decode_step(cfg)(params, whole_cache, tokens)
    _, got = make_decode_step(cfg, mesh=mesh)(placed, cache, tokens)
    r0 = mesh.get_local_rank(0) * rows

    mk = lambda: engine(placed, mesh=mesh, temperature=0.7, rng_seed=3)
    ref_eng = mk()
    ref_req = Request(5, prompt=[7, 8, 9], max_new_tokens=10)
    ref_eng.submit(ref_req)
    ref_eng.run_until_done(200)
    src = mk()
    mig = Request(5, prompt=[7, 8, 9], max_new_tokens=10)
    src.submit(mig)
    while len(mig.output) < 4:
        src.step()
    state = src.export_slot(0)
    dst = mk()
    dst.import_slot(3, state)
    dst.slots[3], dst.offsets[3] = mig, state["offset"]
    dst.run_until_done(200)
    moved, kept = dst.export_slot(3), ref_eng.export_slot(0)
    offsets = moved.pop("offset"), kept.pop("offset")

    scfg = tp_cut("torch", "seamless-m4t-large-v2")
    sparams = init_lm(torch.Generator("cpu").manual_seed(0), scfg, device="cpu")
    splaced = distribute_tree(sparams, param_specs(sparams, mesh, default_strategy(mesh)),
                              mesh)
    batch = {"tokens": torch.from_numpy(rng.integers(1, 64, size=(4, 5)).astype(np.int32)),
             "encoder_embeds": torch.from_numpy(rng.standard_normal(
                 (4, TP_FRAMES, scfg.d_model)).astype(np.float32))}
    nxt = torch.from_numpy(rng.integers(1, 64, size=(4, 1)).astype(np.int32))
    prefill = lambda **kw: make_prefill_step(scfg, 12, cross_len=TP_FRAMES, device="cpu", **kw)
    whole_cache, whole_first = prefill()(sparams, batch)
    _, whole_next = make_decode_step(scfg)(sparams, whole_cache, nxt)
    mesh_cache, mesh_first = prefill(mesh=mesh)(splaced, batch)
    _, mesh_next = make_decode_step(scfg, mesh=mesh)(splaced, mesh_cache, nxt)
    cross = {"first": (to_np(mesh_first), to_np(whole_first[r0:r0 + rows])),
             "next": (to_np(mesh_next), to_np(whole_next[r0:r0 + rows])),
             "cross_kv": tuple(mesh_cache["blocks"]["pos0"]["cross"]["k"].shape)}
    return {"streams": streams, "rows": rows, "kv_heads": tuple(heads.shape),
            "logits": (to_np(got), to_np(want[r0:r0 + rows])),
            "moved": (mig.output, ref_req.output, bits(moved), bits(kept), offsets),
            "cross": cross}


def _whole_cache(cache, mesh):
    """A mesh engine's cache made whole: each leaf's rows gathered over
    "data" and, for the K/V (batch, layer, length, kv heads, d_head) of
    the stacked layers, its kv heads over "model"."""
    import torch
    import torch.distributed as dist

    from repro_torch._tree import tree_map

    def cat(t, dim, k):
        parts = [torch.empty_like(t) for _ in range(mesh.size(k))]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(k))
        return torch.cat(parts, dim)

    out = tree_map(lambda t: cat(cat(t, 3, 1), 1, 0) if t.ndim == 5 else cat(t, 0, 0),
                   {"blocks": cache["blocks"], "index": cache["index"]})
    return dict(cache, **out)


# The tensor-parallel check of tools/multi_gpu_check.py at full width.
TP_FULL_TOKENS = (2, 1024)      # fp32 granite's batch: rows x positions
TP_BF16_TOKENS = (2, 4096)      # bf16 granite's, the card's train phase's
TP_BF16_STEPS = 4


class TokenBatches:
    """Step-indexed batches of random tokens below ``vocab``: ``rows`` x
    ``seq`` positions, from the step's seed."""

    def __init__(self, vocab, rows, seq):
        self.vocab, self.rows, self.seq = vocab, rows, seq

    def batch_at(self, i):
        t = np.random.default_rng(i).integers(0, self.vocab, size=(self.rows, self.seq + 1))
        return {"inputs": t[:, :-1].astype(np.int32), "targets": t[:, 1:].astype(np.int32)}


class _NoUpdate:
    """An optimizer that leaves the parameters as they are: its train step
    is one loss and one gradient norm."""

    def init(self, params):
        return {}

    def update(self, grads, opt, params):
        return params, opt


def _free(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def moe_rows_timing(mesh, device, cfg, tokens, reps=3):
    """The mesh train step of the MoE ``cfg`` (one loss and gradient, no
    update) on ``tokens`` (rows x positions), with each data part's buffer
    ``rows`` long an expert: the longest run of its tokens, read back to the
    host (`models.moe._part_rows`, the program's); the largest of those
    runs in the warm-up step, a constant with no read (the read's own
    cost); and the static bound min(cap, T), which needs no read either.
    One warm-up step of each, then ``reps`` timed steps of each,
    alternated: their seconds, the rows of each layer call of the last
    step and the last losses."""
    import time

    import torch

    from repro_torch.models import init_lm, moe
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, param_specs
    from repro_torch.train import make_train_step

    params = init_lm(torch.Generator(device).manual_seed(0), cfg, device=device)
    placed = distribute_tree(params, param_specs(params, mesh, default_strategy(mesh)), mesh)
    del params
    state = {"params": placed, "opt": {}, "step": torch.zeros((), dtype=torch.int32,
                                                               device=device)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             TokenBatches(cfg.vocab_size, *tokens).batch_at(0).items()}
    step = make_train_step(cfg, _NoUpdate(), mesh=mesh)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    program, seen = moe._part_rows, []

    def recorded(rows):
        def part_rows(*args):
            seen.append(rows(*args))
            return seen[-1]
        return part_rows

    variants = {"longest_run": program,
                "no_read": lambda *args: max(out["longest_run"]["rows"]),
                "static": lambda counts, before, cap, n_parts, T, *rest: min(cap, T)}
    out = {name: {"step_s": []} for name in variants}
    try:
        for i in range(reps + 1):
            for name, rows in variants.items():
                moe._part_rows = recorded(rows)
                seen.clear()
                sync()
                t0 = time.perf_counter()
                loss = float(step(state, batch)[1]["loss"])
                sync()
                if i:
                    out[name]["step_s"].append(time.perf_counter() - t0)
                out[name].update(loss=loss, rows=list(seen))
    finally:
        moe._part_rows = program
    return out


def rank_tensor_parallel_full(rank, world, workdir, device_type):
    """On 4 cards: granite-3-2b, all 40 layers, fp32, trained 2 AdamW steps
    of `TP_FULL_TOKENS` unsharded on rank 0 (one card) and on (1, 4) and
    (2, 2), from seed 0; a dbrx cut of 2 layers at full width, fp32, one
    loss and gradient norm (no update) unsharded on rank 0 and on (1, 4),
    4 experts a rank, and (2, 2); bf16 granite (the config's types),
    `TP_BF16_STEPS` steps of `TP_BF16_TOKENS` with the card's train
    phase's ``loss_chunk`` unsharded on rank 0 and on (1, 4): each step's
    seconds and the card's peak bytes; the dbrx cut in its config's types
    at `TP_BF16_TOKENS` on (2, 2) by `moe_rows_timing`."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cut_depth
    from repro_torch.models import init_lm
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import (default_strategy, distribute_tree, param_specs,
                                               state_specs)
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import (Trainer, TrainerConfig, init_state, make_optimizer,
                                   make_train_step, state_shapes)

    meshes = {shape: MeshPlan(shape, ("data", "model")).build(device_type=device_type)
              for shape in TP_MESHES}
    device = mesh_device(meshes[TP_MESHES[0]])
    fp32 = lambda cfg: dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    out = {}

    # Each part runs on one card (rank 0) first, while the card is empty,
    # and then on the meshes: the other ranks wait in the meshes' first
    # collective meanwhile.
    cfg, opt = fp32(get_config("granite-3-2b")), make_optimizer("adamw", lr=1e-3)
    data = TokenBatches(cfg.vocab_size, *TP_FULL_TOKENS)
    tcfg = TrainerConfig(steps=TP_STEPS, log_every=10 ** 9)
    fresh = lambda: init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)
    if rank == 0:
        plain = Trainer(cfg, tcfg, data, optimizer=opt, device=device)
        plain.run(state=fresh())
        out["granite"] = plain.metrics_log
        del plain
        _free(device)
    for shape, mesh in meshes.items():
        specs = state_specs(state_shapes(cfg, opt), mesh, default_strategy(mesh))
        trainer = Trainer(cfg, tcfg, data, mesh=mesh, optimizer=opt)
        trainer.run(state=distribute_tree(fresh(), specs, mesh))
        out[("granite", shape)] = trainer.metrics_log
        del trainer
        _free(device)

    cfg = fp32(cut_depth(get_config("dbrx-132b"), 2))
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             TokenBatches(cfg.vocab_size, *TP_FULL_TOKENS).batch_at(0).items()}
    state = lambda params: {"params": params, "opt": {},
                            "step": torch.zeros((), dtype=torch.int32, device=device)}
    if rank == 0:
        params = init_lm(torch.Generator(device).manual_seed(0), cfg, device=device)
        m = make_train_step(cfg, _NoUpdate())(state(params), batch)[1]
        out["dbrx"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        del params, m
        _free(device)
    for shape, mesh in meshes.items():
        params = init_lm(torch.Generator(device).manual_seed(0), cfg, device=device)
        placed = distribute_tree(params, param_specs(params, mesh, default_strategy(mesh)), mesh)
        del params
        m = make_train_step(cfg, _NoUpdate(), mesh=mesh)(state(placed), batch)[1]
        out[("dbrx", shape)] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                "experts": cfg.n_experts,
                                "experts_local": tuple(placed["blocks"]["pos0"]["moe"]["experts"]
                                                       ["w_up"]["w"].to_local().shape)}
        del placed, m
        _free(device)

    cfg = get_config("granite-3-2b")
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    data = TokenBatches(cfg.vocab_size, *TP_BF16_TOKENS)
    tcfg = TrainerConfig(steps=TP_BF16_STEPS, log_every=10 ** 9, loss_chunk=1024)
    runs = {"1x1": None, "1x4": meshes[(1, 4)]} if rank == 0 else {"1x4": meshes[(1, 4)]}
    for name, mesh in runs.items():
        state0 = init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)
        if mesh is not None:
            state0 = distribute_tree(state0, state_specs(state0, mesh, default_strategy(mesh)),
                                     mesh)
        _free(device)
        trainer = Trainer(cfg, tcfg, data, mesh=mesh, optimizer=opt, device=device)
        trainer.run(state=state0)
        out[("bf16", name)] = {
            "step_s": [r["dt_s"] for r in trainer.metrics_log],
            "loss": [r["loss"] for r in trainer.metrics_log],
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None)}
        del trainer, state0
        _free(device)

    cfg = cut_depth(get_config("dbrx-132b"), 2)
    out["moe_rows"] = moe_rows_timing(meshes[(2, 2)], device, cfg, TP_BF16_TOKENS)
    _free(device)
    if device.type == "cuda":
        # Whether the router's `bincount` reads a number back to the host.
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.bincount(torch.arange(16, device=device), minlength=16)
            out["bincount_reads_back"] = False
        except RuntimeError:
            out["bincount_reads_back"] = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out


def check_tensor_parallel_full(results):
    """`rank_tensor_parallel_full`'s runs: every rank's fp32 granite losses
    (1e-5) and gradient norms (1e-4 relative) on each mesh follow the
    one-card run, and so do the dbrx cut's loss and gradient norm (4
    experts a rank at full width on (1, 4)); the bf16 steps' seconds and
    peaks, a record (the median of the steps after the first), and rank
    0's `moe_rows_timing`."""
    import statistics

    for r in results:
        for shape in TP_MESHES:
            same_log(r[("granite", shape)], results[0]["granite"])
            same_log([r[("dbrx", shape)]], [results[0]["dbrx"]])
        one_by_four = r[("dbrx", (1, 4))]
        assert one_by_four["experts_local"][1] == one_by_four["experts"] // 4
    median = lambda xs: statistics.median(xs[1:])
    return {"granite_fp32": {"one_card": results[0]["granite"],
                             **{f"{a}x{b}": results[0][("granite", (a, b))]
                                for a, b in TP_MESHES}},
            "dbrx_fp32": {"one_card": results[0]["dbrx"],
                          **{f"{a}x{b}": results[0][("dbrx", (a, b))] for a, b in TP_MESHES}},
            "granite_bf16": {name: dict(run, median_step_s=median(run["step_s"]))
                             for name, run in (("1x4", results[0][("bf16", "1x4")]),
                                               ("1x1", results[0][("bf16", "1x1")]))},
            "granite_bf16_1x4_peaks": [r[("bf16", "1x4")]["peak_bytes"] for r in results],
            "dbrx_bf16_2x2_rows": {name: dict(run, median_step_s=statistics.median(run["step_s"]))
                                   for name, run in results[0]["moe_rows"].items()},
            "bincount_reads_back": results[0].get("bincount_reads_back")}


# ------------------------------------------- tensor parallel: the mixers --
#: Reduced zamba2-7b (4 Mamba2 layers of 4 heads of 64 over d_inner 256,
#: state 16, the shared attention block every 2 layers) and reduced
#: xlstm-1.3b (an mLSTM block of 4 heads over d_inner 256 and an sLSTM
#: block of 4 heads over 128, whose FFN of 170 splits over 2 ranks and
#: stays whole over 4), vocab 64, trained and served on `TP_MESHES`.
MIXER_ARCHS = ("zamba2-7b", "xlstm-1.3b")
MIXER_SLOTS = 4
MIXER_MAX_LEN = 32


def mixer_prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(1, 64, size=int(rng.integers(2, 7))).tolist() for _ in range(6)]


def jax_tensor_parallel_mixers(workdir):
    """The reference's side of `rank_tensor_parallel_mixers`: for each of
    `MIXER_ARCHS` its initial AdamW state, `TP_STEPS` steps of its train
    step on each mesh of `TP_MESHES` (as `jax_tensor_parallel`), the loss
    and gradients of `batch_np` (0) at the initial parameters on each mesh,
    and the greedy streams of its `ServeEngine` over `mixer_prompts`."""
    import jax
    from jax.sharding import Mesh

    from repro.models import lm_loss
    from repro.parallel.context import activation_sharding
    from repro.parallel.sharding import default_strategy, param_specs, state_specs
    from repro.serve import Request, ServeEngine
    from repro.train import init_state, make_optimizer, make_train_step, state_shapes

    mesh_of = lambda shape: Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    out = {}
    for arch in MIXER_ARCHS:
        cfg, opt = tp_cut("jax", arch), make_optimizer("adamw", lr=1e-3)
        step_fn = make_train_step(cfg, opt)
        state0 = init_state(jax.random.PRNGKey(0), cfg, opt)
        params = state0["params"]
        runs = {}
        for shape in TP_MESHES:
            mesh = mesh_of(shape)
            strat = default_strategy(mesh)
            specs = state_specs(state_shapes(cfg, opt), mesh, strat)
            sharded = jax.jit(step_fn, in_shardings=(specs, None), out_shardings=(specs, None))
            state, log = jax.device_put(state0, specs), []
            pspecs = param_specs(jax.eval_shape(lambda: params), mesh, strat)
            grad_fn = jax.jit(jax.value_and_grad(lambda p, b: lm_loss(p, b, cfg)[0]),
                              in_shardings=(pspecs, None))
            with mesh, activation_sharding(mesh, strat):
                for i in range(TP_STEPS):
                    state, m = sharded(state, batch_np(i))
                    log.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
                loss, grads = grad_fn(jax.device_put(params, pspecs), batch_np(0))
            runs[shape] = {"log": log, "params": {p: np.asarray(a) for p, a in
                                                  jax_flat(state["params"]).items()},
                           "loss": float(loss),
                           "grads": {p: np.asarray(a) for p, a in jax_flat(grads).items()}}
        engine = ServeEngine(cfg, params, batch_slots=MIXER_SLOTS, max_len=MIXER_MAX_LEN,
                             eos_id=-1)
        reqs = [Request(i, list(p), max_new_tokens=6) for i, p in enumerate(mixer_prompts())]
        for r in reqs:
            engine.submit(r)
        engine.run_until_done(500)
        out[arch] = {"state0": jax.tree.map(np.asarray, state0), "runs": runs,
                     "streams": {r.req_id: list(r.output) for r in reqs}}
    return out


def _mixer_heads_seen():
    """Wrap the scans and recurrences of the mixers so that the head count
    of each call is kept: returns (the list of (mixer, heads) pairs, a
    function that unwraps)."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm, xlstm

    seen, undo = [], []

    def wrap(module, name, mixer, heads_of):
        inner = getattr(module, name)

        def recorded(*args, **kw):
            seen.append((mixer, heads_of(args)))
            return inner(*args, **kw)

        setattr(module, name, recorded)
        undo.append(lambda: setattr(module, name, inner))

    for module, name in ((ops, "ssm_scan"), (ssm, "ssd_chunked"), (ssm, "ssd_reference")):
        wrap(module, name, "mamba2", lambda a: a[0].shape[2])
    for name in ("mlstm_chunked", "mlstm_recurrence"):
        wrap(xlstm, name, "mlstm", lambda a: a[0].shape[2])
    wrap(xlstm, "_slstm_loop", "slstm", lambda a: a[0].shape[3])
    return seen, lambda: [u() for u in undo]


def rank_tensor_parallel_mixers(rank, world, workdir, device_type, ref_file=None,
                                steps=TP_STEPS):
    """Each case of `MIXER_ARCHS` trained `steps` AdamW steps by `Trainer`
    on each mesh of `TP_MESHES` from the reference's initial state (the
    port's seed 0 without ``ref_file``), on `batch_np`'s batches: the logs,
    the final parameters, the local shapes of a mixer's leaves, the loss
    and gradients at the initial parameters with the head count each
    mixer's scan or recurrence ran at, and the shapes of the cache an
    engine on the mesh holds; on rank 0 also the unsharded run.  Then the
    engine on (2, 2) (`_mixer_engine`)."""
    import torch

    from repro_torch.convert import state_from_jax, tree_to_numpy
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import (default_strategy, distribute_tree, param_specs,
                                               state_specs)
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import Trainer, TrainerConfig, init_state, make_optimizer, state_shapes

    ref = None
    if ref_file is not None:
        with open(ref_file, "rb") as f:
            ref = pickle.load(f)
    meshes = {shape: MeshPlan(shape, ("data", "model")).build(device_type=device_type)
              for shape in TP_MESHES}
    device = mesh_device(meshes[TP_MESHES[0]])
    tcfg = TrainerConfig(steps=steps, log_every=10 ** 9)
    out = {}
    for arch in MIXER_ARCHS:
        cfg, opt = tp_cut("torch", arch), make_optimizer("adamw", lr=1e-3)

        def fresh():
            if ref is not None:
                return state_from_jax(ref[arch]["state0"], device)
            return init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)

        for shape, mesh in meshes.items():
            specs = state_specs(state_shapes(cfg, opt), mesh, default_strategy(mesh))
            trainer = Trainer(cfg, tcfg, Batches(), mesh=mesh, optimizer=opt)
            state = trainer.run(state=distribute_tree(fresh(), specs, mesh))
            seen, undo = _mixer_heads_seen()
            try:
                grads = _loss_and_grads(cfg, fresh()["params"], mesh)
            finally:
                undo()
            params = fresh()["params"]
            engine = ServeEngine(
                cfg, distribute_tree(params, param_specs(params, mesh, default_strategy(mesh)),
                                     mesh),
                batch_slots=MIXER_SLOTS, max_len=MIXER_MAX_LEN, device=device, mesh=mesh)
            out[(arch, shape)] = {
                "sharded": trainer.metrics_log, "params": bits(state["params"]),
                "local": {p: tuple(t.to_local().shape) for p, t in
                          _items(state["params"]["blocks"])},
                "cache": {p: tuple(t.shape) for p, t in _items(engine.cache["blocks"])},
                "seen": sorted(set(seen)), **grads}
        if rank == 0:
            plain = Trainer(cfg, tcfg, Batches(), optimizer=opt, device=device)
            out[arch] = {"plain": plain.metrics_log, "plain_params": dict(
                _items(tree_to_numpy(plain.run(state=fresh())["params"])))}
        out[(arch, "engine")] = _mixer_engine(cfg, fresh()["params"], meshes[(2, 2)], device)
    return out


def _mixer_engine(cfg, params, mesh, device):
    """``cfg`` served by `ServeEngine` on ``mesh`` and unsharded: the greedy
    streams of `mixer_prompts`; the logits of one decode step of the mesh
    engine and of an unsharded engine into which every slot of it was
    imported; a sampled request exported mid-decode from slot 0 of a mesh
    engine, imported into slot 1 of an unsharded engine (its payload
    exported back, and the tokens it goes on to) and into slot 3 of
    another mesh engine, beside the request never moved."""
    import copy

    import torch

    from repro_torch.parallel.sharding import default_strategy, distribute_tree, param_specs
    from repro_torch.serve.engine import Request, ServeEngine

    placed = distribute_tree(params, param_specs(params, mesh, default_strategy(mesh)), mesh)
    engine = lambda p, **kw: ServeEngine(cfg, p, batch_slots=MIXER_SLOTS,
                                         max_len=MIXER_MAX_LEN, eos_id=-1, device=device, **kw)
    streams = {}
    for name, eng in (("mesh", engine(placed, mesh=mesh)), ("whole", engine(params))):
        reqs = [Request(i, list(p), max_new_tokens=6) for i, p in enumerate(mixer_prompts())]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done(500)
        streams[name] = {r.req_id: list(r.output) for r in reqs}
        if name == "mesh":
            mesh_eng = eng
    # One decode step of the mesh engine's last state, and of an unsharded
    # engine holding every slot of it (whole payloads).
    whole_eng = engine(params)
    for slot in range(MIXER_SLOTS):
        whole_eng.import_slot(slot, mesh_eng.export_slot(slot))
    tokens = torch.from_numpy(np.arange(1, MIXER_SLOTS + 1, dtype=np.int32)[:, None]).to(device)
    _, got = mesh_eng._decode(placed, mesh_eng.cache, tokens)
    _, want = whole_eng._decode(params, whole_eng.cache, tokens)
    rows = mesh_eng.cache["index"].shape[0]

    mk = lambda **kw: engine(placed, mesh=mesh, temperature=0.7, rng_seed=3, **kw)
    ref_eng = mk()
    ref_req = Request(5, prompt=[7, 8, 9], max_new_tokens=10)
    ref_eng.submit(ref_req)
    ref_eng.run_until_done(200)
    src = mk()
    mig = Request(5, prompt=[7, 8, 9], max_new_tokens=10)
    src.submit(mig)
    while len(mig.output) < 4:
        src.step()
    state = src.export_slot(0)
    one = engine(params, temperature=0.7, rng_seed=3)
    one.import_slot(1, state)
    back = one.export_slot(1)
    one.slots[1] = on_one = copy.deepcopy(mig)
    one.run_until_done(200)
    dst = mk()
    dst.import_slot(3, state)
    dst.slots[3] = mig
    dst.run_until_done(200)
    moved, kept, empty = dst.export_slot(3), ref_eng.export_slot(0), one.export_slot(0)
    for payload in (state, back, moved, kept, empty):
        payload.pop("offset")
    return {"streams": streams, "rows": rows,
            "logits": (to_np(got), to_np(want[mesh.get_local_rank(0) * rows:][:rows])),
            "one_device": (bits(state), bits(back), on_one.output, ref_req.output),
            "moved": (mig.output, ref_req.output, bits(moved), bits(kept)),
            "whole_shapes": {p: v.shape for p, v in bits(state).items()},
            "one_device_shapes": {p: v.shape for p, v in bits(empty).items()}}


# The mixers' tensor-parallel check of tools/multi_gpu_check.py at full width.
MIXER_FULL_LAYERS = {"zamba2-7b": 9, "xlstm-1.3b": 8}   # zamba2's cut; xlstm's period


def rank_tensor_parallel_mixers_full(rank, world, workdir, device_type):
    """On 4 cards: zamba2-7b at full width cut to 9 layers and xlstm-1.3b's
    period of 8 blocks, fp32, trained `TP_STEPS` AdamW steps of
    `TP_FULL_TOKENS` unsharded on rank 0 (one card, first, while the card
    is empty) and on (1, 4) and (2, 2), from seed 0: each rank its Mamba2
    and xLSTM heads; then the zamba2 cut in its config's types,
    `TP_BF16_STEPS` steps of `TP_BF16_TOKENS` (``loss_chunk`` 1024)
    unsharded on rank 0 and on (1, 4): each step's seconds and the card's
    peak bytes."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cut_depth
    from repro_torch.parallel.comm import mesh_device
    from repro_torch.parallel.sharding import default_strategy, distribute_tree, state_specs
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import Trainer, TrainerConfig, init_state, make_optimizer

    meshes = {shape: MeshPlan(shape, ("data", "model")).build(device_type=device_type)
              for shape in TP_MESHES}
    device = mesh_device(meshes[TP_MESHES[0]])
    fp32 = lambda cfg: dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    out = {}

    def train(cfg, opt, tcfg, data, mesh):
        state0 = init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)
        if mesh is not None:
            state0 = distribute_tree(state0, state_specs(state0, mesh, default_strategy(mesh)),
                                     mesh)
        _free(device)
        trainer = Trainer(cfg, tcfg, data, mesh=mesh, optimizer=opt, device=device)
        trainer.run(state=state0)
        log = trainer.metrics_log
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        del trainer, state0
        _free(device)
        return log, peak

    for arch, layers in MIXER_FULL_LAYERS.items():
        cfg = fp32(cut_depth(get_config(arch), layers))
        opt = make_optimizer("adamw", lr=1e-3)
        data = TokenBatches(cfg.vocab_size, *TP_FULL_TOKENS)
        tcfg = TrainerConfig(steps=TP_STEPS, log_every=10 ** 9)
        if rank == 0:
            out[arch] = train(cfg, opt, tcfg, data, None)[0]
        for shape, mesh in meshes.items():
            out[(arch, shape)] = train(cfg, opt, tcfg, data, mesh)[0]

    cfg = cut_depth(get_config("zamba2-7b"), MIXER_FULL_LAYERS["zamba2-7b"])
    opt = make_optimizer(cfg.optimizer, lr=1e-3)
    data = TokenBatches(cfg.vocab_size, *TP_BF16_TOKENS)
    tcfg = TrainerConfig(steps=TP_BF16_STEPS, log_every=10 ** 9, loss_chunk=1024)
    runs = {"1x1": None, "1x4": meshes[(1, 4)]} if rank == 0 else {"1x4": meshes[(1, 4)]}
    for name, mesh in runs.items():
        log, peak = train(cfg, opt, tcfg, data, mesh)
        out[("bf16", name)] = {"step_s": [r["dt_s"] for r in log],
                               "loss": [r["loss"] for r in log], "peak_bytes": peak}
    return out


def check_tensor_parallel_mixers_full(results):
    """`rank_tensor_parallel_mixers_full`'s runs: every rank's fp32 losses
    (1e-5) and gradient norms (1e-4 relative) of both cuts on each mesh
    follow the one-card run; the bf16 zamba2 cut's steps and peaks, a
    record (the median of the steps after the first)."""
    import statistics

    for r in results:
        for arch in MIXER_FULL_LAYERS:
            for shape in TP_MESHES:
                same_log(r[(arch, shape)], results[0][arch])
    median = lambda xs: statistics.median(xs[1:])
    return {**{f"{arch}_fp32": {"one_card": results[0][arch],
                                **{f"{a}x{b}": results[0][(arch, (a, b))] for a, b in TP_MESHES}}
               for arch in MIXER_FULL_LAYERS},
            "zamba2_bf16": {name: dict(run, median_step_s=median(run["step_s"]))
                            for name, run in (("1x4", results[0][("bf16", "1x4")]),
                                              ("1x1", results[0][("bf16", "1x1")]))},
            "zamba2_bf16_1x4_peaks": [r[("bf16", "1x4")]["peak_bytes"] for r in results]}
