"""The port's dry run (`launch.dryrun`): every architecture's step traced on
meta on the 256-H100 production mesh at reduced depth, with the reference's
statuses and skips; granite-3-2b's train cell at full depth; the ranks
along "model" splitting the work (each its heads, FFN columns, vocab slice
and experts; each data rank its rows of a MoE buffer);
`verify_cell` refusing to run without a card; and ``remat="dots"``:
trained on the CPU equal to the reference's ``remat="dots"`` within the
fp32 tolerance (loss 2e-5, gradients 1e-4, as tests/test_torch_train.py
holds them), its recompute FLOPs below ``"block"``'s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import models as jmodels
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import SHAPES_BY_NAME as JSHAPES
from repro_torch import models as tmodels
from repro_torch._tree import tree_items, tree_map
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, tree_to_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import close_fake_group, fake_mesh
from repro_torch.launch.plans import CellPlan
from repro_torch.models import TRAIN_4K, ShapeConfig

import torch_dist_util as du

LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
#: One period of each stack: zamba2's shared block every 6 layers, xlstm's
#: 7 mLSTM and 1 sLSTM; two layers elsewhere (an encoder-decoder also two
#: encoder layers).  xlstm's train cell takes its first two (mLSTM) blocks:
#: the sLSTM block's token loop is 4096 steps of ~90 ops on meta (a minute
#: and a half on one core); its decode cells take the sLSTM block's step.
DEPTH = {"zamba2-7b": 6, "xlstm-1.3b": 8}
TRAIN_DEPTH = {"xlstm-1.3b": 2}


def _depth(arch, shape="decode_32k"):
    if shape == "train_4k" and arch in TRAIN_DEPTH:
        return TRAIN_DEPTH[arch]
    return DEPTH.get(arch, 2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_traces_on_the_production_mesh_at_reduced_depth(arch):
    """train_4k, decode_32k and long_500k (the sweep,
    ``python -m repro_torch.launch.dryrun --all``, takes every cell at full
    depth): "ok" where the reference's
    `cell_supported` keeps the cell, its skip reason where it does not;
    one step's FLOPs, bytes, wire bytes and peak, and the kernels each
    step runs (two norms a layer and the final norm, and under block remat
    the periods' norms again; a flash forward an attention layer and again
    under remat; a decode attention an attention layer)."""
    for name in ("train_4k", "decode_32k", "long_500k"):
        row = dryrun.run_cell(arch, name, n_layers=_depth(arch, name), verbose=False)
        ok, why = jspecs.cell_supported(jget_config(arch), JSHAPES[name])
        assert row["status"] == ("ok" if ok else "skipped"), (arch, name)
        assert (row["mesh"], row["mesh_shape"], row["hw"]) == ("32x8", [32, 8],
                                                               "NVIDIA H100 SXM5 80GB")
        if not ok:
            assert row["skip_reason"] == why
            continue
        s, r = row["op_stats"], row["roofline"]
        assert s["flops"] > 0 and s["bytes"] > 0 and s["peak_bytes"] > 0
        assert r["chips"] == 256 and r["bottleneck"] in ("compute", "memory", "collective")
        assert r["t_step_s"] == max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
        assert s["scopes"]["rms_norm"] > 0
        attn = sum(k in ("attn", "moe") for k in dryrun.cut_depth(
            get_config(arch), _depth(arch, name)).layer_pattern())
        if name == "train_4k":
            assert s["wire_bytes_by_axis"]["data"] > 0          # FSDP over "data"
            mb = row["plan"]["n_microbatch"]
            assert s["scopes"].get("flash_attention", 0) % mb == 0
            assert s["scopes"].get("flash_attention", 0) >= 2 * attn * mb
        elif attn:
            assert s["scopes"]["decode_attention"] >= attn
    assert not dist.is_initialized()


def test_a_serving_prefill_traces():
    row = dryrun.run_cell("granite-3-2b", "prefill_32k", n_layers=1, verbose=False)
    assert row["status"] == "ok" and row["op_stats"]["scopes"] == {"rms_norm": 3}
    # 32 sequences over 32 data ranks: one a rank, its cache whole.
    assert row["memory"]["argument_bytes"] > 0


def test_granite_at_full_depth():
    """granite-3-2b train_4k, all 40 layers, on 256 H100s: the launches a
    step of the card's train phase (161 norms, 80 flash forwards) and the
    roofline's terms."""
    row = dryrun.run_cell("granite-3-2b", "train_4k", verbose=False)
    s, r = row["op_stats"], row["roofline"]
    assert row["status"] == "ok"
    assert s["scopes"] == {"flash_attention": 80, "rms_norm": 161}
    assert s["wire_bytes_by_axis"].keys() == {"data", "model"}
    assert 0 < r["t_memory_kernels_s"] < r["t_memory_s"]
    assert 0 < r["t_step_kernels_s"] < r["t_step_s"]
    assert r["mfu_roofline"] < 1 and r["useful_flops_ratio"] < 1


def _expert_flops(cfg, mesh_shape):
    """The FLOPs of a train step's expert products (`models.moe.expert_ffn`'s
    calls, forward and recomputed) on a rank of ``mesh_shape``, traced on
    meta, and the number of calls."""
    from repro_torch.launch.op_stats import OpStats
    from repro_torch.models import moe

    tally, calls = {}, []
    inner = moe.expert_ffn

    def counted(params, buf, cfg_):
        before = tally["t"].flops
        y = inner(params, buf, cfg_)
        calls.append(tally["t"].flops - before)
        return y

    dryrun._register_meta_kernels()
    mesh = fake_mesh(mesh_shape, ("data", "model"))
    moe.expert_ffn = counted
    try:
        run, _ = dryrun.build_step(cfg, TRAIN_4K, mesh, CellPlan())
        with OpStats(mesh) as t:
            tally["t"] = t
            run()
    finally:
        moe.expert_ffn = inner
        close_fake_group()
    return sum(calls), len(calls)


def test_the_model_ranks_split_the_work():
    """Each rank along "model" computes its own heads, FFN columns and vocab
    slice (reduced to 2 layers, qwen1.5-0.5b's 151936 ids split 8 ways): a
    rank of (32, 8) traces at most 0.14 of a (32, 1) rank's FLOPs.  A dbrx
    cut's expert products on (32, 8): each rank multiplies its data rank's
    share of the whole batch's (E, cap) buffer for its 2 of the 16 experts,
    at most twice the whole buffer's products over 256 ranks (on meta, with
    no router counts, a part's share is even)."""
    cfg = dryrun.cut_depth(get_config("qwen1.5-0.5b"), 2)
    flops = {}
    for mesh_shape in ((32, 8), (32, 1)):
        mesh = fake_mesh(mesh_shape, ("data", "model"))
        try:
            flops[mesh_shape] = dryrun.trace(cfg, TRAIN_4K, mesh, CellPlan())[0]["flops"]
        finally:
            close_fake_group()
    assert flops[(32, 8)] <= 0.14 * flops[(32, 1)]

    cfg = dryrun.cut_depth(get_config("dbrx-132b"), 1)
    got, calls = _expert_flops(cfg, (32, 8))
    cap = tmodels.moe.capacity(TRAIN_4K.global_batch * TRAIN_4K.seq_len, cfg)
    whole = 2 * cfg.n_experts * cap * cfg.d_model * cfg.d_ff * 3     # three products
    assert calls == 2 and got / calls <= 2 * whole / 256               # forward and recompute


def test_serving_on_a_mesh_gives_the_unsharded_logits(tmp_path):
    """The serving steps' mesh form on (2, 2) gloo ranks (each rank its
    rows of the batch, each period's parameters gathered) gives each rank
    the unsharded steps' logits of its rows, in fp32 within 2e-5."""
    for pairs in du.run_ranks("rank_serve_on_a_mesh", 4, tmp_path):
        assert len(pairs) == 4
        for mine, whole in pairs:
            assert mine.shape == whole.shape == (2, 1, 64)
            np.testing.assert_allclose(mine, whole, **LOSS_TOL)


def test_verify_cell_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.verify_cell("granite-3-2b", "train_4k", 2, 64, n_layers=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun.verify_cell("granite-3-2b", "decode_32k", 8, 64, n_layers=1)
    assert not dist.is_initialized()


def test_hillclimb_reaches_remat_dots(tmp_path):
    from repro_torch.launch import hillclimb
    out = tmp_path / "hc.json"
    assert hillclimb.main(["--arch", "granite-3-2b", "--shape", "decode_32k", "--layers", "1",
                           "--config", "remat=dots", "--out", str(out)]) == 0
    row = __import__("json").loads(out.read_text())
    assert row["plan"]["config_overrides"] == {"remat": "dots"}
    from repro_torch.launch.plans import PLAN_OVERRIDES
    assert not PLAN_OVERRIDES


# --------------------------------------------------------------- remat --
def _grads(tparams, tcfg, batch, loss_chunk=0):
    leaves = []

    def track(t):
        leaves.append(t.clone().requires_grad_(True))
        return leaves[-1]

    live = tree_map(track, tparams)
    loss, _ = tmodels.lm_loss(live, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                              loss_chunk=loss_chunk)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ["granite-3-2b", "seamless-m4t-large-v2"])
def test_remat_dots_trains_as_the_references(arch):
    jcfg = jmodels.reduced(jget_config(arch), vocab_size=64, remat="dots")
    tcfg = tmodels.reduced(get_config(arch), vocab_size=64, remat="dots")
    params = jmodels.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 64, size=(2, 25)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if jcfg.n_encoder_layers:
        batch["encoder_embeds"] = (rng.standard_normal((2, 16, jcfg.d_model)) * 0.5
                                   ).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodels.lm_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, loss_chunk=8)[0]))(params)
    tl, grads = _grads(tparams, tcfg, batch, loss_chunk=8)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    paths = [p for p, _ in tree_items(tparams)]
    for path, g, want in zip(paths, grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(tree_to_numpy(g), np.asarray(want), err_msg=path, **GRAD_TOL)
    block_l, block_g = _grads(tparams, dataclasses.replace(tcfg, remat="block"), batch, 8)
    assert torch.equal(block_l, tl)
    assert all(torch.equal(a, b) for a, b in zip(block_g, grads))


def test_remat_dots_recomputes_no_product():
    """On the same cell the dots policy's products are remat none's (no
    matrix product and no flash forward recomputed) and its FLOPs below
    block remat's, which recomputes every period; the norms are recomputed
    under both."""
    cfg = du.granite_cut("torch")
    shape = ShapeConfig("train_4k", "train", du.LAUNCH_SEQ, du.LAUNCH_BATCH)
    stats = {}
    for remat in ("none", "block", "dots"):
        mesh = fake_mesh((4, 1), ("data", "model"))
        try:
            stats[remat] = dryrun.trace(dataclasses.replace(cfg, remat=remat), shape, mesh,
                                        CellPlan())[0]
        finally:
            close_fake_group()
    L = cfg.n_layers
    products = {k: v["flops"] - v["flops_kernel_interior"] for k, v in stats.items()}
    assert products["dots"] == products["none"] < products["block"]
    assert stats["none"]["flops"] < stats["dots"]["flops"] < stats["block"]["flops"]
    assert stats["dots"]["scopes"] == {"flash_attention": L, "rms_norm": 4 * L + 1}
    assert stats["block"]["scopes"] == {"flash_attention": 2 * L, "rms_norm": 4 * L + 1}
    assert stats["none"]["scopes"] == {"flash_attention": L, "rms_norm": 2 * L + 1}
