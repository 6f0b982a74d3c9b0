"""The port's launch layer and plan search against the JAX package's, under
the reference's constants: a `Hardware` built from
`repro.launch.roofline`'s numbers makes `estimate`, `search_plan`,
`size_resources` and the rest return exactly what the reference returns
(exact equality: the same arithmetic in the same order); the H100's own
constants; the input specs, leaf by leaf, for all 40 cells; the production
mesh over a fake process group."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.core import adaptation as jadapt
from repro.core import shard_search as jsearch
from repro.launch import analytic as janalytic
from repro.launch import plans as jplans
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.models import SHAPES_BY_NAME as JSHAPES
from repro_torch._tree import tree_items
from repro_torch.configs import get_config
from repro_torch.core import adaptation as tadapt
from repro_torch.core import ga as tga
from repro_torch.core import shard_search as tsearch
from repro_torch.launch import analytic as tanalytic
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import plans as tplans
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs
from repro_torch.models import SHAPES_BY_NAME

import torch_dist_util as du

#: The reference's v5e constants as the port's `Hardware`: one link
#: bandwidth for every mesh axis, so the collective term is the reference's.
REF_HW = troof.Hardware(
    name="reference constants", peak_flops_bf16=jroof.PEAK_FLOPS_BF16,
    peak_flops_fp32=jroof.PEAK_FLOPS_BF16, hbm_bw=jroof.HBM_BW, hbm_bytes=jroof.HBM_BYTES,
    intra_node_bw=jroof.ICI_LINKS_PER_CHIP * jroof.ICI_LINK_BW,
    inter_node_bw=jroof.ICI_LINKS_PER_CHIP * jroof.ICI_LINK_BW)
SHAPES = list(JSHAPES)
MESHES = [(16, 16), (32, 16), (32, 8)]
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def _jplan(plan):
    """The reference's `CellPlan` of the port's."""
    return jplans.CellPlan(plan.n_microbatch, plan.loss_chunk, dict(plan.strategy_overrides),
                           dict(plan.config_overrides))


def _same_plan(t, j):
    return (t.n_microbatch, t.loss_chunk, t.strategy_overrides, t.config_overrides) == \
        (j.n_microbatch, j.loss_chunk, j.strategy_overrides, j.config_overrides)


def test_h100_constants():
    hw = troof.H100_SXM
    assert (hw.peak_flops_bf16, hw.peak_flops_fp32, hw.hbm_bw, hw.hbm_bytes) == \
        (989e12, 67e12, 3.35e12, 80e9)
    assert (hw.intra_node_bw, hw.inter_node_bw) == (450e9, 50e9)
    assert hw.axis_bw("model") == 450e9
    assert hw.axis_bw("data") == hw.axis_bw("pod") == hw.axis_bw("world") == 50e9
    assert hw.peak("float32") == 67e12 and hw.peak("bfloat16") == 989e12
    with pytest.raises(dataclasses.FrozenInstanceError):
        hw.hbm_bw = 1.0


def test_collective_term_takes_each_axis_at_its_bandwidth():
    wire = [("model", 450e9), ("data", 100e9), ("model", 900e9)]
    assert troof.t_collective(wire) == 3.0 + 2.0
    assert troof.t_collective(wire, REF_HW) == (450e9 + 100e9 + 900e9) / 100e9
    assert troof.t_collective([]) == 0.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    t, j = get_config(arch), jget_config(arch)
    assert troof.active_params(t) == jroof.active_params(j)
    for name in SHAPES:
        assert troof.model_flops(t, SHAPES_BY_NAME[name]) == jroof.model_flops(j, JSHAPES[name])


def test_roofline_terms_under_the_reference_constants():
    t = troof.RooflineTerms("a", "s", "16x16", 256, 3e12, 5e11, {"model": 4e9, "data": 6e9},
                            1e15, hw=REF_HW)
    j = jroof.RooflineTerms("a", "s", "16x16", 256, 3e12, 5e11, 10e9, 1e15)
    for key in ("t_compute", "t_memory", "t_collective", "t_step", "bottleneck",
                "useful_flops_ratio", "mfu_roofline"):
        assert getattr(t, key) == getattr(j, key), key
    assert t.row()["hw"] == "reference constants"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_equal_the_reference(arch):
    for name in SHAPES:
        t = tplans.default_plan(get_config(arch), SHAPES_BY_NAME[name])
        j = jplans.default_plan(jget_config(arch), JSHAPES[name])
        assert _same_plan(t, j)
        assert _same_plan(tplans.plan_for(arch, SHAPES_BY_NAME[name]),
                          jplans.plan_for(arch, JSHAPES[name]))


def test_optimized_plans_equal_the_reference_and_name_no_tpu_speed():
    assert set(tplans.OPTIMIZED_PLANS) == set(jplans.OPTIMIZED_PLANS)
    for key, plan in tplans.OPTIMIZED_PLANS.items():
        assert _same_plan(plan, jplans.OPTIMIZED_PLANS[key])
        assert "x step" not in plan.notes and "reference" in plan.notes
    assert not tplans.PLAN_OVERRIDES


def test_plan_strategy_is_the_ports():
    from repro_torch.parallel.sharding import ShardingStrategy

    class Mesh:
        mesh_dim_names = ("data", "model")

    plan = tplans.OPTIMIZED_PLANS[("qwen2-vl-2b", "train_4k")]
    strat = plan.strategy(Mesh())
    assert isinstance(strat, ShardingStrategy)
    assert (strat.dp, strat.tp, strat.fsdp, strat.seq) == (("data", "model"), None, "model",
                                                           None)
    assert tplans.CellPlan().strategy(Mesh()) == ShardingStrategy(dp=("data",))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_estimate_equals_the_reference_bit_for_bit(mesh):
    for arch, name in CELLS:
        tcfg, jcfg = get_config(arch), jget_config(arch)
        plan = tplans.plan_for(arch, SHAPES_BY_NAME[name])
        for p in (None, plan, dataclasses.replace(plan, n_microbatch=4, loss_chunk=1024)):
            t = tanalytic.estimate(tcfg, SHAPES_BY_NAME[name], mesh, p, hw=REF_HW)
            j = janalytic.estimate(jcfg, JSHAPES[name], mesh, None if p is None else _jplan(p))
            assert (t.t_compute, t.t_memory, t.t_collective, t.t_step) == \
                (j.t_compute, j.t_memory, j.t_collective, j.t_step), (arch, name, p)


def test_estimate_on_the_h100_separates_the_axes():
    """On the H100 the model axis's psums go at NVLink's rate and the
    gradient reduction at the network's: the same bytes as the reference's
    formula, split by axis."""
    cfg, shape = get_config("granite-3-2b"), SHAPES_BY_NAME["train_4k"]
    ref = tanalytic.estimate(cfg, shape, (32, 8), hw=REF_HW)
    one_bw = dataclasses.replace(troof.H100_SXM, intra_node_bw=50e9)
    h100 = tanalytic.estimate(cfg, shape, (32, 8))
    slow = tanalytic.estimate(cfg, shape, (32, 8), hw=one_bw)
    wire = ref.t_collective * REF_HW.inter_node_bw
    assert slow.t_collective == pytest.approx(wire / 50e9, rel=1e-12)
    assert h100.t_collective < slow.t_collective
    assert h100.t_compute == pytest.approx(ref.t_compute * REF_HW.peak_flops_bf16 / 989e12,
                                           rel=1e-12)


def test_calibrate_reads_the_ports_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(tanalytic, "SCALE", dict(tanalytic.SCALE))
    cfg, shape = get_config("granite-3-2b"), SHAPES_BY_NAME["train_4k"]
    est = tanalytic.estimate(cfg, shape, (32, 8), tplans.plan_for("granite-3-2b", shape),
                             scale={"compute": 1, "memory": 1, "collective": 1})
    cut = dataclasses.replace(shape, global_batch=2, seq_len=64)
    small = tanalytic.estimate(dryrun.cut_depth(cfg, 2), cut, (1, 1),
                               tplans.plan_for("granite-3-2b", cut),
                               scale={"compute": 1, "memory": 1, "collective": 1})
    rows = [{"arch": "granite-3-2b", "shape": "train_4k", "status": "ok",
             "roofline": {"t_compute_s": 2 * est.t_compute, "t_memory_s": 3 * est.t_memory,
                          "t_collective_s": 0.5 * est.t_collective}},
            {"arch": "granite-3-2b", "shape": "long_500k", "status": "skipped"},
            # a verification row: its cut and its (1, 1) mesh
            {"arch": "granite-3-2b", "shape": "train_4k", "status": "ok", "mesh_shape": [1, 1],
             "cut": {"n_layers": 2, "batch": 2, "seq_len": 64},
             "roofline": {"t_compute_s": 2 * small.t_compute, "t_memory_s": 3 * small.t_memory,
                          "t_collective_s": 0.0}}]
    path = tmp_path / "rows.json"
    path.write_text(__import__("json").dumps(rows))
    scale = tanalytic.calibrate(str(path))
    assert scale == pytest.approx({"compute": 2, "memory": 3, "collective": 0.5}, rel=1e-12)
    assert tanalytic.SCALE == scale


def test_gene_space_equals_the_reference():
    assert (tsearch.MICROBATCH, tsearch.LOSS_CHUNK, tsearch.FSDP, tsearch.SEQ) == \
        (jsearch.MICROBATCH, jsearch.LOSS_CHUNK, jsearch.FSDP, jsearch.SEQ)
    genes = [(a, b, c, d) for a in range(6) for b in range(5) for c in range(2)
             for d in range(2)]
    for g in genes:
        t, j = tsearch.gene_to_plan(g), jsearch.gene_to_plan(g)
        assert _same_plan(t, j)
        assert tsearch.plan_to_gene(t) == jsearch.plan_to_gene(j) == g
    odd = tplans.CellPlan(n_microbatch=3, loss_chunk=7)
    assert tsearch.plan_to_gene(odd) == jsearch.plan_to_gene(_jplan(odd))


def test_the_ga_is_the_references():
    fit = lambda g: -float(sum((x - 2) ** 2 for x in g))
    t = tga.GeneticSearch([5, 3, 4], fit, rng=np.random.default_rng(3)).run([(0, 0, 0)])
    from repro.core import ga as jga
    j = jga.GeneticSearch([5, 3, 4], fit, rng=np.random.default_rng(3)).run([(0, 0, 0)])
    assert (t.best_gene, t.best_fitness, t.history, t.evaluations) == \
        (j.best_gene, j.best_fitness, j.history, j.evaluations)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_search_plan_equals_the_reference(arch):
    for name in ("train_4k", "decode_32k"):
        base = tplans.plan_for(arch, SHAPES_BY_NAME[name])
        t = tsearch.search_plan(get_config(arch), SHAPES_BY_NAME[name], (16, 16), baseline=base,
                                rng=np.random.default_rng(0), hw=REF_HW)
        j = jsearch.search_plan(jget_config(arch), JSHAPES[name], (16, 16),
                                baseline=_jplan(base), rng=np.random.default_rng(0))
        assert _same_plan(t.best_plan, j.best_plan)
        assert (t.best_t_step, t.baseline_t_step, t.ga.history) == \
            (j.best_t_step, j.baseline_t_step, j.ga.history)


def test_search_plan_defaults_to_the_card():
    cfg, shape = get_config("granite-3-2b"), SHAPES_BY_NAME["train_4k"]
    a = tsearch.search_plan(cfg, shape)
    b = tsearch.search_plan(cfg, shape, (32, 8), hbm_budget_bytes=80e9,
                            rng=np.random.default_rng(0))
    assert _same_plan(a.best_plan, b.best_plan) and a.best_t_step == b.best_t_step
    assert a.speedup >= 1.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyze_and_size_resources_equal_the_reference(arch):
    t = tadapt.AdaptationController(mesh_shape=(16, 16), hw=REF_HW)
    j = jadapt.AdaptationController(mesh_shape=(16, 16))
    tcfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(t.analyze(tcfg)) == dataclasses.asdict(j.analyze(jcfg))
    assert t.extract_offloadable(t.analyze(tcfg)) == j.extract_offloadable(j.analyze(jcfg))
    for name in SHAPES:
        plan = tplans.plan_for(arch, SHAPES_BY_NAME[name])
        for slo in (None, 1.0):
            assert t.size_resources(tcfg, SHAPES_BY_NAME[name], plan, slo) == \
                j.size_resources(jcfg, JSHAPES[name], _jplan(plan), slo)


def test_run_all_without_a_scheduler_is_the_references():
    t = tadapt.AdaptationController(mesh_shape=(16, 16), hw=REF_HW)
    j = jadapt.AdaptationController(mesh_shape=(16, 16))
    for arch in ("granite-3-2b", "dbrx-132b"):
        a = t.run_all(get_config(arch), SHAPES_BY_NAME["train_4k"])
        b = j.run_all(jget_config(arch), JSHAPES["train_4k"])
        assert (a["chips"], a["t_step"], a["offload"], a["pod"]) == \
            (b["chips"], b["t_step"], b["offload"], b["pod"]) and a["pod"] is None
        assert _same_plan(a["search"].best_plan, b["search"].best_plan)
    assert t.operate() == [] == j.operate()


def test_steps_five_and_seven_wait_for_item_17():
    with pytest.raises(NotImplementedError, match="item 17"):
        tadapt.AdaptationController(scheduler=object())
    c = tadapt.AdaptationController()
    assert (c.mesh_shape, c.hbm_bytes, c.hw) == ((32, 8), 80e9, troof.H100_SXM)
    with pytest.raises(NotImplementedError, match="item 17"):
        c.place(None)


def test_verify_on_card_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        tadapt.AdaptationController().verify_on_card("granite-3-2b", "train_4k", 2, 64,
                                                     n_layers=1, device="cpu")


def _dtype_name(d):
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference_leaf_by_leaf(arch):
    for name in SHAPES:
        j, t = jspecs.input_specs(arch, name), tspecs.input_specs(arch, name)
        assert (t["supported"], t["skip_reason"]) == (j["supported"], j["skip_reason"])
        assert tspecs.cell_supported(t["cfg"], t["shape"]) == \
            jspecs.cell_supported(j["cfg"], j["shape"])
        keys = [k for k in ("batch", "cache", "tokens") if k in j]
        assert keys == [k for k in ("batch", "cache", "tokens") if k in t]
        for key in keys:
            jf = du.jax_flat(j[key]) if key != "tokens" else {"": j[key]}
            tf = dict(tree_items(t[key], sep="/")) if key != "tokens" else {"": t[key]}
            assert sorted(jf) == sorted(tf), (arch, name, key)
            for path, leaf in jf.items():
                got = tf[path]
                assert got.is_meta, path
                assert (tuple(got.shape), _dtype_name(got.dtype)) == \
                    (tuple(leaf.shape), leaf.dtype.name), (arch, name, key, path)


def test_production_mesh_over_a_fake_group_and_its_teardown():
    assert not dist.is_initialized()
    try:
        for _ in range(2):
            mesh = tmesh.make_production_mesh()
            assert tuple(mesh.shape) == (32, 8) and mesh.mesh_dim_names == ("data", "model")
            assert dist.get_world_size() == 256 and tuple(mesh.get_coordinate()) == (0, 0)
            x = torch.empty(4, 8, device="meta")
            parts = [torch.empty_like(x) for _ in range(8)]
            dist.all_gather(parts, x, group=mesh.get_group(1))
            multi = tmesh.make_production_mesh(multi_pod=True)
            assert tuple(multi.shape) == (2, 32, 8)
            assert multi.mesh_dim_names == ("pod", "data", "model")
            assert dist.get_world_size() == 512
            tmesh.close_fake_group()
            assert not dist.is_initialized()
    finally:
        tmesh.close_fake_group()


def test_a_real_group_of_another_size_is_not_replaced(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group"):
            tmesh.make_production_mesh()
        mesh = tmesh.make_host_mesh()
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()
