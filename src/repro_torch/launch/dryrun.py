"""Dry run of every (arch × shape) cell on the production mesh, and the
verification run of one cell on the card; the port of
`repro.launch.dryrun`.

`run_cell` builds the port's own step (`make_train_step(mesh=,
strategy=)` over `state_shapes` placed by `state_specs`, or
`make_prefill_step` / `make_decode_step` over `init_lm`'s parameters
placed by `param_specs`) on tensors of the ``meta`` device, on the
production mesh of 256 (or 512) H100s over a one-process fake group
(`launch.mesh`), runs one step as rank 0 would, and tallies it
(`launch.op_stats`): no memory is allocated and no kernel runs.  The row
has the reference's keys, with ``op_stats`` in place of ``hlo_stats``:

  * ``roofline``: `RooflineTerms` of rank 0's FLOPs, bytes, wire bytes and
    peak on `H100_SXM` (the card's datasheet figures: predictions, not
    timings), and beside them ``t_memory_kernels_s`` (the kernels' own
    bytes at the memory rate) and ``t_step_kernels_s`` (the sum of each
    kernel call's least time), where the reference's ``_pallas_s`` pair
    substituted its kernels into an unfused program: the port's tally
    counts each kernel by its own work already, so the pair isolates the
    kernels' part of the step.
  * ``memory``: ``temp_bytes`` (the tally's peak of what the step
    allocated) and ``argument_bytes`` (rank 0's state, batch and cache).

Serving cells shard as the port serves on a mesh (`serve.engine`): the
batch's rows over the data axes, each rank's cache its rows of its own kv
heads.  Training and serving alike, the ranks along "model" split each
layer's heads, FFN columns and experts, and the vocab where it divides
(`parallel.context`), so a rank's FLOPs are its share of the step's; the
Mamba2 and xLSTM mixers and the norms every rank along "model" computes
alike (ROADMAP item 14a-ii).  A MoE layer's expert rows on meta, where
there are no router counts, are each data part's even share of the
buffer (`models.moe._own_rows`).

`verify_cell` is Step 6 of the adaptation flow on the card: the same step
for real on a (1, 1) mesh of one GPU, with seeded random weights, at a cut
one card holds; its measured step beside the roofline of the same cut
traced on meta.  It raises without a card.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh single --out results.json
    python -m repro_torch.launch.dryrun --all --mesh multi          # 512 H100s
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from .._tree import tree_leaves
from ..configs import ARCH_IDS, get_config
from ..models import SHAPES_BY_NAME, ModelConfig, ShapeConfig, init_cache, init_lm
from ..parallel.comm import local
from ..parallel.context import activation_sharding
from ..parallel.sharding import distribute_tree, local_batch, param_specs, state_specs
from .mesh import close_fake_group, fake_mesh, make_production_mesh, production_shape
from .op_stats import OpStats
from .plans import CellPlan, plan_for
from .roofline import H100_SXM, Hardware, RooflineTerms, mesh_name, model_flops
from .specs import cell_specs, cell_supported


def cut_depth(cfg: ModelConfig, n_layers: Optional[int]) -> ModelConfig:
    """``cfg``'s first ``n_layers`` layers (and its layer pattern's), and as
    many of an encoder-decoder's encoder layers; ``cfg`` itself for None."""
    if n_layers is None:
        return cfg
    pattern = cfg.block_pattern and cfg.block_pattern[:n_layers]
    return dataclasses.replace(cfg, n_layers=n_layers, block_pattern=pattern,
                               n_encoder_layers=min(cfg.n_encoder_layers, n_layers))


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: CellPlan,
               device="meta", generator: Optional[torch.Generator] = None):
    """(run, inputs) of one step of the cell on ``mesh``: ``run()`` takes
    the step once (a train step updates the state in place).  On the meta
    device nothing is allocated; elsewhere the state is ``generator``'s
    random weights and the batch random tokens from it."""
    from ..serve.engine import make_decode_step, make_prefill_step
    from ..train import init_state, make_optimizer, make_train_step

    cfg = plan.apply_config(cfg)
    strat = plan.strategy(mesh)
    specs = cell_specs(cfg, shape)
    real = torch.device(device).type != "meta"

    def fill(t):
        """A real tensor of ``t``'s shape and type on ``device``."""
        if not t.dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, t.shape, generator=generator,
                                 device=device, dtype=t.dtype)
        return torch.randn(t.shape, generator=generator, device=device).to(t.dtype)

    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        step = make_train_step(cfg, opt, loss_chunk=plan.loss_chunk,
                               n_microbatch=plan.n_microbatch, mesh=mesh, strategy=strat)
        state = init_state(generator, cfg, opt, device=device)
        state = distribute_tree(state, state_specs(state, mesh, strat), mesh)
        batch = {k: fill(v) if real else v for k, v in specs["batch"].items()}
        box = {"state": state}

        def run():
            box["state"], metrics = step(box["state"], batch)
            return metrics["loss"]
        return run, (state, batch)

    params = init_lm(generator, cfg, device=device)
    params = distribute_tree(params, param_specs(params, mesh, strat), mesh)
    if shape.kind == "prefill":
        cross = shape.seq_len if cfg.n_encoder_layers else 0
        step = make_prefill_step(cfg, max_len=shape.seq_len, cross_len=cross, device=device,
                                 mesh=mesh, strategy=strat)
        batch = {k: fill(v) if real else v for k, v in specs["batch"].items()}
        return (lambda: step(params, batch)[1]), (params, batch)

    step = make_decode_step(cfg, mesh=mesh, strategy=strat)
    # The cache holds this rank's rows, those the step cuts from the tokens,
    # of its kv heads.
    rows = local_batch({"tokens": specs["tokens"]}, mesh, strat)["tokens"].shape[0]
    cross = shape.seq_len if cfg.n_encoder_layers else 0
    with activation_sharding(mesh, strat):
        cache = init_cache(cfg, rows, shape.seq_len, cross_len=cross, device=device)
    # Every slot holds seq_len - 1 entries, and the new token fills the last.
    if real:
        cache["index"].fill_(shape.seq_len - 1)
    tokens = fill(specs["tokens"]) if real else specs["tokens"]
    return (lambda: step(params, cache, tokens)[1]), (params, cache, tokens)


_META_LIBRARY = []


def _register_meta_kernels() -> None:
    """Meta kernels of the ops the port's steps take that PyTorch has none
    for: `bincount`, whose length on meta is its ``minlength`` (the MoE
    layer counts expert ids below it).  Registered once a process, at the
    first trace, for the ``meta`` device only."""
    if _META_LIBRARY:
        return
    lib = torch.library.Library("aten", "IMPL")

    def bincount(x, weights=None, minlength=0):
        dtype = torch.int64 if weights is None else weights.dtype
        return torch.empty((minlength,), dtype=dtype, device="meta")

    lib.impl("bincount", bincount, "Meta")
    _META_LIBRARY.append(lib)


def _nbytes(tree) -> float:
    return float(sum(local(t).numel() * local(t).element_size() for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


def trace(cfg: ModelConfig, shape: ShapeConfig, mesh, plan: CellPlan,
          hw: Hardware = H100_SXM) -> Tuple[Dict[str, Any], float, float]:
    """(op_stats row, argument bytes, seconds) of one step of the cell on
    ``mesh``, traced on the meta device."""
    _register_meta_kernels()
    t0 = time.perf_counter()
    run, inputs = build_step(cfg, shape, mesh, plan)
    with OpStats(mesh, hw) as tally:
        run()
    return tally.row(), _nbytes(inputs), time.perf_counter() - t0


def roofline_row(arch: str, shape: ShapeConfig, mesh_shape, stats: Dict[str, Any],
                 cfg: ModelConfig, hw: Hardware = H100_SXM) -> Dict[str, Any]:
    chips = math.prod(mesh_shape)
    terms = RooflineTerms(arch=arch, shape=shape.name, mesh=mesh_name(mesh_shape), chips=chips,
                          flops_per_device=stats["flops"], bytes_per_device=stats["bytes"],
                          wire_bytes_by_axis=stats["wire_bytes_by_axis"],
                          model_flops_total=model_flops(cfg, shape),
                          peak_memory_bytes=stats["peak_bytes"], hw=hw)
    row = terms.row()
    row["t_memory_kernels_s"] = stats["bytes_kernel_interior"] / hw.hbm_bw
    row["t_step_kernels_s"] = stats["kernel_bound_s"]
    return row


def _plan_row(plan: CellPlan) -> Dict[str, Any]:
    return {"n_microbatch": plan.n_microbatch, "loss_chunk": plan.loss_chunk,
            "strategy_overrides": plan.strategy_overrides,
            "config_overrides": plan.config_overrides}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True,
             n_layers: Optional[int] = None, hw: Hardware = H100_SXM) -> Dict[str, Any]:
    """The dry run of one cell on the production mesh (the module's
    docstring); ``n_layers`` cuts the depth (None: the config's)."""
    cfg = cut_depth(get_config(arch), n_layers)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_shape, _ = production_shape(multi_pod)
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh_shape),
                              "mesh_shape": list(mesh_shape), "hw": hw.name,
                              "cut": {"n_layers": n_layers} if n_layers else None}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        result["status"] = "skipped"
        result["skip_reason"] = why
        return result
    plan = plan_for(arch, shape)
    result["plan"] = _plan_row(plan)
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        stats, arg_bytes, seconds = trace(cfg, shape, mesh, plan, hw)
    finally:
        close_fake_group()
    roofline = roofline_row(arch, shape, mesh_shape, stats, plan.apply_config(cfg), hw)
    result.update({
        "status": "ok",
        "t_trace_s": seconds,
        "memory": {"temp_bytes": stats["peak_bytes"], "argument_bytes": arg_bytes},
        "op_stats": stats,
        "roofline": roofline,
    })
    if verbose:
        r = roofline
        print(f"[{arch} × {shape_name} × {result['mesh']}] OK trace={seconds:.1f}s")
        print(f"  memory: temp={_gb(stats['peak_bytes'])} args={_gb(arg_bytes)}")
        print(f"  op_stats: flops/dev={stats['flops']:.3e} bytes/dev={stats['bytes']:.3e} "
              f"wire/dev={_gb(stats['wire_bytes'])} colls={int(stats['n_collectives'])} "
              f"scopes={stats['scopes']}")
        print(f"  roofline: compute={r['t_compute_s']:.4f}s memory={r['t_memory_s']:.4f}s "
              f"(kernels {r['t_memory_kernels_s']:.4f}s) "
              f"collective={r['t_collective_s']:.4f}s → {r['bottleneck']} | "
              f"useful={r['useful_flops_ratio']:.2f} mfu@roofline={r['mfu_roofline']:.2%}")
    return result


def _gb(x) -> str:
    return "n/a" if x is None else f"{x / 2**30:.2f}GiB"


# ------------------------------------------------------------ on the card --
#: The profiler's kernel names of each kernel wrapper.
_KERNEL_NAMES = {"rms_norm": ("rms_norm_kernel",),
                 "decode_attention": ("decode_partial_kernel", "decode_bf16_tc_kernel"),
                 "flash_attention": ("flash_fwd_kernel", "flash_fwd_bf16_kernel"),
                 "ssm_scan": ("ssm_scan_kernel", "ssm_scan_bf16_kernel")}


def _wrapper_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far."""
    from ..kernels import decode_attention, flash_attention, rmsnorm, ssm_scan

    return {"rms_norm": rmsnorm.rms_norm.launches,
            "decode_attention": decode_attention.decode_attention.launches,
            "flash_attention": flash_attention.flash_attention.launches,
            "ssm_scan": ssm_scan.ssm_scan.launches}


#: The CUDA runtime's calls that put work on the card, as the profiler
#: names them.
_RUNTIME_CALLS = ("LaunchKernel", "Memcpy", "Memset")


def _profiled_launches(events) -> Tuple[Dict[str, int], int]:
    """(the launches of each of the port's kernels in a `torch.profiler`
    trace of the host and the card, the records the trace lost: the
    runtime's launches and copies whose device record it lacks, matched by
    correlation id)."""
    from torch.autograd import DeviceType

    counts = {name: 0 for name in _KERNEL_NAMES}
    on_card, launched = set(), set()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            on_card.add(e.correlation_id())
            for name, prefixes in _KERNEL_NAMES.items():
                if any(p in e.name() for p in prefixes):
                    counts[name] += 1
        elif e.correlation_id() and any(c in e.name() for c in _RUNTIME_CALLS):
            launched.add(e.correlation_id())
    return counts, len(launched - on_card)


def _one_rank_mesh(device: torch.device, store: Path):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group whose
    FileStore is ``store``; the caller destroys the group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x.float()).all())


def verify_cell(arch: str, shape_name: str, batch: int, seq_len: int,
                n_layers: Optional[int] = None, steps: int = 3, device="cuda",
                plan: Optional[CellPlan] = None, hw: Hardware = H100_SXM) -> Dict[str, Any]:
    """Step 6 on the card: the cell's step (``shape_name``'s kind at
    ``batch`` x ``seq_len``, ``n_layers`` deep; ``plan`` by default the
    cell's) for real on a (1, 1) mesh of one GPU, random weights and
    tokens from seed 0.  Runs ``steps`` steps (host-clock seconds each,
    to a synchronise), then one more under the tally and `torch.profiler`
    together (the profiler's warm-up cycle first).  Returns the row: the steps' seconds and median, the peak
    memory, the same cut traced on meta (``op_stats``, ``roofline``),
    ``roofline_share`` = the roofline step over the measured median, the
    profiler's launches of each kernel beside the tally's scopes.  Raises
    where there is no card, where a step's loss or logits are not finite,
    where the card's tally and the meta trace differ in FLOPs, or where the
    scopes differ from the profiler's launches: no path carries on
    without the card."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, schedule

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"verify_cell runs on a CUDA device; {device} is not one "
                           f"(cuda available: {torch.cuda.is_available()})")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        raise RuntimeError("verify_cell opens its own one-rank process group; one is open")
    cfg = cut_depth(get_config(arch), n_layers)
    base = SHAPES_BY_NAME[shape_name]
    shape = dataclasses.replace(base, global_batch=batch, seq_len=seq_len)
    plan = plan or plan_for(arch, shape)
    row: Dict[str, Any] = {"arch": arch, "shape": shape_name, "kind": shape.kind,
                           "cut": {"n_layers": n_layers, "batch": batch, "seq_len": seq_len},
                           "mesh": "1x1", "mesh_shape": [1, 1], "hw": hw.name,
                           "device": torch.cuda.get_device_name(device), "plan": _plan_row(plan)}

    meta_mesh = fake_mesh((1, 1), ("data", "model"))
    try:
        stats, arg_bytes, trace_s = trace(cfg, shape, meta_mesh, plan, hw)
    finally:
        close_fake_group()

    scratch = tempfile.TemporaryDirectory(prefix="repro_torch_verify_")
    mesh = _one_rank_mesh(device, Path(scratch.name) / "store")
    try:
        torch.cuda.reset_peak_memory_stats(device)
        generator = torch.Generator(device).manual_seed(0)
        run, _ = build_step(cfg, shape, mesh, plan, device=device, generator=generator)
        seconds = []
        for i in range(steps):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            if not _finite(out):
                raise RuntimeError(f"verify_cell: step {i} of {arch} {shape_name} is not finite")
        peak = torch.cuda.max_memory_allocated(device)
        before = _wrapper_launches()
        # A warm-up cycle first: the first records of a trace can be lost
        # (1 to 14 of a step's, H100, torch 2.11), and the recorded cycle
        # starts with the trace already running.  Records can still be lost
        # later in a process that traced much before (5 of 26,794 a train
        # step): `_profiled_launches` counts them.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(64):
                torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)
            prof.step()
            with OpStats(mesh, hw) as tally:
                out = run()
            torch.cuda.synchronize(device)
            prof.step()
        counted = {k: n - before[k] for k, n in _wrapper_launches().items()}
        if not _finite(out):
            raise RuntimeError(f"verify_cell: the traced step of {arch} {shape_name} "
                               f"is not finite")
    finally:
        dist.destroy_process_group()
        scratch.cleanup()
    card = tally.row()
    launches, lost = _profiled_launches(prof.profiler.kineto_results.events())
    scopes = {k: card["scopes"].get(k, 0) for k in launches}
    if card["flops"] != stats["flops"]:
        raise RuntimeError(f"verify_cell: {card['flops']:.6e} FLOPs on the card, "
                           f"{stats['flops']:.6e} traced on meta")
    # A lost record only lowers a count, so launches equal to the scopes are
    # the step's whole; short of them, the trace's losses leave it open.
    if scopes != launches or card["scopes"] != stats["scopes"]:
        raise RuntimeError(f"verify_cell: kernel scopes {card['scopes']} on the card, "
                           f"{stats['scopes']} on meta, profiler launches {launches} "
                           f"(the trace lost {lost} records), the wrappers' launch "
                           f"counts {counted}")
    median = statistics.median(seconds)
    roofline = roofline_row(arch, shape, (1, 1), stats, plan.apply_config(cfg), hw)
    row.update({
        "status": "ok", "steps": steps, "step_seconds": seconds, "median_step_s": median,
        "peak_memory_bytes": peak, "t_trace_s": trace_s,
        "memory": {"temp_bytes": stats["peak_bytes"], "argument_bytes": arg_bytes},
        "op_stats": stats, "roofline": roofline,
        "roofline_share": roofline["t_step_s"] / median,
        "card_flops": card["flops"], "card_bytes": card["bytes"],
        "card_scopes": card["scopes"], "profiler_launches": launches,
        "profiler_lost_records": lost, "wrapper_launches": counted,
        "steps_run": steps + 1})
    return row


# ---------------------------------------------------------------- CLI ----
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default=None, help="write JSON results")
    ap.add_argument("--optimized", action="store_true",
                    help="use the reference's tuned plans instead of the baselines")
    args = ap.parse_args(argv)
    if args.optimized:
        from .plans import use_optimized_plans
        use_optimized_plans()

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES_BY_NAME]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--all or (--arch and --shape)")

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    results = []
    failed = 0
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            try:
                results.append(run_cell(arch, shape, mp))
            except Exception as e:  # noqa: BLE001 — record and continue
                failed += 1
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": mesh_name(production_shape(mp)[0]),
                                "status": "failed", "error": f"{type(e).__name__}: {e}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r["status"] == "ok")
    sk = sum(1 for r in results if r["status"] == "skipped")
    print(f"\n== dry-run: {ok} ok, {sk} skipped, {failed} failed, "
          f"{len(results)} total, {time.perf_counter() - t0:.1f}s ==")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
