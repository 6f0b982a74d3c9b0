#!/usr/bin/env python3
"""The parallel layer's multi-rank checks on four GPUs over NCCL.

    python3 tools/multi_gpu_check.py                # 4 CUDA devices, NCCL
    python3 tools/multi_gpu_check.py --device cpu   # the same on 4 gloo ranks

Runs the CPU tests' own rank functions and checks (`tests/torch_dist_util.py`,
the checks against the port's unsharded runs, not those against the JAX
package) on 4 ranks, one GPU each, in fp32 with TF32 off, at the tests'
small sizes:

  training    reduced granite-3-2b on a (2, 2) ("data", "model") mesh with
              each optimizer; a dbrx cut with the default strategy (the MoE
              layer over the whole batch, assignments dropping) and with the
              expert-parallel one: losses, gradient norms and parameters
              against the unsharded runs
  elastic     reduced granite trained on (2, 2), saved, rescaled onto (1, 2)
              by `ElasticSupervisor`: every leaf bit for bit, and the losses
              against the uninterrupted unsharded run
  pipeline    4 stages over a ("pod",) mesh, 6 microbatches: outputs and
              gradients against the unpipelined run
  compressed  the int8 compressed mean over 4 ranks: within one int8 step of
              each block of the exact mean, the residual exact, and error
              feedback that does not drift

Prints one JSON object a check (with its seconds), the card's name and
power limit, and last {"ok": ..., "device": {...}}; exits 1 if a check
fails.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import torch_dist_util as du  # noqa: E402

WORLD = 4

# name: (rank function, its arguments, the checks of its results)
CHECKS = {
    "training": ("rank_training_cases", {"steps": 3}, lambda rs: (
        [du.check_optimizer([r["optimizers"] for r in rs], n) for n in du.OPTIMIZER_CASES],
        du.check_dbrx([r["dbrx"] for r in rs]),
        du.check_dbrx_ep([r["dbrx_ep"] for r in rs]))),
    "elastic": ("rank_elastic", {}, lambda rs: (
        du.check_rescale_losses(rs, rs[0]["plain_losses"]), du.check_rescale_restores(rs))),
    "pipeline": ("rank_pipeline", {}, lambda rs: (
        du.check_pipeline_outputs(rs), du.check_pipeline_gradients(rs))),
    "compressed": ("rank_collectives", {}, lambda rs: (
        du.check_compressed_mean(rs), du.check_error_feedback(rs))),
}


def emit(**obj):
    print(json.dumps(obj), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        print(f"multi_gpu_check: needs {WORLD} CUDA devices, has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    ok, t_all = True, time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        for name, (fn, kw, check) in CHECKS.items():
            t0 = time.perf_counter()
            try:
                check(du.run_ranks(fn, WORLD, Path(workdir) / name, timeout=600,
                                   device_type=args.device, **kw))
                emit(check=name, ok=True, seconds=time.perf_counter() - t0)
            except AssertionError:
                ok = False
                emit(check=name, ok=False, seconds=time.perf_counter() - t0,
                     error=traceback.format_exc()[-3000:])
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    emit(seconds=time.perf_counter() - t_all, world=WORLD,
         backend="nccl" if args.device == "cuda" else "gloo")
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    emit(ok=ok, device={"platform": "gpu" if args.device == "cuda" else "cpu", "kind": kind,
                        "count": torch.cuda.device_count()})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
