#!/usr/bin/env python3
"""How far bf16 training of the xLSTM cut lies from fp32 when nothing but
the rounding of its norms changes.

    python3 tools/xlstm_bf16_spread.py        # one CUDA device, ~2 minutes

Runs the steps of `chip_smoke.py`'s ``train_vs_fp32_xlstm`` (xlstm-1.3b
cut to 9 blocks, bf16, 2 x 2048 tokens, 2 AdamW steps from one state) with
the `rms_norm` kernel, with its plain version, and with two other plain
roundings of the same norm (computed in float64 and rounded once; the mean
of squares through `torch.linalg.vector_norm`), beside the same steps in
fp32.  Prints one JSON object: each run's (loss, gradient norm) a step and
its loss's distance from the fp32 run's, on its own trajectory and at the
fp32 run's parameters (``at_fp32_points``).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def exact64(x, scale, eps):
    xd = x.double()
    return (xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + eps)
            * scale.double()).to(x.dtype)


def vector_norm(x, scale, eps):
    xf = x.float()
    var = torch.linalg.vector_norm(xf, dim=-1, keepdim=True).square() / x.shape[-1]
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def main():
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("xlstm_bf16_spread: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    full = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(full, n_layers=cs.XLSTM_CUT_LAYERS,
                              block_pattern=full.block_pattern[:cs.XLSTM_CUT_LAYERS])
    out = {}
    for at in (False, True):
        runs = {}
        for name, norm in (("plain", None), ("plain_float64_norm", exact64),
                           ("plain_vector_norm_norm", vector_norm)):
            inner = ops._rmsnorm.rms_norm_plain
            if norm is not None:
                ops._rmsnorm.rms_norm_plain = norm
            try:
                _, got, _ = cs.train_twice(torch, cfg, device, 2048, 2, fp32_ref=True,
                                           at_fp32_points=at)
            finally:
                ops._rmsnorm.rms_norm_plain = inner
            runs[name] = got["plain"][1]
            runs["kernel"], runs["fp32"] = got["kernel"][1], got["fp32"][1]
            del got
        ref = runs["fp32"]
        out["at_fp32_points" if at else "own_trajectory"] = dict(
            runs=runs, loss_abs_vs_fp32={name: [abs(a[0] - b[0]) for a, b in zip(r, ref)]
                                         for name, r in runs.items() if name != "fp32"})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(card=smi.strip(), model=cfg.name, blocks=cfg.n_layers, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
