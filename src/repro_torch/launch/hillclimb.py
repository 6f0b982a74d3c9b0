"""Hillclimb: re-measure one cell under an explicit plan; the port of
`repro.launch.hillclimb`, over the port's dry run (`dryrun.run_cell`).

    python -m repro_torch.launch.hillclimb --arch qwen1.5-110b --shape train_4k \\
        --config remat=dots --strategy moe=ep_shardmap --microbatch 8 \\
        --out results/hc1.json

Every invocation is one hypothesis→change→measure iteration.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _parse_kv(pairs):
    out = {}
    for kv in pairs or []:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        elif v.lower() in ("none", "null"):
            out[k] = None
        elif "+" in v:
            out[k] = tuple(v.split("+"))
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--config", action="append", metavar="K=V")
    ap.add_argument("--strategy", action="append", metavar="K=V")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--loss-chunk", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..models import SHAPES_BY_NAME
    from .dryrun import run_cell
    from .plans import PLAN_OVERRIDES, plan_for

    base = plan_for(args.arch, SHAPES_BY_NAME[args.shape])
    plan = dataclasses.replace(
        base,
        n_microbatch=args.microbatch if args.microbatch is not None else base.n_microbatch,
        loss_chunk=args.loss_chunk if args.loss_chunk is not None else base.loss_chunk,
        strategy_overrides={**base.strategy_overrides, **_parse_kv(args.strategy)},
        config_overrides={**base.config_overrides, **_parse_kv(args.config)},
    )
    PLAN_OVERRIDES[(args.arch, args.shape)] = plan
    try:
        result = run_cell(args.arch, args.shape, multi_pod=args.mesh == "multi",
                          n_layers=args.layers)
    finally:
        PLAN_OVERRIDES.pop((args.arch, args.shape), None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if result["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
