"""Readings for setting a training cell's limits, many seeds in one process.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--faults half_batch]

For each seed: the plain reference's readings, the program's (its checked
steps alone, no window) and the numbers `harness.check` compares; for the
control seeds, the same numbers of the control (the reference computed in
float8, in the program's place); for the fault seeds, those of the
program with each fault of ``--faults`` planted (`drivers.train._faulty`).
One JSON line a reading on standard output, with the worst leaf of each
number and the seconds each side took.  The limits in ``bench/limits/``
are set from these: above the program's largest reading, below the
smallest of the control's and the faults'."""

import argparse
import json
import sys
import time

from harness import check, checkout, modules, spec


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--faults", default="half_batch")
    args = p.parse_args(argv)
    checkout.prepare()
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench/calibrate.py: no CUDA device")
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    driver = spec.module("drivers", traffic["kind"])
    device = torch.device("cuda")

    def emit(seed, side, ours, ref, seconds):
        found = check.compare(ours, ref)
        line = {"workload": args.workload, "seed": seed, "side": side,
                "numbers": {k: v for k, (v, _) in found.items()},
                "worst": {k: where for k, (_, where) in found.items()},
                "loss": ours["loss"], "ref_loss": ref["loss"], "seconds": seconds}
        print(json.dumps(line), flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        t = time.perf_counter()
        ref = driver.reference_readings(cfg, traffic, seed, device)
        ref_s = time.perf_counter() - t
        if seed in args.seeds:
            t = time.perf_counter()
            loop = driver.program(cfg, traffic, seed, device, window=False)
            emit(seed, "program", loop.readings, ref, {"program": time.perf_counter() - t,
                                                       "reference": ref_s})
        if seed in args.control_seeds:
            t = time.perf_counter()
            ours = driver.reference_readings(cfg, traffic, seed, device, precision="float8")
            emit(seed, "control float8", ours, ref, {"control": time.perf_counter() - t})
        if seed in args.fault_seeds:
            for fault in args.faults.split(","):
                loop = driver.program(cfg, traffic, seed, device, window=False, fault=fault)
                emit(seed, f"fault {fault}", loop.readings, ref, {})
    found = modules.forbidden_loaded()
    if found:
        sys.exit(f"bench/calibrate.py: forbidden packages loaded: {found}")


if __name__ == "__main__":
    main()
