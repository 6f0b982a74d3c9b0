"""Runs one cell of the benchmark once and prints its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix; the traffic
mix's ``kind`` names the driver (``bench/drivers/<kind>.py``), which
builds the port (``src/repro_torch``) on the card, warms it up, measures
for ``--seconds``, and decides ``correct`` by the plain reference.  With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, each read by ``bench/metrics/<name>.py``.
The last line of standard output is the result's JSON object; the numbers
compared for ``correct``, each beside its limit, are the last lines of
standard error.

It exits with a code other than 0 and prints no result when no card (or
too few) is there, when the port cannot be loaded, or when JAX or the JAX
package is found loaded after the window.  ``--device cpu`` rehearses a
small configuration on the port's plain path (for the benchmark's own
tests; its result says ``"platform": "cpu"``).  The port's kernels are
built into ``build/repro_torch/`` inside the checkout at the first run
and loaded by every later one."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from harness import checkout, modules, spec  # noqa: E402  (bench/ is the script's directory)


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def _fail(msg: str, code: int = 2):
    print(f"bench/run.py: {msg}", file=sys.stderr)
    sys.exit(code)


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def device_block(run, device, chips: int, trace: bool):
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
             "memory_peak_bytes": int(run["peak_bytes"]), "power_limit": _power_limit()}
    if trace and run["trace"] is not None:
        block["busy_s"] = run["trace"]["busy_s"]
        block["window_s"] = run["trace"]["window_s"]
    return block


def main(argv=None):
    args = _args(argv)
    checkout.prepare()
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(args.workload)
    import torch
    imported = time.perf_counter()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            _fail("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            _fail(f"the cell asks for {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} are there")
    torch.set_num_threads(min(4, torch.get_num_threads()))
    driver = spec.module("drivers", traffic["kind"])
    run = driver.run(cfg, traffic, limits, args.seed, args.seconds, bool(args.trace),
                     args.device, T_START)
    run["notes"]["setup_marks"] = {"torch": imported - T_START, **run["notes"]["setup_marks"]}
    found = modules.forbidden_loaded()
    if found:
        _fail(f"forbidden packages loaded: {found}", 3)
    metrics = {}
    for m in spec.metrics(bench, args.workload, bool(args.trace)):
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # A rehearsal's numbers are the CPU's, never written under a device metric's name.
    key = "metrics" if args.device == "cuda" else "rehearsal_metrics"
    result = {"correct": run["correct"], "attempted": run["attempted"], "failed": run["failed"],
              "metrics": {}, key: metrics,
              "device": device_block(run, args.device, cell["chips"], bool(args.trace))}
    if args.trace and run["trace"] is not None:
        result["breakdown"] = {k: run["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["checked"] = run["checked"]
    sys.stdout.flush()
    if args.device == "cuda":
        run["notes"]["process_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"notes {json.dumps(run.get('notes', {}))}", file=sys.stderr)
    for name, v in run["checked"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
