#!/usr/bin/env python3
"""The dry run's table for PERF.md, from the rows that
``python -m repro_torch.launch.dryrun --all --out results.json`` writes:

    python3 tools/dryrun_table.py results.json

One line a cell that traced: FLOPs, bytes and wire bytes a device, the
tally's peak, the three roofline terms, the bottleneck and MFU at the
roofline step; the skipped cells on one line after it.
"""

import json
import sys


def main(path):
    with open(path) as f:
        rows = json.load(f)
    print("| cell | FLOPs / dev | bytes / dev | wire / dev | peak GB | t_compute s | "
          "t_memory s | t_collective s | bound | mfu@roofline |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in rows:
        if r["status"] != "ok":
            continue
        s, t = r["op_stats"], r["roofline"]
        print(f"| {r['arch']} {r['shape']} | {s['flops']:.3e} | {s['bytes']:.3e} | "
              f"{s['wire_bytes']:.3e} | {s['peak_bytes'] / 1e9:.1f} | {t['t_compute_s']:.4g} | "
              f"{t['t_memory_s']:.4g} | {t['t_collective_s']:.4g} | {t['bottleneck']} | "
              f"{t['mfu_roofline']:.2%} |")
    skipped = [f"{r['arch']} {r['shape']}" for r in rows if r["status"] == "skipped"]
    failed = [f"{r['arch']} {r['shape']}" for r in rows if r["status"] == "failed"]
    print(f"\nSkipped ({len(skipped)}): {', '.join(skipped)}.")
    if failed:
        print(f"Failed ({len(failed)}): {', '.join(failed)}.")


if __name__ == "__main__":
    main(sys.argv[1])
