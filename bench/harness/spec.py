"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration (its file is the entry's ``file``) and a
traffic mix (``bench/traffic/<traffic>.json``); its limits for the
comparison that decides ``correct`` are ``bench/limits/<cell>.json``; a
traffic mix's ``kind`` names its driver (``bench/drivers/<kind>.py``) and
each metric its reader (``bench/metrics/<metric>.py``).  A cell or metric
is added by adding files and entries: nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}; it has "
                   f"{[e['name'] for e in entries]}")


def workload(bench: Dict, name: str) -> Dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: Dict, name: str) -> Dict:
    """The configuration as it is run: its file's JSON object."""
    entry = _named(bench["configs"], name, "config")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> Dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> Dict[str, float]:
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())["limits"]


def metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones:
    every metric without a ``workloads`` key, and those whose key lists
    the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
