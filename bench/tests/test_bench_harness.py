"""`bench/run.py` end to end on the CPU: a cell added as files alone, the
refusals (no card; no program beside the benchmark; JAX or the JAX
package loaded), and the import check's whole-name rule."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import BENCH, ROOT, TINY_TRAFFIC, tiny, write_json
from harness import modules

METRIC = '''"""Steps completed in the window (a throwaway metric of the tests)."""


def read(run):
    return float(run["steps"])
'''


def _checkout(tmp_path, with_cell=True):
    """A copy of the benchmark (its files and BENCHMARK.json) under
    ``tmp_path``, with a throwaway configuration, traffic mix, metric and
    cell added as files and entries; nothing of the copy edited."""
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if with_cell:
        cfg = tiny("tiny-dense")
        write_json(tmp_path / "bench" / "configs" / "tiny-dense.json", cfg)
        write_json(tmp_path / "bench" / "traffic" / "tiny-train.json", TINY_TRAFFIC)
        (tmp_path / "bench" / "metrics" / "steps_done.py").write_text(METRIC)
        write_json(tmp_path / "bench" / "limits" / "tiny-cell.json",
                   {"limits": {"loss_gap": 1e-5, "grad_gap": 1e-4, "delta_gap": 1e-4}})
        bench["configs"].append({"name": "tiny-dense", "source": "tests",
                                 "file": "bench/configs/tiny-dense.json", "reduced": [],
                                 "why": "tests"})
        bench["workloads"].append({"name": "tiny-cell", "config": "tiny-dense",
                                   "traffic": "tiny-train", "chips": 1, "why": "tests"})
        bench["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                                    "bound": 0.1, "source": "host_clock",
                                    "workloads": ["tiny-cell"]})
    write_json(tmp_path / "BENCHMARK.json", bench)
    return tmp_path


def _run(root, *args, pythonpath=str(ROOT / "src"), extra_env=None):
    env = dict(os.environ, PYTHONPATH=pythonpath, **(extra_env or {}))
    return subprocess.run([sys.executable, str(root / "bench" / "run.py"), "--workload",
                           "tiny-cell", "--seed", str(2 ** 31 + 7), "--seconds", "1",
                           "--trace", "0", *args],
                          capture_output=True, text=True, env=env, cwd=root, timeout=300)


def _result(p):
    """The run's result object, or None where its last line holds none."""
    lines = p.stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except ValueError:
        return None


def test_a_cell_added_as_files_runs_end_to_end(tmp_path):
    root = _checkout(tmp_path)
    p = _run(root, "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    result = _result(p)
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu" and result["metrics"] == {}
    assert set(result["rehearsal_metrics"]) == {"setup_s", "train_tok_s", "steps_done"}
    assert result["rehearsal_metrics"]["steps_done"]["value"] == result["attempted"]
    assert list(result)[-1] == "checked"
    tail = p.stderr.strip().splitlines()[-3:]
    assert [line.split()[0] for line in tail] == list(result["checked"])
    assert all(" limit " in line for line in tail)


def test_no_card_no_result(tmp_path):
    p = _run(_checkout(tmp_path))
    assert p.returncode != 0 and _result(p) is None
    assert "no CUDA device" in p.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and the files under ``paths`` only:
    the program is missing, so no result."""
    p = _run(_checkout(tmp_path), "--device", "cpu", pythonpath="")
    assert p.returncode != 0 and _result(p) is None


def test_a_loaded_jax_package_gives_no_result(tmp_path):
    """A stand-in package named ``repro`` loaded into the run's process:
    the run names it and prints no result."""
    root = _checkout(tmp_path)
    fake = tmp_path / "fake"
    (fake / "repro").mkdir(parents=True)
    (fake / "repro" / "__init__.py").write_text("")
    (fake / "sitecustomize.py").write_text("import repro\n")
    p = _run(root, "--device", "cpu", pythonpath=f"{fake}{os.pathsep}{ROOT / 'src'}")
    assert p.returncode != 0 and _result(p) is None
    assert "forbidden packages loaded: ['repro']" in p.stderr


def test_names_are_compared_whole():
    assert modules.forbidden_loaded(["repro_torch", "repro_torch.models", "jaxtyping",
                                     "flaxen", "torch"]) == []
    assert modules.forbidden_loaded(["repro.models.config", "jax.numpy", "jaxlib",
                                     "flax.linen", "repro_torch"]) == ["flax", "jax", "jaxlib",
                                                                       "repro"]


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package():
    """The driver's whole run in this process, on the CPU: afterwards no
    module of JAX or the JAX package is loaded (this test process loads
    neither: the benchmark's tests import only the port)."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
        from conftest import TINY_TRAFFIC, tiny
        from drivers import train
        from harness import modules
        run = train.run(tiny("tiny-hybrid"), TINY_TRAFFIC,
                        {{"loss_gap": 1e-5, "grad_gap": 1e-4, "delta_gap": 1e-4}}, 9, 0.5,
                        False, "cpu", time.perf_counter())
        assert run["correct"], run["checked"]
        print(modules.forbidden_loaded())
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=BENCH / "tests", timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
