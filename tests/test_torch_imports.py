"""The port stands alone: it imports neither JAX nor the JAX package, its
modules import where there is no CUDA toolchain, and its kernel wrappers
refuse what the kernels do not take."""

import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rms_norm

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"


def _module_names():
    names = ["repro_torch"]
    for m in pkgutil.walk_packages([str(PACKAGE)], prefix="repro_torch."):
        names.append(m.name)
    return names


def test_every_submodule_imports_without_jax_or_repro():
    names = _module_names()
    assert {"repro_torch.kernels._build", "repro_torch.kernels.ops",
            "repro_torch.kernels.flash_attention", "repro_torch.serve.engine",
            "repro_torch.convert", "repro_torch.configs.granite_3_2b",
            "repro_torch.train.optimizer", "repro_torch.train.train_step",
            "repro_torch.train.trainer", "repro_torch.data.pipeline",
            "repro_torch.models.ssm", "repro_torch.kernels.ssm_scan",
            "repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
            "repro_torch.models.moe", "repro_torch.parallel", "repro_torch.parallel.sharding",
            "repro_torch.parallel.context", "repro_torch.parallel.comm",
            "repro_torch.parallel.moe_ep", "repro_torch.parallel.pipeline",
            "repro_torch.parallel.collectives", "repro_torch.runtime",
            "repro_torch.runtime.elastic", "repro_torch.runtime.fault_tolerance",
            "repro_torch.runtime.straggler", "repro_torch.kernels.scope",
            "repro_torch.launch", "repro_torch.launch.roofline", "repro_torch.launch.plans",
            "repro_torch.launch.analytic", "repro_torch.launch.specs",
            "repro_torch.launch.mesh", "repro_torch.launch.op_stats",
            "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb", "repro_torch.core",
            "repro_torch.core.ga", "repro_torch.core.shard_search",
            "repro_torch.core.adaptation",
            "repro_torch.core.apps", "repro_torch.core.cluster", "repro_torch.core.lp",
            "repro_torch.core.migration", "repro_torch.core.placement",
            "repro_torch.core.reconfig", "repro_torch.core.satisfaction",
            "repro_torch.core.simplex", "repro_torch.core.simulation",
            "repro_torch.core.solver", "repro_torch.core.topology", "repro_torch.fleet",
            "repro_torch.fleet.elastic_bridge", "repro_torch.fleet.events",
            "repro_torch.fleet.executor", "repro_torch.fleet.obs",
            "repro_torch.fleet.obs.calibration", "repro_torch.fleet.obs.metrics",
            "repro_torch.fleet.obs.provenance", "repro_torch.fleet.obs.slo",
            "repro_torch.fleet.obs.trace", "repro_torch.fleet.planner",
            "repro_torch.fleet.planner.decomposed", "repro_torch.fleet.planner.forecast",
            "repro_torch.fleet.planner.horizon", "repro_torch.fleet.planner.migration_cost",
            "repro_torch.fleet.planner.partition", "repro_torch.fleet.policies",
            "repro_torch.fleet.runtime", "repro_torch.fleet.scenarios",
            "repro_torch.fleet.serving", "repro_torch.fleet.serving.backend",
            "repro_torch.fleet.serving.profile", "repro_torch.fleet.serving.workload",
            "repro_torch.fleet.telemetry"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("BAD []"), out.stdout


def test_checkpoints_need_neither_ml_dtypes_nor_zstandard(tmp_path):
    """As on a host without them: a bf16 / int8 / int32 tree saves (zlib)
    and restores bit for bit, and neither module is imported."""
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.modules['zstandard'] = None\n"
        "import torch\n"
        "from repro_torch.ckpt import checkpoint as ck\n"
        "assert ck.zstandard is None and ck._DEFAULT_CODEC == 'zlib'\n"
        "tree = {'w': torch.randn(3, 5).to(torch.bfloat16), 'q': [torch.arange(-4, 4, "
        "dtype=torch.int8)], 'step': torch.tensor(7, dtype=torch.int32)}\n"
        f"path = ck.save({str(tmp_path)!r}, 1, tree)\n"
        "got = ck.restore(path, tree)\n"
        "assert all(torch.equal(got[k], tree[k]) for k in ('w', 'step'))\n"
        "assert torch.equal(got['q'][0], tree['q'][0])\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def _sources():
    files = sorted(PACKAGE.rglob("*.py")) + sorted(PACKAGE.rglob("*.cu")) + \
        sorted(PACKAGE.rglob("*.cuh")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    return files


@pytest.mark.parametrize("pattern", [r"^\s*import\s+jax", r"^\s*from\s+jax",
                                     r"^\s*from\s+repro(\.|\s)", r"^\s*import\s+repro(\.|\s|$)"])
def test_no_source_imports_jax_or_repro(pattern):
    rx = re.compile(pattern, re.M)
    hits = [str(f.relative_to(ROOT)) for f in _sources() if rx.search(f.read_text())]
    assert hits == []


def test_no_source_calls_a_library_kernel_or_compiler():
    """The serving and training paths' kernels are the repo's own: the
    package never calls the fused library operators or `torch.compile`
    (chip_smoke.py may time the library calls beside the kernels, and is
    left out here)."""
    rx = re.compile(r"scaled_dot_product_attention|F\.rms_norm|functional\.rms_norm|"
                    r"torch\.compile|cuda\.graphs|CUDAGraph")
    hits = [str(f.relative_to(ROOT)) for f in _sources()
            if f.name != "chip_smoke.py" and rx.search(f.read_text())]
    assert hits == []


def test_build_plan_needs_no_nvcc(tmp_path, monkeypatch):
    names = [p.name for p in _build.sources()]
    assert names == ["decode_attention.cu", "flash_attention.cu", "rmsnorm.cu", "ssm_scan.cu"]
    assert [p.name for p in _build.headers()] == ["common.cuh", "mma.cuh"]
    cmd = _build.compile_command(_build.sources()[0], tmp_path / "x.o")
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
    link = _build.link_command([tmp_path / "x.o"], tmp_path / "lib.so")
    assert "-shared" in link and str(tmp_path / "lib.so") in link
    assert _build.build_dir() == ROOT / "build" / "repro_torch"
    assert _build.library_path().name == f"librepro_torch_{_build.source_hash()}.so"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.library_path().parent == tmp_path
    assert set(_build.SIGNATURES) == {"repro_rms_norm", "repro_decode_attention",
                                      "repro_flash_attention", "repro_ssm_scan"}
    assert len(_build.SIGNATURES["repro_decode_attention"]) == 19
    assert len(_build.SIGNATURES["repro_flash_attention"]) == 14
    assert len(_build.SIGNATURES["repro_ssm_scan"]) == 22


def test_source_hash_follows_the_sources(tmp_path, monkeypatch):
    before = _build.source_hash()
    assert before == _build.source_hash()
    copy = tmp_path / "csrc"
    copy.mkdir()
    for f in _build.sources() + _build.headers():
        (copy / f.name).write_text(f.read_text())
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.source_hash() == before
    (copy / "rmsnorm.cu").write_text((copy / "rmsnorm.cu").read_text() + "\n// edited\n")
    assert _build.source_hash() != before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_launchers_in_the_sources_match_the_signatures():
    text = "".join(p.read_text() for p in _build.sources())
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*{", text, re.S)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes)
    assert 'extern "C" const char* repro_error_string(int code)' in text


class TestWrappersRefuse:
    def test_rms_norm_types_and_shapes(self):
        x = torch.zeros(2, 32)
        for bad in (torch.float16, torch.float64, torch.int32):
            with pytest.raises(TypeError):
                rms_norm(x.to(bad), torch.ones(32).to(bad))
        with pytest.raises(TypeError):
            rms_norm(x, torch.ones(32, dtype=torch.bfloat16))
        with pytest.raises(ValueError):
            rms_norm(x, torch.ones(16))

    def test_decode_attention_types_and_shapes(self):
        q, k = torch.zeros(2, 1, 4, 32), torch.zeros(2, 8, 2, 32)
        with pytest.raises(TypeError):
            decode_attention(q.half(), k.half(), k.half(), 3)
        with pytest.raises(TypeError):
            decode_attention(q, k.bfloat16(), k, 3)
        with pytest.raises(ValueError):
            decode_attention(torch.zeros(2, 2, 4, 32), k, k, 3)      # more than one token
        with pytest.raises(ValueError):
            decode_attention(q, k, torch.zeros(2, 9, 2, 32), 3)      # k and v differ
        with pytest.raises(ValueError):
            decode_attention(torch.zeros(2, 1, 3, 32), k, k, 3)      # 3 heads over 2
        assert decode_attention(q, k, k, 3).shape == q.shape

    def test_flash_attention_types_and_shapes(self):
        q, k = torch.zeros(2, 5, 4, 32), torch.zeros(2, 7, 2, 32)
        with pytest.raises(TypeError):
            flash_attention(q.half(), k.half(), k.half())
        with pytest.raises(TypeError):
            flash_attention(q, k.bfloat16(), k)
        with pytest.raises(ValueError):
            flash_attention(q, k, torch.zeros(2, 8, 2, 32))           # k and v differ
        with pytest.raises(ValueError):
            flash_attention(torch.zeros(2, 5, 3, 32), k, k)           # 3 heads over 2
        with pytest.raises(ValueError):
            flash_attention(q, torch.zeros(2, 7, 2, 16), torch.zeros(2, 7, 2, 16))
        out, lse = flash_attention(q, k, k, causal=False)
        assert out.shape == q.shape and lse.shape == (2, 2, 2, 5)


def test_chip_smoke_refuses_to_run_without_a_gpu():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300, env={"PATH": "", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
