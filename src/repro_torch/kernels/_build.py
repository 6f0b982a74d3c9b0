"""Builds the CUDA sources under ``csrc/`` into one shared library with a
plain C interface, and loads it with `ctypes`.

The library is built at first use, from the sources in the package and
nothing else: one ``nvcc -c`` per source, all started together, then one
link.  It lands in ``build/repro_torch/`` beside ``src/`` (or in
``$REPRO_TORCH_BUILD_DIR``), under a name that carries the hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
A failed build raises with the compiler's output.

Nothing here runs at import: `nvcc` and `ctypes.CDLL` are touched only by
`library()`, which the kernel wrappers call when they launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    # src/repro_torch/kernels/_build.py -> the directory that holds src/
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def source_hash() -> str:
    h = hashlib.sha256()
    for flag in ARCH_FLAGS + NVCC_FLAGS:
        h.update(flag.encode())
    for path in sources() + headers():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"librepro_torch_{source_hash()}.so"


def find_nvcc() -> Optional[str]:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def compile_command(src: Path, obj: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
            "-o", str(obj)]


def link_command(objs: List[Path], lib: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]


def build() -> Path:
    """Compile every source (in parallel) and link; returns the library.
    The compiler's messages (register counts) go to ``build.log`` beside it."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $PATH and "
                           "/usr/local/cuda): the CUDA kernels cannot be built")
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    lib = library_path()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [out / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [subprocess.Popen(compile_command(src, obj, nvcc), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    log, failed = [], []
    for src, proc in zip(sources(), procs):
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out / f"{tag}.so"
    link = subprocess.run(link_command(objs, tmp, nvcc), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {lib.name}:\n{link.stdout}")
    os.replace(tmp, lib)          # atomic: a concurrent build sees all or nothing
    for obj in objs:
        obj.unlink(missing_ok=True)
    (out / "build.log").write_text("\n".join(log))
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SERIALIZED = re.compile(r"wgmma\.mma_async instructions are serialized.* in the function '(\S+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """Registers a thread and spill bytes (stores + loads) of each kernel,
    by mangled name, from the ``-Xptxas -v`` lines of ``build.log``; and
    ``wgmma_serialized`` 1 where ptxas says it serialized the kernel's
    wgmma (C7510-C7515: registers short, or an accumulator touched
    mid-pipeline), which costs a wgmma kernel much of its overlap."""
    out: Dict[str, Dict[str, int]] = {}
    entry = None
    for line in text.splitlines():
        if m := _SERIALIZED.search(line):
            out.setdefault(m[1], {"registers": 0, "spill_bytes": 0})["wgmma_serialized"] = 1
        elif m := _ENTRY.search(line):
            entry = out.setdefault(m[1], {"registers": 0, "spill_bytes": 0})
        elif entry is not None and (m := _SPILLS.search(line)):
            entry["spill_bytes"] = int(m[1]) + int(m[2])
        elif entry is not None and (m := _REGS.search(line)):
            entry["registers"] = int(m[1])
    return out


def count_sass(text: str, opcode: str) -> Dict[str, int]:
    """Instructions whose opcode is ``opcode`` (with or without a suffix
    after a dot: ``HMMA.16816.F32.BF16``), by function, in ``cuobjdump
    -sass`` output."""
    out: Dict[str, int] = {}
    fn = None
    op = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?" + re.escape(opcode) + r"\b")
    for line in text.splitlines():
        if m := _SASS_FUNCTION.match(line):
            fn = m[1]
            out.setdefault(fn, 0)
        elif fn is not None and op.search(line):
            out[fn] += 1
    return out


def demangle(names: List[str]) -> Dict[str, str]:
    """Mangled name -> ``kernel<args>`` (namespace and parameters dropped),
    by ``c++filt`` where there is one; else the names as they are."""
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if not names or tool is None:
        return {n: n for n in names}
    text = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout
    short = {}
    for name, full in zip(names, text.splitlines()):
        # a template's demangled name leads with its return type, void
        head = full.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
        scope = head.split("<")[0]
        short[name] = head[scope.rindex("::") + 2:] if "::" in scope else head
    return short


#: The tensor cores' instructions in SASS: ``HMMA`` is a warp's mma.sync,
#: ``HGMMA`` a warpgroup's wgmma.
TENSOR_CORE_OPCODES = ("HMMA", "HGMMA")


def kernel_resources() -> Dict[str, Dict[str, int]]:
    """Each kernel instance of the built library: registers, spill bytes
    (``build.log``, written by `build`) and tensor-core instructions
    (``hmma`` and ``hgmma``, counted in ``cuobjdump -sass``), by demangled
    name.  Call after `library()`; the ptxas lines are there only if this
    process built it."""
    log = build_dir() / "build.log"
    res = parse_ptxas(log.read_text()) if log.exists() else {}
    nvcc = find_nvcc()
    cuobjdump = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if cuobjdump is None or not cuobjdump.exists():
        raise RuntimeError("cuobjdump not found beside nvcc")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library_path())], capture_output=True,
                          text=True, check=True).stdout
    for opcode in TENSOR_CORE_OPCODES:
        for name, n in count_sass(sass, opcode).items():
            res.setdefault(name, {"registers": None, "spill_bytes": None})[opcode.lower()] = n
    names = demangle(sorted(res))
    return {names[n]: res[n] for n in sorted(res)}


_PTR, _INT, _I64, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C signatures of the launchers; each returns the launch's cudaError_t.
SIGNATURES = {
    # x, scale, out, rows, d, eps, is_bf16, stream
    "repro_rms_norm": [_PTR, _PTR, _PTR, _INT, _INT, _FLOAT, _INT, _PTR],
    # x, sumsq, rows, d, is_bf16, stream
    "repro_rms_sumsq": [_PTR, _PTR, _INT, _INT, _INT, _PTR],
    # x, scale, sumsq, out, rows, d, d_norm, eps, is_bf16, stream
    "repro_rms_norm_sumsq": [_PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _FLOAT, _INT, _PTR],
    # x, dy, scale, dx, partial, rows, d, eps, blocks, is_bf16, stream
    "repro_rms_norm_bwd": [_PTR] * 5 + [_INT, _INT, _FLOAT, _INT, _INT, _PTR],
    # partial, dscale, blocks, d, is_bf16, stream
    "repro_rms_dscale_sum": [_PTR, _PTR, _INT, _INT, _INT, _PTR],
    # stream (the empty kernel: the launch floor)
    "repro_empty": [_PTR],
    # q, k, v, kv_len, out, part_m, part_l, part_acc, counters,
    # B, Sk, Hq, Hkv, D, chunk, n_splits, is_bf16, stream
    "repro_decode_attention": [_PTR] * 9 + [_INT] * 9 + [_PTR],
    # q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, is_bf16, stream
    "repro_flash_attention": [_PTR] * 5 + [_INT] * 8 + [_PTR],
    # q, k, v, out, dout, lse, dq, dk, dv, scratch, parts, count, B, Sq, Sk, Hq, Hkv,
    # D, causal, cap, items, n_split, is_bf16, stream
    "repro_flash_attention_bwd": [_PTR] * 12 + [_INT] * 11 + [_PTR],
    # x, Bm, Cm, dt, A_log, D, y, state, carry, sync, B, S, H, P, N, chunk,
    # x / Bm / Cm batch and sequence strides (elements), is_bf16, stream
    "repro_ssm_scan": [_PTR] * 10 + [_INT] * 6 + [_I64] * 6 + [_INT, _PTR],
    # x, Bm, Cm, dt, A_log, D, dy, dstate, dx, dBm, dCm, ddt, dA_log, dD, states,
    # parts, sync, B, S, H, P, N, chunk, x / Bm / Cm batch and sequence strides
    # (elements), is_bf16, stream
    "repro_ssm_scan_bwd": [_PTR] * 17 + [_INT] * 6 + [_I64] * 6 + [_INT, _PTR],
}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its file is missing."""
    lib_path = library_path()
    if not lib_path.exists():
        build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if code != 0:
        text = library().repro_error_string(code).decode() if code > 0 else "unsupported arguments"
        raise RuntimeError(f"{what}: kernel launch failed with code {code} ({text})")


MAX_HEAD_DIM = 128


def check_head_dim(what: str, d: int, dtype) -> None:
    """Raise unless the attention kernels take d_head ``d`` for ``dtype``:
    any multiple of a 16-byte vector's values (8 bf16, 4 fp32) up to 128.
    32, 64 and 128 run exact instances, the others one padded to 128
    (``csrc/common.cuh``, ``padded_head_dim``); bf16 flash attention runs
    its 64 instance up to 64 and its 128 instance above, the columns past
    ``d`` zero."""
    vec = 16 // dtype.itemsize
    if d <= 0 or d % vec or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: d_head {d} not supported (takes multiples of {vec} "
                         f"up to {MAX_HEAD_DIM})")
