"""What a process of the benchmark sets before it imports the port.

`prepare` puts the checkout's ``src/`` on the import path and keeps every
build and kernel cache inside the checkout, at fixed paths, so that only
a checkout's first run builds the port's kernels and compiles Python's
bytecode: the library in ``build/repro_torch/``, Triton's cache in
``build/triton/`` and the bytecode of every module imported after it
(PyTorch's and the port's) in ``build/pycache/``, which an installation
without bytecode, or an environment that forbids writing it beside the
sources, would otherwise compile again in every process.  It also keeps
`transformers`, should anything load it, from loading JAX."""

from __future__ import annotations

import os
import sys

from harness.spec import ROOT


def prepare() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    os.environ.setdefault("USE_FLAX", "0")
