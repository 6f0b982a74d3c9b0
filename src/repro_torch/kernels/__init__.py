"""Hand-written CUDA kernels for Hopper, one wrapper module per kernel.

Each kernel: ``csrc/<name>.cu`` (CUDA C++ for sm_90a, plain C launcher),
``<name>.py`` (the wrapper: checks, output allocation, launch on the current
stream, launch count, and the dispatch to the plain version for a CPU
tensor), with `ops.py` as the entry the model calls and `ref.py` the plain
versions under kernel-oriented names.  `_build.py` compiles the sources with
`nvcc` at first use and loads the library with `ctypes`.

Ported: `rms_norm`, `decode_attention`, `flash_attention`, `ssm_scan`: every
Pallas kernel of `repro.kernels`.
"""
