"""repro_torch: the PyTorch/CUDA port of `repro`, grown slice by slice.

Module paths and public names mirror `repro`; parameters and caches are
nested dicts of tensors with the reference's leaf paths.  The package
imports `torch`, `numpy`, `msgpack` (the checkpoint format) and the
standard library only; `zstandard` where it is installed.
"""
__version__ = "0.1.0"
