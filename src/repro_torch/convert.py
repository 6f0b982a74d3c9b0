"""Carry parameters, caches and train states between the JAX package and
the port.

The JAX side hands over its pytree as numpy arrays
(``jax.tree.map(np.asarray, tree)``); this module never imports JAX.  The
trees keep their structure and leaf paths; only the leaves change type.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ._tree import tree_map


def _to_tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # An ml_dtypes array, which torch.from_numpy refuses: reinterpret the
        # bits instead (exact).
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))   # owns writable memory
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device="cuda", dtype: Optional[torch.dtype] = None):
    """A parameter pytree of numpy arrays -> the port's tree of tensors on
    ``device``; EVERY floating leaf is cast to ``dtype`` when one is given.
    Without ``dtype`` each leaf keeps its type, which is what a bf16 model
    needs: some leaves are fp32 under bf16 parameters (Mamba2's ``A_log``,
    ``D`` and ``dt_bias``, the routers' weights, and the xLSTM mixers'
    ``w_gates`` and sLSTM's ``r_gates``), and ``dtype`` would round them."""
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree)


def state_from_jax(tree: Any, device="cuda"):
    """A train state (``params``, ``opt``, ``step``) of numpy arrays ->
    tensors.  Every leaf keeps its type bit for bit: bf16 / fp32 weights and
    moments, the int8 blocks of `adam8bit`, the int32 step counters."""
    return tree_map(lambda a: _to_tensor(a, device, None), tree)


def cache_from_jax(tree: Any, device="cuda", dtype: Optional[torch.dtype] = None):
    """A cache pytree (`init_cache`, or one slot's `export_slot` payload) of
    numpy arrays -> tensors; ``index`` keeps its integer type, python
    scalars (the payload's ``offset``) pass through.  ``dtype`` casts the
    leaves held in the compute type (K, V, conv windows); the recurrent
    states (Mamba2's ``state``, the xLSTM mixers' ``C``, ``n``, ``m``,
    ``c`` and ``h``) stay fp32, as the caches' inits make them."""
    def convert(a, key):
        if isinstance(a, (int, float)):
            return a
        return _to_tensor(a, device, dtype if key in ("k", "v", "conv") else None)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, key) for v in t]
        return convert(t, key)

    return walk(tree)


def _to_numpy(t) -> Any:
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()           # exact; numpy has no bfloat16 of its own
    return t.numpy()


def tree_to_numpy(tree: Any):
    """The way back: a tree of tensors -> numpy arrays with the same leaf
    paths (bfloat16 widened to float32), to compare leaf for leaf."""
    return tree_map(_to_numpy, tree)
