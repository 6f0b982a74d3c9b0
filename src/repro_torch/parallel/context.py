"""Activation-sharding context: the (mesh, strategy) a sharded computation
runs under, read by model code without passing a mesh around; the port of
`repro.parallel.context`.

The port computes on each rank's local tensors, so there is no layout to
pin: `constrain` and `constrain_like_params` return their input (after the
reference's rank check).  What the context does carry is the FSDP
gather: `gather_params` turns the DTensor parameters of a block into whole
tensors where the model uses them (inside each remat'd period, so that one
period's parameters are whole at a time), and `models.moe` takes its
expert-parallel branch from it.  It also knows which mesh dims cut the
batch, so that a layer whose result depends on the whole batch (the MoE
layer's capacity and load balance) can gather what it needs across them
(`dp_gather`).

The context is process-wide, not per thread as the reference's: a remat'd
period is recomputed inside the backward, which autograd runs on a thread
of its own for a CUDA device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from .comm import all_gather_dim, dp_dims, gather_param, is_dtensor
from .sharding import ShardingStrategy, axis_sizes

_CTX: Optional[Tuple[object, ShardingStrategy]] = None
_BATCH_DIMS: Optional[Tuple[int, ...]] = None


def current():
    """(mesh, strategy) of the active context, or None."""
    return _CTX


@contextlib.contextmanager
def activation_sharding(mesh, strat: ShardingStrategy,
                        batch_dims: Optional[Tuple[int, ...]] = None):
    """Run model code under (mesh, strategy).  ``batch_dims``: the mesh dims
    that cut the batch each rank holds (by default the strategy's
    data-parallel dims; empty where the batch does not divide over them
    and every rank holds it whole)."""
    global _CTX, _BATCH_DIMS
    prev = _CTX, _BATCH_DIMS
    _CTX = (mesh, strat)
    _BATCH_DIMS = None if batch_dims is None else tuple(batch_dims)
    try:
        yield
    finally:
        _CTX, _BATCH_DIMS = prev


def dp_gather(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``x`` of every rank holding a part of the batch, stacked in the order
    of their parts (major mesh dim first): (n_parts, *x.shape), and this
    rank's index in it.  ``(x[None], 0)`` outside a context or where the
    batch is not cut.  Not differentiable."""
    out, index, stride = x[None], 0, 1
    if _CTX is None:
        return out, index
    mesh, strat = _CTX
    coord = mesh.get_coordinate()
    dims = dp_dims(mesh, strat) if _BATCH_DIMS is None else _BATCH_DIMS
    for k in reversed(dims):                         # minor first
        n = mesh.size(k)
        if n > 1:
            out = all_gather_dim(out, 0, mesh.get_group(k), n)
        index += coord[k] * stride
        stride *= n
    return out, index


def constrain_like_params(tree, param_tree_path_hint: str = ""):
    """The reference pins a param-shaped tree to the param rules; here the
    gradients already come back in their parameters' placements."""
    return tree


def constrain(x: torch.Tensor, logical: Tuple[Optional[str], ...]) -> torch.Tensor:
    """No-op on the local tensor; a rank mismatch raises inside a context,
    as the reference's `with_sharding_constraint` wrapper does."""
    if _CTX is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"constrain: rank mismatch {logical} vs {tuple(x.shape)}")
    return x


def ep_size(cfg) -> int:
    """The expert-parallel ranks of the active context: the tensor-parallel
    axis's size when the strategy selects ``ep_shardmap`` and the experts
    divide over it, else 1 (the reference's condition,
    `repro.models.moe.moe_ffn`)."""
    if _CTX is None:
        return 1
    mesh, strat = _CTX
    n_ep = axis_sizes(mesh).get(strat.tp, 1) if strat.tp else 1
    if strat.moe == "ep_shardmap" and n_ep > 1 and cfg.n_experts % n_ep == 0:
        return n_ep
    return 1


def gather_params(tree, experts: bool = False):
    """``tree`` with each DTensor leaf gathered into its whole tensor
    (differentiably, `comm.gather_param`); a subtree under an ``experts``
    key is left as it is unless ``experts`` (the MoE layer gathers its own
    experts, keeping the expert dim cut under expert parallelism).  Outside
    a context the tree is returned as it is."""
    if _CTX is None:
        return tree
    strat = _CTX[1]

    def walk(t):
        if isinstance(t, dict):
            return {k: (v if k == "experts" and not experts else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return gather_param(t, strat) if is_dtensor(t) else t

    return walk(tree)
