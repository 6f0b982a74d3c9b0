"""Activation-sharding context: the (mesh, strategy) a sharded computation
runs under, read by model code without passing a mesh around; the port of
`repro.parallel.context`.

The port computes on each rank's local tensors, so there is no layout to
pin: `constrain` and `constrain_like_params` return their input (after the
reference's rank check).  What the context does carry:

  * the FSDP gather: `gather_params` turns the DTensor parameters of a
    block into tensors where the model uses them (inside each remat'd
    period, so that one period's parameters are gathered at a time).  It
    gathers over the data-parallel (FSDP) mesh dims only and keeps each
    leaf's shard along the tensor-parallel and expert axes (``strat.tp``,
    ``strat.ep``, "model"), where the rule table cut it: each rank then
    computes its own heads, FFN columns, vocab rows and experts, as the
    reference's SPMD program splits the same rules.  The Mamba2 and xLSTM
    mixers keep their shards too: where their heads divide over "model"
    each rank computes its heads, taking each segment of a packed leaf
    (Mamba2's [z, x, B, C, dt] ``in_proj``, mLSTM's [x, z] ``up_proj``,
    the gates) through `tp_slices`; where they do not, the mixer gathers
    its leaves whole (`tp_whole_tree`) and every rank computes it alike.
  * the tensor-parallel axis (`tp_size`, `tp_rank`, `tp_group`,
    `tp_heads`) and Megatron's two pieces over it (`copy_to_tp`,
    `reduce_from_tp`, and `sum_over_tp` for a sum each rank uses in its
    own way), which return their input with no collective on an axis of
    one rank, so that a (1, 1) mesh computes bit for bit what one device
    does; `tp_part`, `tp_slices` and `tp_whole` give a layer the part of
    a weight it uses, whether the weight arrives cut or whole, and
    `gather_tp` / `tp_gather_whole` an activation's parts of every rank.
  * which mesh dims cut the batch, so that a layer whose result depends on
    the whole batch (the MoE layer's capacity and load balance) can gather
    what it needs across them (`dp_gather`); `models.moe` takes its
    expert-parallel branch from the strategy (`ep_size`) and its expert
    split from `ep_part`.

The context is process-wide, not per thread as the reference's: a remat'd
period is recomputed inside the backward, which autograd runs on a thread
of its own for a CUDA device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .._tree import tree_map
from .comm import (all_gather_dim, copy_to, dp_dims, gather, gather_param, gather_sum,
                   is_dtensor, reduce_from)
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


def _batch_dims() -> Tuple[int, ...]:
    mesh, strat = _CTX
    return dp_dims(mesh, strat) if _BATCH_DIMS is None else _BATCH_DIMS


def batch_part() -> Tuple[int, int]:
    """(the parts the batch is cut into, this rank's part's index, major
    mesh dim first); (1, 0) outside a context."""
    if _CTX is None:
        return 1, 0
    mesh = _CTX[0]
    coord, index, stride = mesh.get_coordinate(), 0, 1
    for k in reversed(_batch_dims()):                # minor first
        index += coord[k] * stride
        stride *= mesh.size(k)
    return stride, index


def dp_gather(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``x`` of every rank holding a part of the batch, stacked in the order
    of their parts (`batch_part`): (n_parts, *x.shape), and this rank's
    index in it.  ``(x[None], 0)`` outside a context or where the batch is
    not cut.  Not differentiable."""
    out = x[None]
    if _CTX is None:
        return out, 0
    mesh = _CTX[0]
    for k in reversed(_batch_dims()):                # minor first
        n = mesh.size(k)
        if n > 1:
            out = all_gather_dim(out, 0, mesh.get_group(k), n)
    return out, batch_part()[1]


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


def _model_dims(mesh, strat) -> Tuple[int, ...]:
    """The mesh dims of the tensor-parallel and expert axes that do not cut
    the batch: the dims whose shards `gather_params` keeps."""
    names = list(mesh.mesh_dim_names)
    batch = set(dp_dims(mesh, strat))
    return tuple(sorted({names.index(a) for a in (strat.tp, strat.ep)
                         if a in names and names.index(a) not in batch}))


def gather_params(tree, experts: bool = False):
    """``tree`` with each DTensor leaf gathered over the data-parallel mesh
    dims (differentiably, `comm.gather_param`), its shard along the
    tensor-parallel and expert axes kept.  A subtree under an ``experts``
    key is left as it is unless ``experts`` (the MoE layer gathers its own
    experts).  Outside a context the tree is returned as it is."""
    if _CTX is None:
        return tree
    mesh, strat = _CTX
    keep = _model_dims(mesh, strat)

    def walk(t):
        if isinstance(t, dict):
            return {k: (v if k == "experts" and not experts else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return gather_param(t, strat, keep=keep) if is_dtensor(t) else t

    return walk(tree)


# ------------------------------------------------------ tensor parallel --
def _axis(name: Optional[str]):
    """(mesh, mesh dim, its size, this rank's index along it) of the axis
    ``name`` of the active context, or None (no context, no such axis)."""
    if _CTX is None or name is None:
        return None
    mesh = _CTX[0]
    names = list(mesh.mesh_dim_names)
    if name not in names:
        return None
    k = names.index(name)
    return mesh, k, mesh.size(k), mesh.get_local_rank(k)


def tp_size() -> int:
    """The ranks of the tensor-parallel axis of the active context (1
    outside one)."""
    a = _axis(_CTX[1].tp) if _CTX is not None else None
    return 1 if a is None else a[2]


def tp_rank() -> int:
    a = _axis(_CTX[1].tp) if _CTX is not None else None
    return 0 if a is None else a[3]


def tp_group():
    """The process group of the tensor-parallel axis (None for one rank)."""
    a = _axis(_CTX[1].tp) if _CTX is not None else None
    return None if a is None or a[2] == 1 else a[0].get_group(a[1])


def ep_part() -> Tuple[int, int, object]:
    """(ranks, this rank's index, group) of the expert axis (``strat.ep``)
    of the active context; (1, 0, None) outside one."""
    a = _axis(_CTX[1].ep) if _CTX is not None else None
    if a is None or a[2] == 1:
        return 1, 0, None
    return a[2], a[3], a[0].get_group(a[1])


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Identity; the backward sums the cotangent over the tensor-parallel
    axis.  Its input is replicated and feeds each rank's own part of a
    column-parallel product."""
    return copy_to(x, tp_group(), tp_size())


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The sum over the tensor-parallel axis of the ranks' partial results
    (a row-parallel product's); the backward passes the cotangent as it is."""
    return reduce_from(x, tp_group(), tp_size())


def max_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the tensor-parallel axis; not
    differentiable (a softmax's shift)."""
    if tp_size() == 1:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=tp_group())
    return out


def tp_part(w: torch.Tensor, dim: int, whole: int, lo: int, hi: int) -> torch.Tensor:
    """Indices ``[lo, hi)`` along ``dim`` of a weight ``whole`` long there,
    which arrives as this rank's chunk of it (kept by `gather_params`) or
    whole; the rank computes with that part, and the others with theirs
    (`tp_slices` with one span)."""
    shape = list(w.shape)
    shape[dim] = whole
    return tp_slices(w, shape, dim, [(lo, hi)])


def tp_heads(n_heads: int) -> Optional[Tuple[int, int]]:
    """(ranks, this rank's index) of the tensor-parallel axis where it has
    two or more ranks and they divide ``n_heads``: a mixer then computes
    its ``n_heads / ranks`` heads; None where it computes them all (one
    rank, no context, or heads that do not divide)."""
    n = tp_size()
    if n == 1 or n_heads % n:
        return None
    return n, tp_rank()


def sum_over_tp(x: torch.Tensor) -> torch.Tensor:
    """The sum over the tensor-parallel axis of the ranks' partial results,
    where each rank uses the sum in its own way (its own heads' columns of
    it): the backward sums the cotangent over the axis too."""
    return copy_to_tp(reduce_from_tp(x))


def tp_slices(w: torch.Tensor, shape, dim: int, spans) -> torch.Tensor:
    """The spans ``[lo, hi)`` along ``dim`` of a weight whose whole shape is
    ``shape``, concatenated along ``dim``, for a computation in which each
    rank of the tensor-parallel axis uses its own spans.  The weight arrives
    whole or as this rank's chunk along any one dim (kept by
    `gather_params`): a chunk that is the one span passes through, another
    chunk is all-gathered with a reduce-scattered gradient, and a whole
    weight has its gradient summed over the axis."""
    n, cut = tp_size(), [k for k in range(w.ndim) if w.shape[k] != shape[k]]
    dim %= w.ndim
    if cut:
        k = cut[0]
        r, size = tp_rank(), w.shape[k]
        if k == dim and list(spans) == [(r * size, (r + 1) * size)]:
            return w
        w = gather_sum(w, k, tp_group(), n)
    else:
        w = copy_to(w, tp_group(), n)
    parts = [w.narrow(dim, lo, hi - lo) for lo, hi in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def tp_whole_tree(tree, shapes):
    """``tree`` with each leaf made whole (`tp_whole`) along the dim where
    it arrives as this rank's chunk of the leaf's shape in ``shapes`` (a
    tree of the same structure), for a computation every rank repeats
    alike; a whole leaf as it is."""
    def whole(w, shape):
        cut = [k for k in range(w.ndim) if w.shape[k] != shape[k]]
        return tp_whole(w, cut[0], shape[cut[0]]) if cut else w

    return tree_map(whole, tree, shapes)


def gather_tp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' parts of an activation all-gathered along ``dim``, for a
    computation in which each rank uses the whole in its own way: the
    backward sums the cotangent over the axis and keeps this rank's part."""
    return gather_sum(x, dim, tp_group(), tp_size())


def tp_gather_whole(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' parts of an activation all-gathered along ``dim``, for a
    computation every rank repeats alike: the backward keeps this rank's
    part of the cotangent."""
    return gather(x, dim % x.ndim, tp_group(), tp_size(), tp_rank())


def tp_whole(w: torch.Tensor, dim: int, whole: int) -> torch.Tensor:
    """The whole of a weight along ``dim`` for a computation every rank of
    the tensor-parallel axis repeats alike: a kept chunk is all-gathered,
    and its gradient is this rank's chunk of the whole's."""
    if w.shape[dim] == whole:
        return w
    return gather(w, dim % w.ndim, tp_group(), tp_size(), tp_rank())
