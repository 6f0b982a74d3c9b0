"""Collectives over one mesh dim, and the autograd functions built on them.

The port computes on each rank's local tensors; what JAX's SPMD partitioner
derives from shardings is written out here:

  * `gather_param` (FSDP): a parameter's shards are all-gathered into the
    whole tensor for the computation; the backward reduce-scatters the
    gradient back to the shard, as a mean over the data-parallel mesh dims
    (each rank's loss is the mean over its own part of the batch).  Along
    the other mesh dims every rank computes the same thing, so the
    backward takes its shard of the gradient there without a collective.
  * `copy_to`, `split`, `gather`, `all_to_all`, `scale_grad`: the pieces of
    the expert-parallel MoE and the pipeline, each with the backward that
    sends the cotangent the other way.

A group of one rank is skipped: no collective runs, and every result is
the input itself, so a (1, 1) mesh computes bit for bit what one device
does.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch
import torch.distributed as dist


def local(t: torch.Tensor) -> torch.Tensor:
    """The local tensor of a DTensor (its storage: an in-place write reaches
    the DTensor), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def mesh_device(mesh) -> torch.device:
    """The device of this rank's tensors on ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def mesh_dim(mesh, axis: str) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def all_reduce_(x: torch.Tensor, mesh, dims: Iterable[int]) -> torch.Tensor:
    """Sum ``x`` in place over the mesh dims ``dims`` (each a group)."""
    for k in dims:
        if mesh.size(k) > 1:
            dist.all_reduce(x, group=mesh.get_group(k))
    return x


def sharding_dims(placements, tensor_dim=None) -> Tuple[int, ...]:
    """The mesh dims that shard tensor dim ``tensor_dim`` (any dim if None)."""
    return tuple(k for k, pl in enumerate(placements)
                 if pl.is_shard() and (tensor_dim is None or pl.dim == tensor_dim))


def all_gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum over the group of ``x``, cut into ``n`` along ``dim``: this
    rank's part."""
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def chunk_of(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


# ------------------------------------------------------------------ FSDP --
class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, placements, dp_dims, keep):
        ctx.mesh, ctx.placements, ctx.dp_dims, ctx.keep = mesh, placements, dp_dims, keep
        for k in reversed(range(mesh.ndim)):              # minor first
            pl = placements[k]
            if pl.is_shard() and k not in keep:
                x = all_gather_dim(x, pl.dim, mesh.get_group(k) if mesh.size(k) > 1 else None,
                                   mesh.size(k))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.mesh, ctx.placements
        coord = mesh.get_coordinate()
        n_dp = 1
        wide = g.dtype in (torch.bfloat16, torch.float16) and any(
            mesh.size(k) > 1 for k in ctx.dp_dims)
        out = g.float() if wide else g           # reduce low-precision gradients in fp32
        for k in range(mesh.ndim):                # major first
            pl, n = placements[k], mesh.size(k)
            cut = pl.is_shard() and k not in ctx.keep
            if k in ctx.dp_dims:
                n_dp *= n
                if n == 1:
                    continue
                if cut:
                    out = reduce_scatter_dim(out, pl.dim, mesh.get_group(k), n)
                else:
                    out = out.contiguous()
                    dist.all_reduce(out, group=mesh.get_group(k))
            elif cut:
                out = chunk_of(out, pl.dim, coord[k], n)
        if n_dp > 1:
            out = out / n_dp
        return out.to(g.dtype).contiguous(), None, None, None, None


def dp_dims(mesh, strat) -> Tuple[int, ...]:
    return tuple(k for k, name in enumerate(mesh.mesh_dim_names) if name in strat.dp)


def gather_param(t, strat, keep: Sequence[int] = ()) -> torch.Tensor:
    """The whole tensor of the DTensor parameter ``t`` (its shards along
    the mesh dims in ``keep`` stay cut), differentiable: the gradient
    returns to ``t``'s placements as a mean over the data-parallel dims."""
    mesh = t.device_mesh
    if mesh.size() == 1:                  # the local tensor is the whole one
        return t.to_local()
    return _GatherParam.apply(t.to_local(), mesh, tuple(t.placements), dp_dims(mesh, strat),
                              tuple(keep))


# ------------------------------------------- group-wise autograd pieces --
class _CopyTo(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the group (the
    input feeds computations that differ across the group's ranks)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.n > 1:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _Split(torch.autograd.Function):
    """This rank's chunk along ``dim``; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return chunk_of(x, dim, i, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group, ctx.n), None, None, None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward takes this rank's chunk (every
    rank holds the same whole output, and counts it once)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.dim, ctx.n, ctx.i = dim, n, i
        return all_gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.dim, ctx.i, ctx.n).contiguous(), None, None, None, None


class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` with equal splits along dim 0; it is its own
    adjoint, so the backward sends the cotangent back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def copy_to(x, group, n):
    return _CopyTo.apply(x, group, n) if n > 1 else x


def scale_grad(x, scale: float):
    return _ScaleGrad.apply(x, scale) if scale != 1.0 else x


def split(x, dim, group, n, i):
    return _Split.apply(x, dim, group, n, i) if n > 1 else x


def gather(x, dim, group, n, i):
    return _Gather.apply(x, dim, group, n, i) if n > 1 else x


def all_to_all(x, group, n):
    return _AllToAll.apply(x, group) if n > 1 else x
