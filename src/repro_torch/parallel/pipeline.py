"""Pipeline parallelism over a mesh axis (GPipe); the port of
`repro.parallel.pipeline`.

Stage parameters carry a leading (n_stages,) axis; each rank of the stage
axis applies its own slice.  The schedule runs ``n_micro + n_stages - 1``
ticks: stage 0 takes microbatch ``t``, every stage applies its block, and
activations move one hop forward (`batch_isend_irecv` over the stage
group); the last stage collects the finished microbatches, and a sum over
the stage group puts them on every stage.  Bubble fraction
(S - 1) / (M + S - 1).

The backward is autograd through the schedule.  Send/receive and the sum
across stages are `torch.autograd.Function`s whose backward sends the
cotangent the other way; as in the reference, every tick computes on every
stage and `torch.where` picks what counts, so that each rank's backward
graph holds every hop and all ranks run the hops' backward in the same
order.  Every rank holds the same outputs and counts them once: the
backward of the sum keeps the cotangent where the outputs came from.

Model-agnostic: ``apply_fn(stage_params, x) -> x`` is any per-stage block.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .._tree import tree_map
from .comm import chunk_of, gather, is_dtensor, local, mesh_dim


def stack_stages(params_list) -> Any:
    """Stack per-stage param trees on a leading (n_stages,) axis."""
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def split_layers_to_stages(stacked: Any, n_stages: int) -> Any:
    """Reshape an (L, ...) layer-stacked tree into (n_stages, L/S, ...)."""

    def re(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible into {n_stages} stages")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return tree_map(re, stacked)


def _exchange(x: torch.Tensor, group, to_rank: int, from_rank: int) -> torch.Tensor:
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), to_rank, group),
           dist.P2POp(dist.irecv, out, from_rank, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Hop(torch.autograd.Function):
    """Send to the next stage, receive from the previous one (a ring); the
    backward sends the cotangent to the previous stage and receives the
    next one's."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(y, group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.prv, ctx.nxt), None, None, None


class _SumStages(torch.autograd.Function):
    """Sum over the stage group (only the last stage's input is nonzero);
    every rank holds the result and counts it once, so the cotangent stays
    on each rank as it is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(
    stage_params: Any,        # leaves (n_stages, ...): whole, or DTensors cut on the stage axis
    x: torch.Tensor,          # (n_micro, B, ...) microbatched input
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    stage_axis: str = "pod",
    batch_axis: Optional[str] = None,   # B cut over this axis (e.g. "data")
) -> torch.Tensor:
    """Run the pipeline; returns the (n_micro, B, ...) outputs on every rank
    (replicated over the stage axis).  With ``batch_axis`` each rank runs
    its part of B and the outputs are gathered over that axis."""
    k = mesh_dim(mesh, stage_axis)
    n_stages = mesh.size(k)
    idx = mesh.get_local_rank(k)
    group = mesh.get_group(k)
    n_micro = x.shape[0]
    if batch_axis is not None:
        kb = mesh_dim(mesh, batch_axis)
        nb, ib = mesh.size(kb), mesh.get_local_rank(kb)
        x = chunk_of(x, 1, ib, nb)
    p = tree_map(lambda a: local(a)[0] if is_dtensor(a) else a[idx], stage_params)
    if n_stages == 1:
        outs = torch.stack([apply_fn(p, x[t]) for t in range(n_micro)])
    else:
        ranks = dist.get_process_group_ranks(group)
        nxt, prv = ranks[(idx + 1) % n_stages], ranks[(idx - 1) % n_stages]
        first = torch.tensor(idx == 0, device=x.device)
        last = torch.tensor(idx == n_stages - 1, device=x.device)
        acts = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        ticks = n_micro + n_stages - 1
        for t in range(ticks):
            feed = x[min(t, n_micro - 1)]
            y = apply_fn(p, torch.where(first, feed, acts))
            out_i = t - (n_stages - 1)
            if out_i >= 0:
                outs = torch.where(last, outs.index_copy(0, torch.tensor([out_i], device=x.device),
                                                        y[None]), outs)
            if t < ticks - 1:
                acts = _Hop.apply(y, group, nxt, prv)
        # Only the last stage holds real outputs; replicate across stages.
        outs = _SumStages.apply(torch.where(last, outs, torch.zeros_like(outs)), group)
    if batch_axis is not None:
        outs = gather(outs, 1, mesh.get_group(kb), nb, ib)
    return outs


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: idle ticks / total ticks."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
