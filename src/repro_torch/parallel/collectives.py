"""Gradient compression for slow collective axes (the inter-pod "pod"
axis); the port of `repro.parallel.collectives`.

`compressed_psum_mean`: int8 block-quantized reduce-scatter (an
`all_to_all_single` of each rank's chunks), a local mean, then an int8
all-gather, with **error feedback**: the quantization residual of what this
rank sent is returned, to be added to the next step's input, so the error
does not accumulate over steps.  Wire bytes are about a quarter of an fp32
ring all-reduce.

Usage (multi-pod DP sync):

    grads, err = pod_sync_grads(grads, err, mesh, axis="pod")

The port's ``x`` is each rank's own tensor (the reference's is replicated
over the axis in layout, its per-device bodies differing only in data).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .._tree import tree_items, tree_map, tree_map_with_path
from .comm import mesh_dim

_BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def _compressed_mean(x: torch.Tensor, err: torch.Tensor, group, n: int):
    """Quantize (x + err), int8 all-to-all (the reduce-scatter phase), a
    local mean of the owned chunk, quantize, int8 all-gather."""
    y = (x + err).float()
    shape = y.shape
    flat = y.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % (n * _BLOCK)))
    chunks = flat.reshape(n, -1)                       # one chunk a peer
    q, scale = _quantize(chunks)
    q = q.reshape(n, -1, _BLOCK)
    scale = scale.reshape(n, -1, 1)
    q_rs, s_rs = torch.empty_like(q), torch.empty_like(scale)
    dist.all_to_all_single(q_rs, q, group=group)       # everyone receives the chunk it owns
    dist.all_to_all_single(s_rs, scale, group=group)
    owned = torch.sum(q_rs.to(torch.float32) * s_rs, dim=0) / n
    qo, so = _quantize(owned.reshape(1, -1))
    qg = [torch.empty_like(qo) for _ in range(n)]
    sg = [torch.empty_like(so) for _ in range(n)]
    dist.all_gather(qg, qo, group=group)               # int8 again
    dist.all_gather(sg, so, group=group)
    mean = (torch.cat(qg).to(torch.float32) * torch.cat(sg)).reshape(-1)[: flat.numel()]
    # Error feedback: what the wire lost of this rank's contribution.
    sent = _dequantize(q.reshape(-1, _BLOCK), scale.reshape(-1, 1), (flat.numel(),))
    new_err = (y.reshape(-1) - sent[: y.numel()]).reshape(shape)
    return mean[: y.numel()].reshape(shape).to(x.dtype), new_err.to(x.dtype)


def compressed_psum_mean(x: torch.Tensor, err: torch.Tensor, mesh, axis: str = "pod"):
    """Mean of ``x`` over ``axis`` with int8 wire traffic and error
    feedback: returns (mean, new err).  An axis of one rank returns the
    inputs unchanged."""
    k = mesh_dim(mesh, axis)
    n = mesh.size(k)
    if n == 1:
        return x, err
    return _compressed_mean(x, err, mesh.get_group(k), n)


def pod_sync_grads(grads: Any, err: Any, mesh, axis: str = "pod"):
    """Tree-mapped compressed mean over the pod axis (multi-pod DP sync)."""
    pairs = {path: compressed_psum_mean(g, e, mesh, axis)
             for (path, g), (_, e) in zip(tree_items(grads), tree_items(err))}
    pick = lambda i: tree_map_with_path(lambda path, _: pairs[path][i], grads)
    return pick(0), pick(1)


def init_error_feedback(grads_like: Any) -> Any:
    return tree_map(torch.zeros_like, grads_like)
