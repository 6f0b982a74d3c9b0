"""Expert-parallel MoE dispatch with explicit all-to-alls; the port of
`repro.parallel.moe_ep` (the reference runs it under `shard_map`).

Each rank of the model axis holds E / n_ep experts (the ep axis of the
param rules) and its data rank's (B / dp, S, d) tokens:

  tokens, cut along S by the model rank when S divides  ->  local top-k
  route  ->  capacity-packed per-expert send buffers (E, C, d)  ->
  all-to-all over the model axis (E -> E / n_ep, C -> C * n_ep)  ->  the
  local experts' FFN (their FSDP dim gathered)  ->  reverse all-to-all  ->
  local combine  ->  the outputs gathered along S again.

Capacity is per source rank (over its own tokens), so with no drops this
equals `models.moe.moe_ffn` and with drops the drop policy differs, as in
the reference.  The aux loss is each rank's, averaged over the whole mesh.

The backward is autograd through `parallel.comm`'s functions: the
all-to-alls send the cotangents back; the router's gradient is summed over
the model axis (its ranks route different tokens); the aux mean passes
1 / n_model of its cotangent to each rank, as the gradients of the train
step are then averaged over the data-parallel ranks only.  When S does not
divide over the model axis every model rank routes all tokens (the
reference's replicated ``x_spec``); each then passes 1 / n_ep of the
outputs' cotangent into the layer, and the inputs' gradient is summed over
the model axis.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.moe import _plan, aux_losses, capacity, expert_ffn, router_probs
from .comm import (all_reduce_, all_to_all, copy_to, gather, gather_param, is_dtensor,
                   mesh_dim, scale_grad, split)


class _MeshMean(torch.autograd.Function):
    """Mean over every rank of the mesh; the backward gives each rank
    ``1 / n_model`` of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, n_model):
        ctx.n_model = n_model
        out = x.clone()
        all_reduce_(out, mesh, range(mesh.ndim))
        return out / mesh.size()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_model, None, None


def _local_experts(experts: Dict, strat, k_ep: int) -> Dict:
    """This rank's experts with their FSDP dim gathered (the expert dim
    stays cut over the ep mesh dim)."""
    def one(w):
        return gather_param(w, strat, keep=(k_ep,)) if is_dtensor(w) else w
    return {name: {"w": one(leaf["w"])} for name, leaf in experts.items()}


def moe_ffn_ep(params: Dict, x: torch.Tensor, cfg: ModelConfig, mesh,
               strat) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Drop-in for `models.moe.moe_ffn` with explicit EP collectives.
    ``x``: this rank's (B / dp, S, d); ``params["router"]["w"]`` whole;
    ``params["experts"]`` DTensors placed by the param rules (E over the
    model axis).  Returns (out (B / dp, S, d), aux, metrics)."""
    k = mesh_dim(mesh, strat.tp)
    n_ep, r = mesh.size(k), mesh.get_local_rank(k)
    group = mesh.get_group(k)
    B, S, d = x.shape
    seq_ok = S % n_ep == 0
    xs = split(x, 1, group, n_ep, r) if seq_ok else copy_to(x, group, n_ep)
    router_w = copy_to(params["router"]["w"], group, n_ep)
    experts = _local_experts(params["experts"], strat, k)

    T = B * xs.shape[1]
    xf = xs.reshape(T, d)
    logits, probs, top_p, top_ids = router_probs({"router": {"w": router_w}}, xf, cfg)
    cap = capacity(T, cfg)
    order, token_src, buffer_idx, keep, weight = _plan(top_ids, top_p, T, cfg, cap)

    # Pack the send buffers (E, cap, d); dropped assignments go to a dump row.
    E, E_loc = cfg.n_experts, cfg.n_experts // n_ep
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((buffer_idx,), xf[token_src] * keep[:, None].to(x.dtype))
    send = buf[:-1].reshape(E, cap, d)
    # Dispatch: chunk j of the experts goes to model rank j; what arrives is
    # (source, E_loc, cap, d), laid out as (E_loc, source * cap, d).
    recv = all_to_all(send, group, n_ep).reshape(n_ep, E_loc, cap, d)
    recv = recv.transpose(0, 1).reshape(E_loc, n_ep * cap, d)
    y = expert_ffn(experts, recv, cfg)
    # Return: each source's rows back to it, in its (E, cap, d) layout.
    y = y.reshape(E_loc, n_ep, cap, d).transpose(0, 1).reshape(E, cap, d)
    back = all_to_all(y, group, n_ep)
    yf = torch.cat([back.reshape(-1, d), back.new_zeros((1, d))])
    gathered = yf[buffer_idx] * (weight * keep)[:, None].to(yf.dtype)
    out = gathered[torch.argsort(order)].reshape(T, cfg.top_k, d).sum(1)
    out = out.reshape(B, -1, d)
    out = gather(out, 1, group, n_ep, r) if seq_ok else scale_grad(out, 1.0 / n_ep)

    aux, metrics = aux_losses(logits, probs, top_ids, cfg)
    aux = _MeshMean.apply(aux, mesh, n_ep)
    metrics = {k_: v.detach() for k_, v in metrics.items()}
    metrics["moe_drop_frac"] = 1.0 - keep.float().mean()
    metrics["moe_ep"] = torch.ones((), device=x.device)
    return out, aux, metrics
