"""Train-step factory: loss -> grad -> (optional microbatch accumulation)
-> optimizer, with remat handled inside the model (`cfg.remat`); the port
of `repro.train.train_step`.

``train_step(state, batch)`` returns ``(state, metrics)`` as the
reference's does, but the state's parameters and optimizer moments are
updated IN PLACE (see `repro_torch.train.optimizer`): the returned state
holds the same tensors.  `state_shapes` builds the state on the ``meta``
device (shapes and types, no memory).

With a ``mesh`` the state is DTensors placed by
`parallel.sharding.state_specs` (each rank holds its shards) and the step
is FSDP's.  It takes the whole batch, cuts the rank's part
(`parallel.sharding.local_batch`) and runs under
`parallel.context.activation_sharding`: the model gathers each period's
parameters where it uses them (`parallel.context.gather_params`), the
gradients come back to each leaf's placements as a mean over the
data-parallel ranks, each rank updates its own shards, and the metrics are
averaged over the data-parallel ranks.  This is the reference's ``jit``
with ``in_shardings``; tensor-parallel compute is not done (the ranks
along "model" compute the same thing).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .._tree import tree_map
from ..models import ModelConfig, init_lm, lm_loss
from ..parallel.comm import all_reduce_, dp_dims
from ..parallel.context import activation_sharding
from ..parallel.sharding import ShardingStrategy, batch_mesh_dims, default_strategy, local_batch
from .optimizer import Optimizer, global_norm


def init_state(generator: Optional[torch.Generator], cfg: ModelConfig,
               optimizer: Optimizer, device=None) -> Dict:
    """Fresh parameters from ``generator`` (on ``device``, by default the
    generator's), the optimizer's state, and step 0."""
    params = init_lm(generator, cfg, device=device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["embed"]["embedding"].device)}


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    loss_chunk: int = 0,
    n_microbatch: int = 1,
    mesh=None,
    strategy: Optional[ShardingStrategy] = None,
):
    """``train_step(state, batch) -> (state, metrics)``; batch: tensors
    ``inputs`` / ``targets`` (B, S) on the parameters' device (+
    ``encoder_embeds`` / ``vision_embeds`` (B, ., d), ``positions`` (B, S)
    or, under M-RoPE, (3, B, S)), the whole batch also on a ``mesh`` (a
    DeviceMesh; ``strategy`` by default `default_strategy(mesh)`).

    With ``n_microbatch > 1`` the batch dim is split (the second axis of
    (3, B, S) positions) and the gradients are accumulated in fp32 (bounds
    activation memory independently of the batch size); the metrics are
    the last microbatch's, as in the reference."""

    def single(params, batch):
        leaves = []

        def track(p):
            leaves.append(p.detach().requires_grad_(True))
            return leaves[-1]

        live = tree_map(track, params)
        with torch.enable_grad():
            loss, metrics = lm_loss(live, batch, cfg, loss_chunk=loss_chunk)
            grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                             materialize_grads=True))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return tree_map(lambda _: next(grads), live), metrics["loss"], metrics

    def split(key, v):
        """(n_microbatch, B / n_microbatch, ...) of a batch leaf."""
        if key == "positions" and v.ndim == 3:       # M-RoPE's (3, B, S)
            return v.reshape(3, n_microbatch, -1, *v.shape[2:]).transpose(0, 1)
        return v.reshape(n_microbatch, -1, *v.shape[1:])

    def accumulated(params, batch):
        micro = {k: split(k, v) for k, v in batch.items()}
        acc, loss_sum, metrics = None, 0.0, None
        for i in range(n_microbatch):
            grads, loss, metrics = single(params, {k: v[i] for k, v in micro.items()})
            if acc is None:
                acc = tree_map(lambda g: g.to(torch.float32, copy=True), grads)
            else:
                tree_map(lambda a, g: a.add_(g), acc, grads)
            loss_sum = loss_sum + loss
        return tree_map(lambda g: g.div_(n_microbatch), acc), loss_sum / n_microbatch, metrics

    def step(state, batch):
        params = state["params"]
        if n_microbatch > 1:
            grads, _, metrics = accumulated(params, batch)
        else:
            grads, _, metrics = single(params, batch)
        metrics = dict(metrics, grad_norm=global_norm(grads))
        if mesh is not None:
            metrics = _dp_mean(metrics, mesh, strategy)
        params, opt = optimizer.update(grads, state["opt"], params)
        return {"params": params, "opt": opt, "step": state["step"] + 1}, metrics

    if mesh is None:
        return step
    strategy = strategy or default_strategy(mesh)

    def sharded_step(state, batch):
        cut = batch_mesh_dims(batch, mesh, strategy, n_microbatch)
        batch = local_batch(batch, mesh, strategy, n_microbatch)
        with activation_sharding(mesh, strategy, batch_dims=cut):
            return step(state, batch)

    return sharded_step


def _dp_mean(metrics: Dict, mesh, strat) -> Dict:
    """Each rank's metrics (of its part of the batch) averaged over the
    data-parallel ranks; the gradient norm is the whole one already."""
    dims = [k for k in dp_dims(mesh, strat) if mesh.size(k) > 1]
    if not dims:
        return metrics
    n = 1
    for k in dims:
        n *= mesh.size(k)
    names = [k for k in metrics if k != "grad_norm"]
    summed = all_reduce_(torch.stack([metrics[k].float() for k in names]), mesh, dims) / n
    return dict(metrics, **{k: summed[i] for i, k in enumerate(names)})


def state_shapes(cfg: ModelConfig, optimizer: Optimizer) -> Dict:
    """The train state on the ``meta`` device: every leaf's shape and type,
    no memory (the counterpart of the reference's ShapeDtypeStruct tree)."""
    return init_state(None, cfg, optimizer, device="meta")
