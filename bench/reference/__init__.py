"""The plain reference of a training cell: the model of the cell's family
(`dense`, `hybrid`) and AdamW, in float32 with TF32 off.

`train` takes the weights and batches the benchmark hands to the program
too, runs the first steps and gives the readings `harness.check` compares:
each step's loss, each leaf's norm of the first gradient as the optimizer
takes it, and each leaf's norm of the change over the steps.  A leaf is
one layer's part of a parameter.  Each leaf is held in float32 and, after
each update, rounded to the type the configuration stores it in
(``param_dtype``; Mamba2's A_log, D and dt_bias in float32), as the
configuration trains it: an update below half a unit in the last place of
a bfloat16 weight is lost on both sides.

AdamW as the configuration's optimizer states it: a learning rate warmed
up linearly and decayed on a cosine to a tenth, the gradient clipped to a
global norm, bias-corrected moments, and weight decay on every leaf the
weights hand over with two or more axes (a stack of per-layer vectors
counts, as the optimizer sees the stack)."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from harness.weights import Leaf, slices
from reference import dense, hybrid
from reference.common import Precision, no_tf32

FAMILIES = {"dense": dense, "hybrid": hybrid}


def lr_at(step: int, o: Dict) -> float:
    """The learning rate of update ``step`` (1 for the first)."""
    base, warm, total = o["lr"], o["warmup"], o["total_steps"]
    if step < warm:
        return base * min((step + 1) / max(warm, 1), 1.0)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def _leaves(layout: Sequence[Leaf], weights: Dict[str, torch.Tensor]):
    """Each leaf as a float32 tensor of its own, with its stored type and
    whether it decays."""
    params, store, decays = {}, {}, {}
    for leaf in layout:
        for name, t in slices(leaf, weights[leaf.name]):
            params[name] = t.float().clone().requires_grad_(True)
            store[name] = t.dtype
            decays[name] = len(leaf.shape) >= 2
    return params, store, decays


def train(cfg: Dict, opt: Dict, layout: Sequence[Leaf], weights: Dict[str, torch.Tensor],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          first: Callable[[Leaf], torch.Tensor], precision: str = "float32") -> Dict:
    """The readings of ``len(batches)`` steps from ``weights`` (which it
    frees); ``first(leaf)`` makes a leaf's starting value again, for the
    change.  ``precision`` "float8" gives the control's readings."""
    family, prec = FAMILIES[cfg["family"]], Precision(precision)
    params, store, decays = _leaves(layout, weights)
    weights.clear()
    names: List[str] = list(params)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    out = {"loss": [], "grad": {}, "delta": {}}
    with no_tf32():
        for step, (inputs, targets) in enumerate(batches, start=1):
            loss = family.loss(params, inputs, targets.long(), cfg, prec)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            out["loss"].append(float(loss.detach()))
            del loss
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(opt["grad_clip"] / (norm + 1e-9), max=1.0)
            lr = lr_at(step, opt)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    g = g * scale
                    if step == 1:
                        out["grad"][k] = float(g.norm())
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    u = (m[k] / (1 - b1 ** step)) / ((v[k] / (1 - b2 ** step)).sqrt() + eps)
                    p = params[k]
                    if decays[k]:
                        u = u + wd * p
                    p.copy_((p - lr * u).to(store[k]).float())
            del grads
    with torch.no_grad():
        for leaf in layout:
            for name, t in slices(leaf, first(leaf)):
                out["delta"][name] = float((params[name] - t.float()).norm())
    return out
