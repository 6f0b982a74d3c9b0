"""Optimizers on trees of tensors: AdamW, Adafactor (factored second
moment) and block-quantized 8-bit Adam (int8 moments + per-block fp32
scales), the port of `repro.train.optimizer`.

Interface as in the reference: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (params, state)``.  Every state
leaf is fp32 (int8 for the quantized moments), and weight decay applies to
leaves with ``p.ndim >= 2``.

Unlike the reference, which is functional, the port updates IN PLACE where
that saves memory: ``update`` writes the new values into the ``params``
tensors and the fp32 moment tensors of ``state`` and returns those same
objects, and it works leaf by leaf, so that only one leaf's fp32
temporaries live at a time (for granite-3-2b's stacked FFN weights, 2.7 GB
each) instead of an fp32 copy of every gradient.  `adafactor` goes further
and updates a large stacked leaf a run of its leading rows at a time (one
layer's stacked expert weights of dbrx-132b are 4.2 GB in fp32), in two
passes because its update clipping takes the RMS over the whole leaf.
``grads`` are not modified.

Sharded trees (DTensors placed by `parallel.sharding.state_specs`, as the
sharded train step holds them) are updated shard by shard on each rank's
local tensors.  Every reduction over a whole leaf or over a cut dim runs
across the ranks that hold its parts: the global norm, Adafactor's row
and column means and its update clipping.  `adam8bit`'s int8 blocks run
along the last dim; where that dim is cut at a block edge each rank
quantizes its own blocks, and a leaf cut elsewhere is updated whole
(gathered, updated, cut again).  A mesh dim of one rank cuts nothing, so
on a one-rank mesh the update is the unsharded one, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from .._tree import tree_leaves, tree_map
from ..parallel.comm import all_reduce_, is_dtensor, local, sharding_dims


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (grads, state, params) -> (params, state), in place


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warm-up, then cosine decay to ``min_frac * base_lr``; the
    learning rate at ``step`` (an int or a tensor) as a 0-d fp32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


# fp32 temporaries of a large leaf are made a run of this many elements at a
# time (~256 MB each).
_CHUNK_ELEMENTS = 1 << 26


def _square_norm(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares of ``x`` in fp32.  `vector_norm` casts its input to
    fp32 first, so a large leaf is taken a run of `_CHUNK_ELEMENTS` at a
    time (a dbrx-132b stacked expert gradient would copy to 12.7 GB)."""
    flat = x.reshape(-1)
    norm = lambda t: torch.linalg.vector_norm(t, dtype=torch.float32).square()
    return torch.stack([norm(flat[i:i + _CHUNK_ELEMENTS])
                        for i in range(0, flat.numel(), _CHUNK_ELEMENTS)]).sum()


def _layout(t):
    """(mesh, placements) of a DTensor, else None."""
    return (t.device_mesh, tuple(t.placements)) if is_dtensor(t) else None


def _cut(lay, tensor_dim=None):
    """The mesh dims of more than one rank that cut ``tensor_dim`` of a
    leaf laid out as ``lay`` (any dim if None)."""
    if lay is None:
        return ()
    mesh, pls = lay
    return tuple(k for k in sharding_dims(pls, tensor_dim) if mesh.size(k) > 1)


def _ranks(lay, dims) -> int:
    n = 1
    for k in dims:
        n *= lay[0].size(k)
    return n


def _mean(x: torch.Tensor, dim: int, lay, tensor_dim: int, keepdim: bool = False):
    """``x.mean(dim)``, where ``dim`` is the leaf's ``tensor_dim``: over the
    whole dim, across the ranks that cut it."""
    m = x.mean(dim, keepdim=keepdim)
    cut = _cut(lay, tensor_dim)
    if cut:
        m = all_reduce_(m.contiguous(), lay[0], cut) / _ranks(lay, cut)
    return m


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (of a DTensor leaf,
    its parts' sums added across the ranks that hold them)."""
    leaves = tree_leaves(tree)
    sq = [_square_norm(local(x)) for x in leaves]
    groups = {}
    for i, x in enumerate(leaves):
        lay = _layout(x)
        if _cut(lay):
            groups.setdefault((id(lay[0]), _cut(lay)), (lay[0], []))[1].append(i)
    for (_, cut), (mesh, idx) in groups.items():
        summed = all_reduce_(torch.stack([sq[i] for i in idx]), mesh, cut)
        for j, i in enumerate(idx):
            sq[i] = summed[j]
    return torch.sqrt(torch.stack(sq).sum())


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(fp32 copies of ``grads`` scaled to a global norm of at most
    ``max_norm``, the norm before scaling).  Kept for the reference's API:
    `adamw` does not call it, but scales each leaf by the same `_clip_scale`
    as it updates it, so that no fp32 copy of every gradient is made."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _step_of(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _zip_leaves(params, grads, stats):
    """(p, g, s) triples; ``stats`` holds a dict where ``params`` holds a tensor."""
    if isinstance(params, dict):
        for k in params:
            yield from _zip_leaves(params[k], grads[k], stats[k])
    elif isinstance(params, (list, tuple)):
        for p, g, s in zip(params, grads, stats):
            yield from _zip_leaves(p, g, s)
    else:
        yield params, grads, stats


# ------------------------------------------------------------------ AdamW --
def adamw(
    lr_fn,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step_of(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        scale = _clip_scale(global_norm(grads), grad_clip)
        lr = lr_fn(local(step))
        stepf = local(step).to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def upd(p, g, m, v):
            p, g, m, v = local(p), local(g), local(m), local(v)
            g32 = g.float() * scale
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            del g32
            denom = (v / bc2).sqrt_().add_(eps)
            u = (m / bc1).div_(denom)
            del denom
            p32 = p.float()
            if p.ndim >= 2:
                u.add_(p32, alpha=weight_decay)
            p.copy_(p32 - lr * u)

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer("adamw", init, update)


# -------------------------------------------------------------- Adafactor --
_FACTOR_MIN = 128  # factor only when both trailing dims are at least this


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= _FACTOR_MIN and shape[-2] >= _FACTOR_MIN


def _row_runs(p, g, s):
    """(param, gradient, statistics) views over runs of ``p``'s leading rows
    (every axis but the last two), at most `_CHUNK_ELEMENTS` elements a run
    where a row is smaller than that; one run, the whole leaf, for a leaf of
    fewer than three axes or elements."""
    if p.ndim < 3 or p.numel() <= _CHUNK_ELEMENTS:
        return [(p, g, s)]
    mat = p.shape[-2:]
    rows = p.numel() // (mat[0] * mat[1])
    per = max(1, _CHUNK_ELEMENTS // (mat[0] * mat[1]))
    views = {k: v.reshape(rows, *v.shape[p.ndim - 2:]) for k, v in s.items()}
    P, G = p.view(rows, *mat), g.reshape(rows, *mat)
    return [(P[i:i + per], G[i:i + per], {k: v[i:i + per] for k, v in views.items()})
            for i in range(0, rows, per)]


def adafactor(
    lr_fn,
    decay: float = 0.8,           # beta2 = 1 - step^-decay
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Shazeer & Stern 2018, factored second moment, no first moment."""

    def init(params):
        def stats(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"stats": tree_map(stats, params), "step": _step_of(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        beta2 = 1.0 - local(step).to(torch.float32) ** (-decay)
        lr = lr_fn(local(step))

        def direction(g, s, first, lay, nd):
            """The unclipped update g / sqrt(vhat); ``first`` moves the
            statistics ``s`` on by this step's gradient first.  ``lay`` and
            ``nd`` are the leaf's layout and rank (the means over its last
            two dims run across the ranks that cut them)."""
            g = g.float()
            if first:
                g2 = g.square() + eps
                if "vr" in s:
                    s["vr"].copy_(beta2 * s["vr"] + (1 - beta2) * _mean(g2, -1, lay, nd - 1))
                    s["vc"].copy_(beta2 * s["vc"] + (1 - beta2) * _mean(g2, -2, lay, nd - 2))
                else:
                    s["v"].copy_(beta2 * s["v"] + (1 - beta2) * g2)
                del g2
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                denom = _mean(vr, -1, lay, nd - 2, keepdim=True)[..., None]
                vhat = (vr[..., None] * vc[..., None, :]) / torch.clamp(denom, min=eps)
            else:
                vhat = s["v"]
            return g * torch.rsqrt(vhat + eps)

        def upd(p, g, s):
            lay, nd, numel = _layout(p), p.ndim, p.numel()
            cut = _cut(lay)
            p, g, s = local(p), local(g), {k: local(v) for k, v in s.items()}
            runs = _row_runs(p, g, s)
            if len(runs) == 1:
                u = direction(g, s, True, lay, nd)
                if cut:
                    ms = all_reduce_(u.square().sum(), lay[0], cut) / numel
                else:
                    ms = torch.mean(u.square())
            else:        # the RMS over every run first, then each run again
                ms = sum(direction(gr, sr, True, lay, nd).square().sum() for _, gr, sr in runs)
                if cut:
                    ms = all_reduce_(ms, lay[0], cut)
                ms = ms / numel
            # Update clipping (RMS at most the threshold).
            rms = torch.sqrt(ms + 1e-30)
            for pr, gr, sr in runs:
                ur = u if len(runs) == 1 else direction(gr, sr, False, lay, nd)
                ur = ur / torch.clamp(rms / clip_threshold, min=1.0)
                p_new = pr.float() - lr * ur
                if weight_decay and p.ndim >= 2:
                    p_new = p_new - lr * weight_decay * pr.float()
                pr.copy_(p_new)

        for p, g, s in _zip_leaves(params, grads, state["stats"]):
            upd(p, g, s)
        return params, {"stats": state["stats"], "step": step}

    return Optimizer("adafactor", init, update)


# -------------------------------------------------------------- 8-bit Adam --
_Q_BLOCK = 128


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 block quantization along the last dim."""
    pad = (-x.shape[-1]) % _Q_BLOCK
    xp = F.pad(x, (0, pad))
    blocks = xp.reshape(*xp.shape[:-1], -1, _Q_BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = (q.to(torch.float32) * scale).reshape(*q.shape[:-2], -1)
    return x[..., : shape[-1]].reshape(shape)


def _quantize_sqrt(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-negative second moments are quantized in the sqrt domain (linear
    int8 rounds small v to 0 and 1/sqrt(v + eps) explodes)."""
    return _quantize(torch.sqrt(torch.clamp(v, min=0.0)))


def _dequantize_sqrt(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return torch.square(_dequantize(q, scale, shape))


def adam8bit(
    lr_fn,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    """Adam with int8-quantized moments (Dettmers-style block quantization):
    about 2.1 bytes of optimizer state a parameter instead of 8."""

    def init(params):
        def q(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            mq, ms = _quantize(z)
            vq, vs = _quantize_sqrt(z)
            return {"mq": mq, "ms": ms, "vq": vq, "vs": vs}
        return {"q": tree_map(q, params), "step": _step_of(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(local(step))
        stepf = local(step).to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def upd(p, g, s):
            g = g.float()
            m = b1 * _dequantize(s["mq"], s["ms"], p.shape) + (1 - b1) * g
            v = b2 * _dequantize_sqrt(s["vq"], s["vs"], p.shape) + (1 - b2) * torch.square(g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            decay = weight_decay if p.ndim >= 2 else 0.0
            p.copy_(p.float() - lr * (u + decay * p.float()))
            s["mq"], s["ms"] = _quantize(m)
            s["vq"], s["vs"] = _quantize_sqrt(v)

        def upd_sharded(p, g, s):
            """A DTensor leaf: its own blocks where the last dim is cut at a
            block edge (or not cut), else updated whole and cut again."""
            from torch.distributed.tensor import DTensor

            from ..parallel.sharding import Layout, local_chunk

            mesh = p.device_mesh
            lp, ls = local(p), {k: local(v) for k, v in s.items()}
            aligned = not _cut(_layout(p), p.ndim - 1) or (
                lp.shape[-1] % _Q_BLOCK == 0 and ls["mq"].shape[-2] * _Q_BLOCK == lp.shape[-1])
            if aligned:
                upd(lp, local(g), ls)
            else:
                whole = {k: v.full_tensor() for k, v in s.items()}
                wp = p.full_tensor()
                upd(wp, g.full_tensor(), whole)
                lp.copy_(local_chunk(wp, Layout(mesh, p.placements)))
                ls = {k: local_chunk(v, Layout(mesh, s[k].placements)).contiguous()
                      for k, v in whole.items()}
            for k, v in ls.items():
                s[k] = DTensor.from_local(v, mesh, s[k].placements, run_check=False)

        for p, g, s in _zip_leaves(params, grads, state["q"]):
            (upd_sharded if is_dtensor(p) else upd)(p, g, s)
        return params, {"q": state["q"], "step": step}

    return Optimizer("adam8bit", init, update)


def make_optimizer(name: str, lr: float = 3e-4, warmup: int = 100,
                   total_steps: int = 10_000, **kw) -> Optimizer:
    lr_fn = cosine_schedule(lr, warmup, total_steps)
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    if name == "adam8bit":
        return adam8bit(lr_fn, **kw)
    raise ValueError(f"unknown optimizer {name!r}")

