"""Sharding rules: leaf path -> partition spec, for params, optimizer
states, KV/SSM caches and batches, over the mesh axes (("pod",) "data",
"model"); the port of `repro.parallel.sharding`, with the same rule table.

Strategy (as the reference's):

  * batch        -> all DP axes ("pod" x "data")
  * TP ("model") -> attention heads, FFN hidden, vocab, Mamba/xLSTM channels
  * FSDP ("data")-> the d_model dim of every large matrix (ZeRO-3 style)
  * EP ("model") -> MoE expert dim (DBRX, Kimi)
  * KV caches    -> batch over DP, sequence over "model" (and over all axes
                    when the batch does not divide over DP, e.g. long_500k)

Every rule is divisibility-guarded: an axis that does not divide the dim is
dropped (replicated) rather than erroring, so reduced configs work on one
rank with the same code path.

A spec is a `PartitionSpec`: a tuple with one mesh axis name, tuple of
names or None per dim, as JAX's PartitionSpec holds them, so that the two
packages' specs compare directly.  The spec functions take a
`torch.distributed.device_mesh.DeviceMesh` or anything with ``shape`` and
``axis_names`` (a `runtime.elastic.MeshPlan`): they need the axis sizes,
not the ranks.  `placements` maps a spec to DTensor placements on a
DeviceMesh; `distribute_tree` puts a tree of whole tensors into them (each
rank keeps its own shard, no collective) and `gather_tree` takes it back
(a collective: every rank of the mesh must call it).
"""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .._tree import tree_map, tree_map_with_path


class PartitionSpec(tuple):
    """One entry a dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

# A leaf's place on a mesh: the DeviceMesh and one DTensor placement a mesh dim.
Layout = collections.namedtuple("Layout", "mesh placements")


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    dp: Tuple[str, ...] = ("data",)   # batch axes (("pod","data") multi-pod)
    tp: Optional[str] = "model"
    fsdp: Optional[str] = "data"      # param d_model dim; None -> replicate
    ep: Optional[str] = "model"       # expert dim
    seq: Optional[str] = "model"      # cache sequence axis
    moe: str = "auto_spmd"            # auto_spmd | ep_shardmap

    def axis(self, logical: Optional[str]):
        return {
            None: None,
            "dp": self.dp if len(self.dp) > 1 else (self.dp[0] if self.dp else None),
            "tp": self.tp,
            "fsdp": self.fsdp,
            "ep": self.ep,
            "seq": self.seq,
        }[logical]


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.shape)))


def default_strategy(mesh) -> ShardingStrategy:
    dp = tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
    return ShardingStrategy(dp=dp)


# --------------------------------------------------------------- rules ----
# (regex on "/"-joined path, logical spec per dim, right-aligned to shape).
_PARAM_RULES = [
    (r"embed/embedding$",            ("tp", "fsdp")),
    (r"unembed/w$",                  ("fsdp", "tp")),
    (r"(attn|cross|shared_attn/attn)/w[qkv]/w$", ("fsdp", "tp")),
    (r"(attn|cross|shared_attn/attn)/w[qkv]/b$", ("tp",)),
    (r"(attn|cross|shared_attn/attn)/wo/w$",     ("tp", "fsdp")),
    (r"(attn|cross|shared_attn/attn)/wo/b$",     (None,)),
    (r"(ffn|shared_attn/ffn)/w_(gate|up)/w$",    ("fsdp", "tp")),
    (r"(ffn|shared_attn/ffn)/w_(gate|up)/b$",    ("tp",)),
    (r"(ffn|shared_attn/ffn)/w_down/w$",         ("tp", "fsdp")),
    (r"(ffn|shared_attn/ffn)/w_down/b$",         (None,)),
    (r"moe/router/w$",               ("fsdp", None)),
    # Experts: E over the ep axis, d_model over fsdp.
    (r"moe/experts/w_(gate|up)/w$",  ("ep", "fsdp", None)),
    (r"moe/experts/w_down/w$",       ("ep", None, "fsdp")),
    (r"moe/experts/.*/b$",           ("ep", None)),
    (r"mixer/in_proj/w$",            ("fsdp", "tp")),
    (r"mixer/out_proj/w$",           ("tp", "fsdp")),
    (r"mixer/conv_w$",               (None, "tp")),
    (r"mixer/conv_b$",               ("tp",)),
    (r"mixer/(A_log|D|dt_bias)$",    (None,)),
    (r"mixer/norm_scale$",           ("tp",)),
    (r"mixer/(up|down)_proj/w$",     ("fsdp", "tp")),
    (r"mixer/w[qkv]/w$",             ("tp", None, None)),  # block-diag (nb,bs,bs)
    (r"mixer/w_gates/w$",            (None, "tp")),
    (r"mixer/r_gates$",              (None, None, None, None)),
    (r"mixer/w_up/w$",               (None, "tp")),
    (r"mixer/w_down/w$",             ("tp", "fsdp")),
    (r"norm.*/scale$",               (None,)),
    (r"norm.*/bias$",                (None,)),
    (r"final_norm/scale$",           (None,)),
]

_CACHE_RULES = [
    (r"(attn|cross)/(k|v)$",  (None, "dp", "seq", None, None)),   # B,S,Hkv,Dh (+layer)
    (r"mixer/conv$",          ("dp", None, "tp")),
    (r"mixer/state$",         ("dp", "tp", None, None)),          # B,H,P,N
    (r"mixer/C$",             ("dp", "tp", None, None)),
    (r"mixer/(n|m|c|h)$",     ("dp", "tp", None)),
    (r"index$",               ()),
]


def _right_align(logicals: Sequence, rank: int):
    """Pad a logical spec with leading Nones to the leaf's rank (the stacked
    (n_full,) layer axis and batch dims)."""
    return (None,) * (rank - len(logicals)) + tuple(logicals)


def _guarded(spec_axes, shape, mesh) -> PartitionSpec:
    sizes = axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec_axes):
        if ax is None:
            out.append(None)
            continue
        total = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            total *= sizes[a]
        out.append(ax if dim % total == 0 and dim > 0 else None)
    return P(*out)


def _match(path: str, rules, strat: ShardingStrategy, shape, mesh) -> Optional[PartitionSpec]:
    for pattern, logicals in rules:
        if re.search(pattern, path):
            axes = tuple(strat.axis(lg) for lg in _right_align(logicals, len(shape)))
            return _guarded(axes, shape, mesh)
    return None


def _tree_specs(tree, fn) -> Any:
    return tree_map_with_path(fn, tree, sep="/")


# ------------------------------------------------------------- frontends --
def param_specs(param_shapes, mesh, strat: ShardingStrategy):
    def fn(path, leaf):
        spec = _match(path, _PARAM_RULES, strat, tuple(leaf.shape), mesh)
        return P() if spec is None else spec      # replicate unknowns
    return _tree_specs(param_shapes, fn)


def opt_specs(opt_shapes, param_shapes, mesh, strat: ShardingStrategy):
    """Optimizer-state specs derived from the param rules: same-shape
    moments inherit the param spec; Adafactor's factored statistics drop
    the factored dim; int8 blocks extend the last dim's spec."""
    pflat: Dict[str, PartitionSpec] = {}
    tree_map_with_path(lambda path, s: pflat.__setitem__(path, s),
                       param_specs(param_shapes, mesh, strat), sep="/")

    def fn(path, leaf):
        shape = tuple(leaf.shape)
        # Strip the optimizer's wrappers to find the owning param path.
        base = re.sub(r"^(m|v|stats|q)/", "", path)
        base = re.sub(r"/(vr|vc|v|m|mq|ms|vq|vs)$", "", base)
        if base not in pflat:
            return P()
        pspec = tuple(pflat[base])
        spec = pspec + (None,) * (len(shape) - len(pspec))
        if path.endswith("/vr"):          # shape[:-1]
            spec = pspec[:-1] if len(pspec) else ()
        elif path.endswith("/vc"):        # shape[:-2] + shape[-1:]
            spec = pspec[:-2] + pspec[-1:] if len(pspec) >= 2 else ()
        elif path.endswith(("/mq", "/ms", "/vq", "/vs")):
            spec = pspec[:-1] + (pspec[-1], None) if len(pspec) else ()
        spec = tuple(spec[: len(shape)])
        spec = spec + (None,) * (len(shape) - len(spec))
        return _guarded(spec, shape, mesh)
    return _tree_specs(opt_shapes, fn)


def state_specs(state_shapes, mesh, strat: ShardingStrategy):
    return {
        "params": param_specs(state_shapes["params"], mesh, strat),
        "opt": opt_specs(state_shapes["opt"], state_shapes["params"], mesh, strat),
        "step": P(),
    }


def batch_specs(batch_shapes, mesh, strat: ShardingStrategy):
    dp = strat.axis("dp")

    def fn(path, leaf):
        shape = tuple(leaf.shape)
        if path.endswith("positions") and len(shape) == 3:     # M-RoPE (3, B, S)
            return _guarded((None, dp, None), shape, mesh)
        return _guarded((dp,) + (None,) * (len(shape) - 1), shape, mesh)
    return _tree_specs(batch_shapes, fn)


def cache_specs(cache_shapes, mesh, strat: ShardingStrategy, batch: int):
    sizes = axis_sizes(mesh)
    dp_total = 1
    for a in strat.dp:
        dp_total *= sizes[a]
    if batch % dp_total:
        # Single-stream decode: spread the sequence dim over everything
        # instead of the batch.
        strat = dataclasses.replace(
            strat, dp=(), seq=tuple(strat.dp) + ((strat.tp,) if strat.tp else ()))

    def fn(path, leaf):
        spec = _match(path, _CACHE_RULES, strat, tuple(leaf.shape), mesh)
        return spec if spec is not None else P()
    return _tree_specs(cache_shapes, fn)


# ------------------------------------------------------------ placements --
def placements(spec: Sequence, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where the spec names that axis at tensor dim ``d``, else
    ``Replicate()``.  A dim over two axes, ("pod", "data"), is `Shard(d)` on
    both mesh dims, the major axis first, as JAX lays it out; the axes must
    come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        ks = [names.index(a) for a in axes]
        if ks != sorted(ks):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        for k in ks:
            out[k] = Shard(d)
    return tuple(out)


def layouts(specs, mesh) -> Any:
    """The tree of `Layout` (mesh, placements) of a tree of specs."""
    return tree_map(lambda s: Layout(mesh, placements(s, mesh)), specs)


def local_chunk(t: torch.Tensor, layout: Layout) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``layout``: a view,
    cut along each sharded dim, mesh dim by mesh dim, major first."""
    coord = layout.mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    for k, pl in enumerate(layout.placements):
        if pl.is_shard():
            n = layout.mesh.size(k)
            size = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, coord[k] * size, size)
    return t


def distribute(t: torch.Tensor, layout: Layout) -> torch.Tensor:
    """A DTensor holding this rank's shard of the whole tensor ``t``, which
    every rank of the mesh holds alike; no collective.  A shard smaller
    than ``t`` is a copy, so that ``t``'s memory is freed with ``t``; a
    whole one is ``t`` itself."""
    from torch.distributed.tensor import DTensor

    part = local_chunk(t, layout)
    part = part.clone(memory_format=torch.contiguous_format) if part.numel() < t.numel() \
        else part.contiguous()
    return DTensor.from_local(part, layout.mesh, layout.placements, run_check=False)


def distribute_tree(tree, specs, mesh) -> Any:
    """``tree`` (whole tensors, the same on every rank) as DTensors placed
    by the matching tree of ``specs``."""
    return tree_map(lambda t, s: distribute(t, Layout(mesh, placements(s, mesh))), tree, specs)


def gather_tree(tree) -> Any:
    """Every DTensor leaf of ``tree`` as its whole tensor (`full_tensor`, a
    collective: every rank of the mesh must call it); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def batch_mesh_dims(batch: Dict[str, torch.Tensor], mesh, strat: ShardingStrategy,
                    n_microbatch: int = 1) -> Tuple[int, ...]:
    """The mesh dims that cut each microbatch's rows under `batch_specs`:
    the data-parallel dims, or none where the rows do not divide over them.
    The rows are those of ``targets`` (a train batch) or ``tokens`` (a
    serving batch)."""
    rows = batch["targets" if "targets" in batch else "tokens"].shape[0] // n_microbatch
    spec = batch_specs({"targets": torch.empty((rows, 1), device="meta")}, mesh,
                       strat)["targets"]
    return tuple(k for k, pl in enumerate(placements(spec, mesh)) if pl.is_shard())


def local_batch(batch: Dict[str, torch.Tensor], mesh, strat: ShardingStrategy,
                n_microbatch: int = 1):
    """This rank's part of a whole batch under `batch_specs`: of each of the
    ``n_microbatch`` microbatches in turn (the train step splits the rank's
    rows in order), so that the rank's microbatch m is its part of the
    whole batch's microbatch m, as the reference splits a sharded batch."""
    out = {}
    for k, v in batch.items():
        axis = 1 if k == "positions" and v.ndim == 3 else 0      # M-RoPE (3, B, S)
        micro = v.unflatten(axis, (n_microbatch, -1))
        spec = batch_specs({k: micro.select(axis, 0)}, mesh, strat)[k]
        spec = P(*spec[:axis], None, *spec[axis:])
        out[k] = local_chunk(micro, Layout(mesh, placements(spec, mesh))).flatten(axis, axis + 1)
    return out
