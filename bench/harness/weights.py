"""The weights a cell trains, made by the benchmark from ``--seed``.

`layout` lists each leaf of a configuration in the layout the port takes
(a dotted path; the layers of a repeating period stacked on a leading
axis, a stack's tail layers and zamba2's shared block unstacked), with its
shape, type and how it starts.  `make_leaf` makes one leaf on the device
from its own generator, in one call, in the type it is trained in, so a
leaf can be made again alone (the reference takes the same weights, and
the program's change of each leaf is measured against it).  The program
and the reference both take these weights; neither makes its own.

How a leaf starts (as is usual for these families): a matrix normal with
fan-in scale, the embedding normal at d^-0.5, norm scales and Mamba2's D
one, its conv bias zero and conv weights normal at 0.1, A_log uniform in
log over [1, 16] and dt's bias the inverse softplus of a time step
log-uniform over [1e-3, 1e-1]."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    dtype: str
    init: str             # normal | ones | zeros | a_log | dt_bias
    std: float = 0.0
    stacked: bool = False  # the leading axis runs over layers


def period(cfg: Dict) -> int:
    return cfg.get("shared_attn_every") or 1


def mamba_dims(cfg: Dict) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim P, state N) of a Mamba2 mixer."""
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    return d_inner, d_inner // cfg["mamba_headdim"], cfg["mamba_headdim"], cfg["ssm_state"]


def _attn_block(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, str, float]]:
    d, dh = cfg["d_model"], cfg["d_head"]
    hq, hkv, ff = cfg["n_heads"] * dh, cfg["n_kv_heads"] * dh, cfg["d_ff"]
    p = cfg["param_dtype"]
    rows = [("norm1.scale", (d,), p, "ones", 0.0),
            ("attn.wq.w", (d, hq), p, "normal", d ** -0.5),
            ("attn.wk.w", (d, hkv), p, "normal", d ** -0.5),
            ("attn.wv.w", (d, hkv), p, "normal", d ** -0.5),
            ("attn.wo.w", (hq, d), p, "normal", hq ** -0.5),
            ("norm2.scale", (d,), p, "ones", 0.0)]
    if cfg["ffn_type"] == "swiglu":
        rows.append(("ffn.w_gate.w", (d, ff), p, "normal", d ** -0.5))
    rows += [("ffn.w_up.w", (d, ff), p, "normal", d ** -0.5),
             ("ffn.w_down.w", (ff, d), p, "normal", ff ** -0.5)]
    return rows


def _mamba_block(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str, str, float]]:
    d = cfg["d_model"]
    di, H, _, N = mamba_dims(cfg)
    conv = di + 2 * N
    p = cfg["param_dtype"]
    return [("norm1.scale", (d,), p, "ones", 0.0),
            ("mixer.in_proj.w", (d, 2 * di + 2 * N + H), p, "normal", d ** -0.5),
            ("mixer.conv_w", (cfg["ssm_conv"], conv), p, "normal", 0.1),
            ("mixer.conv_b", (conv,), p, "zeros", 0.0),
            ("mixer.A_log", (H,), "float32", "a_log", 0.0),
            ("mixer.D", (H,), "float32", "ones", 0.0),
            ("mixer.dt_bias", (H,), "float32", "dt_bias", 0.0),
            ("mixer.norm_scale", (di,), p, "ones", 0.0),
            ("mixer.out_proj.w", (di, d), p, "normal", di ** -0.5)]


_BLOCKS = {"dense": _attn_block, "hybrid": _mamba_block}


def layout(cfg: Dict) -> List[Leaf]:
    """Every leaf of ``cfg``'s parameters, in a fixed order."""
    d, V, p = cfg["d_model"], cfg["vocab_size"], cfg["param_dtype"]
    block = _BLOCKS[cfg["family"]](cfg)
    per = period(cfg)
    n_full, tail = divmod(cfg["n_layers"], per)
    out = [Leaf("embed.embedding", (V, d), p, "normal", d ** -0.5)]
    for j in range(per):
        out += [Leaf(f"blocks.pos{j}.{k}", (n_full, *s), t, i, std, True)
                for k, s, t, i, std in block]
    for j in range(tail):
        out += [Leaf(f"tail.{j}.{k}", s, t, i, std) for k, s, t, i, std in block]
    if cfg.get("shared_attn_every"):
        out += [Leaf(f"shared_attn.{k}", s, t, i, std) for k, s, t, i, std in _attn_block(cfg)]
    out.append(Leaf("final_norm.scale", (d,), p, "ones"))
    if not cfg.get("tie_embeddings"):
        out.append(Leaf("unembed.w", (d, V), p, "normal", d ** -0.5))
    return out


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` under run seed ``seed`` (any
    whole number): a 63-bit mix of the two."""
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)


def make_leaf(leaf: Leaf, seed: int, index: int, device) -> torch.Tensor:
    g = torch.Generator(device).manual_seed(leaf_seed(seed, index))
    dtype = DTYPES[leaf.dtype]
    if leaf.init == "normal":
        return torch.randn(leaf.shape, generator=g, device=device, dtype=dtype).mul_(leaf.std)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, device=device, dtype=dtype)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, device=device, dtype=dtype)
    u = torch.rand(leaf.shape, generator=g, device=device, dtype=torch.float32)
    if leaf.init == "a_log":                 # A = exp(u ln 16), log-uniform on [1, 16]
        return u.mul_(math.log(16.0)).to(dtype)
    if leaf.init == "dt_bias":               # softplus^-1 of dt log-uniform on [1e-3, 0.1]
        dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
        return torch.log(torch.expm1(dt)).to(dtype)
    raise ValueError(f"unknown init {leaf.init!r}")


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {leaf.name: make_leaf(leaf, seed, i, device) for i, leaf in enumerate(layout(cfg))}


def slices(leaf: Leaf, tensor: torch.Tensor) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of each layer's part of a leaf: ``name[i]`` for the
    i-th layer of a stacked leaf, the leaf itself otherwise.  These are the
    leaves the comparison that decides ``correct`` takes one by one."""
    if leaf.stacked:
        for i in range(tensor.shape[0]):
            yield f"{leaf.name}[{i}]", tensor[i]
    else:
        yield leaf.name, tensor
