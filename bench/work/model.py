"""What one training step of a configuration needs, from its shapes.

`train_flops`: the model's operations in a step, the forward's matrix
products (and attention's, over the pairs the causal mask keeps, and the
scan's recurrent form and the depthwise conv) times three for the forward
and backward, with nothing recomputed counted (``remat="block"`` runs the
forward twice; its second run is the program's choice, not the model's).
Norms, activations and the softmax's exponentials are left out.

`kernel_work`: for each hand-written kernel's computation, its
applications in one step, each counted once, with the work of each
(`work.kernels`).  A remat'd forward launches a kernel a second time for
no new work: that launch's device time counts against the kernel's share,
its work does not."""

from __future__ import annotations

from typing import Dict, List

from harness.peaks import least_time
from harness.weights import mamba_dims
from work import kernels as K


def attention_layers(cfg: Dict) -> int:
    """Applications of full attention in a forward: every layer of a dense
    stack; zamba2's shared block before each layer whose index is a
    multiple of its period."""
    if cfg["family"] == "hybrid":
        return -(-cfg["n_layers"] // cfg["shared_attn_every"])
    return cfg["n_layers"]


def mamba_layers(cfg: Dict) -> int:
    return cfg["n_layers"] if cfg["family"] == "hybrid" else 0


def _attn_block_matmul_params(cfg: Dict) -> int:
    d, dh = cfg["d_model"], cfg["d_head"]
    attn = 2 * d * cfg["n_heads"] * dh + 2 * d * cfg["n_kv_heads"] * dh
    ffn = (3 if cfg["ffn_type"] == "swiglu" else 2) * d * cfg["d_ff"]
    return attn + ffn


def _mamba_matmul_params(cfg: Dict) -> int:
    d = cfg["d_model"]
    di, h, _, n = mamba_dims(cfg)
    return d * (2 * di + 2 * n + h) + di * d


def forward_flops(cfg: Dict, batch: int, seq: int) -> float:
    tokens = batch * seq
    params = (attention_layers(cfg) * _attn_block_matmul_params(cfg)
              + cfg["d_model"] * cfg["vocab_size"])
    if mamba_layers(cfg):
        params += mamba_layers(cfg) * _mamba_matmul_params(cfg)
    flops = 2 * params * tokens
    a = K.flash_fwd(batch, seq, seq, cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"])
    flops += attention_layers(cfg) * a[0]
    if mamba_layers(cfg):
        di, h, p, n = mamba_dims(cfg)
        scan = K.ssm_fwd(batch, seq, h, p, n)[0]
        conv = 2 * cfg["ssm_conv"] * (di + 2 * n) * tokens
        flops += mamba_layers(cfg) * (scan + conv)
    return flops


def train_flops(cfg: Dict, batch: int, seq: int) -> float:
    return 3 * forward_flops(cfg, batch, seq)


def kernel_work(cfg: Dict, batch: int, seq: int) -> Dict[str, List[K.Work]]:
    """Kernel computation -> the work of each of its applications in one
    step: ``flash_fwd``, ``flash_bwd``, ``ssm_fwd``, ``ssm_bwd``, ``rms_norm``
    (forward and gradient together)."""
    isz = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    d, rows = cfg["d_model"], batch * seq
    attn = attention_layers(cfg)
    shape = (batch, seq, seq, cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"])
    out = {"flash_fwd": [K.flash_fwd(*shape, itemsize=isz)] * attn,
           "flash_bwd": [K.flash_bwd(*shape, itemsize=isz)] * attn}
    widths = [d] * (2 * attn + 1)                    # two norms a block and the final one
    if mamba_layers(cfg):
        di, h, p, n = mamba_dims(cfg)
        mix = mamba_layers(cfg)
        out["ssm_fwd"] = [K.ssm_fwd(batch, seq, h, p, n, isz)] * mix
        out["ssm_bwd"] = [K.ssm_bwd(batch, seq, h, p, n, isz)] * mix
        widths += [d, di] * mix                      # the block's norm and the gated norm
    out["rms_norm"] = ([K.rms_norm_fwd(rows, w, isz) for w in widths]
                       + [K.rms_norm_bwd(rows, w, isz) for w in widths])
    return out


def step_least_time(cfg: Dict, batch: int, seq: int, kernel: str) -> float:
    """Seconds one step's applications of ``kernel`` need at least."""
    return sum(least_time(ops, nb, peak) for ops, nb, peak in
               kernel_work(cfg, batch, seq).get(kernel, []))
