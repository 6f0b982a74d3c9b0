#!/usr/bin/env python3
"""How far the reference's and the port's fp32 xLSTM stacks lie from a
float64 evaluation, on the CPU: why `tests/test_torch_xlstm.py` holds the
stack by the largest magnitude and not elementwise.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/xlstm_fp32_spread.py

For `reduced(xlstm-1.3b)` cut to 2 and 9 blocks (``mlstm_chunk`` 8, the
tests' weights from `repro.models.init_lm`), prints the largest distance
of each fp32 forward (the reference's and the port's) from the port run in
float64 throughout, and of their loss gradients, as multiples of an
elementwise 2e-5 (atol 2e-5 + rtol 2e-5).  The float64 run casts the
xLSTM mixers' fp32 recurrences up as well.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from repro import models as jmodels  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch._tree import tree_items, tree_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from test_torch_xlstm import XLSTM, _batch, _toks  # noqa: E402


class _Float64:
    """Stands in for `torch` inside `repro_torch.models.xlstm`, so that its
    fp32 recurrences run in float64."""
    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _in_float64(fn):
    tx.torch = _Float64()
    try:
        with ops.use_plain():
            return fn()
    finally:
        tx.torch = torch


def _grads(params, cfg, batch):
    leaves = []

    def track(t):
        leaves.append(t.clone().requires_grad_(True))
        return leaves[-1]

    live = tree_map(track, params)
    loss, _ = tmodels.lm_loss(live, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                              loss_chunk=8)
    return [g.detach().double().numpy() for g in torch.autograd.grad(loss, leaves)]


def _over(got, exact):
    return float((np.abs(np.asarray(got, np.float64) - exact) / (2e-5 + 2e-5 * np.abs(exact)))
                 .max())


def main():
    out = {}
    for n in (2, 9):
        xl = XLSTM(n, mlstm_chunk=8)
        cfg64 = dataclasses.replace(xl.tcfg, compute_dtype="float64", param_dtype="float64",
                                    logit_dtype="float64")
        p64 = tree_map(lambda t: t.double(), xl.tparams)
        toks = _toks(np.random.default_rng(32), 2, 32)
        ref = np.asarray(xl.jforward(xl.params, jnp.asarray(toks)), np.float64)
        port = tmodels.forward(xl.tparams, torch.from_numpy(toks), xl.tcfg)[0].numpy()
        exact = _in_float64(lambda: tmodels.forward(p64, torch.from_numpy(toks), cfg64)[0]
                            .numpy())
        batch = _batch(2, 32, seed=6)
        jg = jax.grad(lambda p: jmodels.lm_loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, xl.jcfg, loss_chunk=8)[0])(
            xl.params)
        tg = _grads(xl.tparams, xl.tcfg, batch)
        eg = _in_float64(lambda: _grads(p64, cfg64, batch))
        out[f"{n}_blocks"] = dict(
            forward_abs_vs_float64=dict(reference=float(np.abs(ref - exact).max()),
                                        port=float(np.abs(port - exact).max())),
            forward_largest_magnitude=float(np.abs(exact).max()),
            gradients_over_elementwise_tol_vs_float64=dict(
                reference=max(_over(a, e) for a, e in zip(jax.tree.leaves(jg), eg)),
                port=max(_over(a, e) for a, e in zip(tg, eg))))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
