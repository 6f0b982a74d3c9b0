"""The plain reference against the port's plain path at small sizes, in
float32: the loss, every leaf's gradient, and AdamW's updates."""

import pytest
import torch

import reference
from conftest import TINY, TINY_TRAFFIC, WIDE_HYBRID, tiny
from drivers import train as driver
from harness import check
from harness.weights import layout, make_weights, slices
from reference import common


def _port_loss_and_grads(cfg, weights, inputs, targets):
    from repro_torch.models import lm_loss
    params = driver.nested({k: v.clone().requires_grad_(True) for k, v in weights.items()})
    flat = driver._by_path(params)
    loss, _ = lm_loss(params, {"inputs": inputs, "targets": targets}, driver.model_config(cfg),
                      loss_chunk=TINY_TRAFFIC["loss_chunk"])
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), dict(zip(flat, grads))


@pytest.mark.parametrize("name", sorted(TINY))
def test_loss_and_every_gradient_match_the_port(name):
    cfg = tiny(name)
    weights = make_weights(cfg, 11, "cpu")
    inputs, targets = driver.make_batch(TINY_TRAFFIC, cfg["vocab_size"], 11, 0, "cpu")
    loss, grads = _port_loss_and_grads(cfg, weights, inputs, targets)

    lay = layout(cfg)
    params, _, _ = reference._leaves(lay, weights)
    ref_loss = reference.FAMILIES[cfg["family"]].loss(params, inputs, targets, cfg,
                                                      common.Precision())
    ref_grads = dict(zip(params, torch.autograd.grad(ref_loss, list(params.values()))))
    assert abs(loss - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    for leaf in lay:
        for part, g in slices(leaf, grads[leaf.name]):
            r = ref_grads[part]
            assert float((g - r).norm()) <= 1e-5 * float(r.norm()) + 1e-12, part


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", sorted(TINY))
def test_adamw_steps_match_the_port(name, steps):
    """One update and three: the port's `Trainer` and the reference read
    alike (losses, first gradients, changes) to float32 rounding."""
    cfg, traffic = tiny(name), dict(TINY_TRAFFIC, checked_steps=steps)
    ours = driver.program(cfg, traffic, 5, torch.device("cpu"), window=False).readings
    ref = driver.reference_readings(cfg, traffic, 5, torch.device("cpu"))
    found = check.numbers(ours, ref)
    assert found["loss_gap"] < 1e-6 and found["grad_gap"] < 1e-5, found
    assert found["delta_gap"] < 2e-5, found


def test_the_float8_control_is_further_from_float32_than_bfloat16():
    cfg = tiny("tiny-dense")
    seed, dev = 3, torch.device("cpu")
    ref = driver.reference_readings(cfg, TINY_TRAFFIC, seed, dev)
    ctl = driver.reference_readings(cfg, TINY_TRAFFIC, seed, dev, precision="float8")
    ours = driver.program(tiny("tiny-dense", "bfloat16"), TINY_TRAFFIC, seed, dev,
                          window=False).readings
    assert check.numbers(ctl, ref)["grad_gap"] > 3 * check.numbers(ours, ref)["grad_gap"]


def test_the_reference_scan_equals_the_recurrence():
    """The chunked form in `reference.hybrid.ssd` against the step-by-step
    recurrence, in float64, with a chunk that divides the length."""
    from reference.hybrid import ssd
    g = torch.Generator().manual_seed(0)
    b, S, H, P, N = 2, 24, 3, 4, 5
    x = torch.randn(b, S, H, P, generator=g, dtype=torch.float64)
    Bm, Cm = (torch.randn(b, S, N, generator=g, dtype=torch.float64) for _ in range(2))
    dt = torch.rand(b, S, H, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 3
    state = torch.zeros(b, H, P, N, dtype=torch.float64)
    ys = []
    for t in range(S):
        state = state * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bhp,bn,bh->bhpn", x[:, t], Bm[:, t], dt[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    torch.testing.assert_close(ssd(x, dt, A, Bm, Cm, chunk=8), torch.stack(ys, 1))


def test_the_benchmark_layout_is_the_ports():
    """The leaves the benchmark makes are the port's, by path, shape and
    type, at the cells' full sizes (on the meta device) and the tests'."""
    import json

    from repro_torch.train import state_shapes
    from harness import spec
    cfgs = [json.loads((spec.BENCH / "configs" / "granite-3-2b.json").read_text()), WIDE_HYBRID,
            *(tiny(n) for n in TINY)]
    for cfg in cfgs:
        opt = driver._optimizer(TINY_TRAFFIC["optimizer"])
        theirs = {k: (tuple(t.shape), t.dtype) for k, t in
                  driver._by_path(state_shapes(driver.model_config(cfg), opt)["params"]).items()}
        ours = {leaf.name: (leaf.shape, getattr(torch, leaf.dtype)) for leaf in layout(cfg)}
        assert ours == theirs, cfg["name"]
