"""The rms_norm kernel's split-row entries (`kernels.rmsnorm.rms_sumsq`,
`rms_norm_sumsq`, and `split_rms_norm` over them), which normalise a row
whose channels lie on several ranks of the "model" axis (the Mamba2 and
xLSTM mixers' norms over d_inner), held here on the CPU, where the wrappers
run their plain versions: a row cut into parts, each part's sum of squares
summed, then each part scaled, is the whole row's `rms_norm` and the JAX
package's, forward and backward (fp32 2e-5, bf16 5e-2, as
tests/test_kernels.py's ``_tol``)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rk
from repro_torch.models import layers

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}


def _inputs(dtype, shape=(3, 5, 96), seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3).to(dtype)
    scale = torch.from_numpy(rng.standard_normal(shape[-1]).astype(np.float32)).to(dtype)
    return x, scale


def _split(x, scale, n, eps=1e-5):
    """The parts of the row normalised from their summed sums of squares,
    the sum in the graph as the ranks' all-reduce is, concatenated."""
    xs, ss = x.chunk(n, -1), scale.chunk(n)
    total = sum(rk._SumSqFn.apply(t, False) for t in xs)
    return torch.cat([rk._NormFromSumSqFn.apply(t, total, s, eps, x.shape[-1], False)
                      for t, s in zip(xs, ss)], -1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_a_row_split_into_parts_is_the_whole_rows_norm(dtype, n):
    x, scale = _inputs(dtype)
    np.testing.assert_allclose(_split(x, scale, n).float().numpy(),
                               layers.rms_norm(x, scale, 1e-5).float().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_its_gradients_are_the_whole_rows(dtype, n):
    """dx and dscale of sum(w * norm(x)) through the parts equal those
    through the whole row's differentiable norm (`_RMSNormFn`)."""
    x, scale = _inputs(dtype, seed=1)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32))
    grads = []
    for fn in (lambda a, b: _split(a, b, n), lambda a, b: rk._RMSNormFn.apply(a, b, 1e-5)):
        a, b = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
        (fn(a, b).float() * w).sum().backward()
        grads.append((a.grad.float().numpy(), b.grad.float().numpy()))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, **TOL[dtype])


def test_it_is_the_references_norm():
    import jax.numpy as jnp
    from repro.models import layers as jlayers

    x, scale = _inputs(torch.float32, seed=3)
    want = jlayers.rms_norm(jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()), 1e-5)
    np.testing.assert_allclose(_split(x, scale, 4).numpy(), np.asarray(want),
                               **TOL[torch.float32])


def test_the_entry_with_an_identity_sum_is_the_whole_rows_norm():
    """`ops.split_rms_norm` on one rank (the sum over one rank is the
    identity) is `ops.rms_norm`, kernel entry and plain path alike."""
    x, scale = _inputs(torch.float32, seed=4)
    want = ops.rms_norm(x, scale, 1e-5)
    np.testing.assert_allclose(ops.split_rms_norm(x, scale, 1e-5, 96, lambda s: s).numpy(),
                               want.numpy(), **TOL[torch.float32])
    with ops.use_plain():
        got = ops.split_rms_norm(x, scale, 1e-5, 96, lambda s: s)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL[torch.float32])


def test_the_entries_count_no_launch_on_the_cpu_and_refuse_bad_arguments():
    x, scale = _inputs(torch.float32)
    before = rk.rms_norm.launches
    total = rk.rms_sumsq(x)
    assert total.shape == x.shape[:-1] and total.dtype == torch.float32
    rk.rms_norm_sumsq(x, total, scale, 1e-5, 96)
    assert rk.rms_norm.launches == before
    with pytest.raises(ValueError):
        rk.rms_norm_sumsq(x, total[..., :2], scale, 1e-5, 96)
    with pytest.raises(ValueError):
        rk.rms_norm_sumsq(x, total, scale, 1e-5, 48)           # d_norm below the part
    with pytest.raises(TypeError):
        rk.rms_sumsq(x.half())


def test_work_counts_the_bytes_each_entry_moves():
    x, scale = _inputs(torch.bfloat16, shape=(4, 8, 64))
    assert rk.work_sumsq(x) == (2 * x.numel(), 2 * x.numel() + 4 * 32)
    assert rk.work_norm_sumsq(x, scale) == (2 * x.numel(), (2 * x.numel() + 64) * 2 + 4 * 32)
