"""rms_norm's gradient (`kernels.rmsnorm.rms_norm_bwd`, the backward of
`_RMSNormFn`) held on the CPU, where the wrapper runs its plain version,
`rms_norm_backward_plain`: against `jax.vjp` of the JAX package's
`rms_norm` in fp32 and bf16 at `test_rms_norm_gradient_matches_jax`'s
tolerances (fp32 1e-5, bf16 5e-2), at a small shape, the decode step's
(8, 1, 2048), ragged rows and one 7168-wide row; with an expanded and a
non-contiguous output gradient; its scope on ``meta``; and what the card's
route is built from (the launchers' signatures, the kernels' names that the
dry run matches in a profile)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import _build
from repro_torch.kernels import rmsnorm as rk
from repro_torch.launch import dryrun
from repro_torch.launch.op_stats import OpStats

SHAPES = [(3, 7, 64), (8, 1, 2048), (5, 136), (1, 7168)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
EPS = 1e-5


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, dy


def _jax_grads(x, scale, dy, jt):
    """dx and dscale of the JAX package's rms_norm by `jax.vjp`, in fp32."""
    _, vjp = jax.vjp(lambda a, b: jlayers.rms_norm(a, b, EPS), jnp.asarray(x, jt),
                     jnp.asarray(scale, jt))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dy, jt))]


def _torch(*arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _check(got, want, dt, dtype):
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), w, **TOL[dt])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_the_plain_gradient_is_the_references_vjp(shape, dt):
    tt, jt = DTYPES[dt]
    x, scale, dy = _inputs(shape)
    got = rk.rms_norm_backward_plain(*_torch(x, scale, dy, dtype=tt), EPS)
    _check(got, _jax_grads(x, scale, dy, jt), dt, tt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_the_autograd_function_is_the_references_vjp(shape, dt):
    tt, jt = DTYPES[dt]
    x, scale, dy = _inputs(shape, seed=1)
    tx, ts, tdy = _torch(x, scale, dy, dtype=tt)
    tx.requires_grad_(True)
    ts.requires_grad_(True)
    out = rk.rms_norm(tx, ts, EPS)
    assert type(out.grad_fn).__name__.startswith("_RMSNormFn")
    _check(torch.autograd.grad(out, (tx, ts), tdy), _jax_grads(x, scale, dy, jt), dt, tt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("layout", ["expanded", "transposed"])
def test_a_strided_output_gradient_gives_the_contiguous_ones(layout, dt):
    """autograd may hand the backward an expanded gradient (stride 0, as a
    sum's is) or a non-contiguous one: the same gradients as its contiguous
    copy, bit for bit."""
    tt, _ = DTYPES[dt]
    x, scale, dy = _inputs((4, 6, 32), seed=2)
    tx, ts, tdy = _torch(x, scale, dy, dtype=tt)
    tx.requires_grad_(True)
    ts.requires_grad_(True)
    if layout == "expanded":
        g = torch.full((), 0.75, dtype=tt).expand(tx.shape)
    else:
        g = tdy.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    assert not g.is_contiguous()
    got = torch.autograd.grad(rk.rms_norm(tx, ts, EPS), (tx, ts), g)
    want = rk.rms_norm_backward_plain(tx.detach(), ts.detach(), g.contiguous(), EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_a_cpu_gradient_counts_no_launch():
    x, scale, dy = _torch(*_inputs((5, 136), seed=3), dtype=torch.bfloat16)
    before = rk.rms_norm_bwd.launches
    rk.rms_norm_bwd(x, scale, dy, EPS)
    x.requires_grad_(True)
    rk.rms_norm(x, scale, EPS).sum().backward()
    assert x.grad is not None and rk.rms_norm_bwd.launches == before


def test_no_rows_give_zero_dscale():
    x = torch.zeros(0, 64)
    dx, dscale = rk.rms_norm_bwd(x, torch.ones(64), x, EPS)
    assert dx.shape == (0, 64) and torch.equal(dscale, torch.zeros(64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_work_counts_one_pass(dtype):
    """x and dy read and dx written once, scale read and dscale written
    once, in x's type; no FLOPs, as the tally counted none for the plain
    version's elementwise ops."""
    x = torch.empty(2, 4096, 7168, dtype=dtype, device="meta")
    s = torch.empty(7168, dtype=dtype, device="meta")
    n, size = x.numel(), x.element_size()
    assert rk.work_bwd(x, s) == (0, (3 * n + 2 * 7168) * size)


def test_a_meta_gradient_is_one_scope_with_its_work():
    """On ``meta`` the backward takes the plain route inside one
    `rms_norm_bwd` scope, which the tally counts by `work_bwd` and not by
    the plain version's ops."""
    x = torch.empty(2, 64, 256, dtype=torch.bfloat16, device="meta")
    s = torch.empty(256, dtype=torch.bfloat16, device="meta")
    with OpStats() as tally:
        dx, dscale = rk.rms_norm_bwd(x, s, x, EPS)
    row = tally.row()
    assert dx.is_meta and dscale.shape == (256,)
    assert row["scopes"] == {"rms_norm_bwd": 1}
    assert (row["flops"], row["bytes"]) == rk.work_bwd(x, s)
    assert row["flops_kernel_interior"] == row["flops"]


def test_the_launchers_signatures():
    sig = _build.SIGNATURES
    # x, dy, scale, dx, partial, rows, d, eps, blocks, is_bf16, stream
    assert len(sig["repro_rms_norm_bwd"]) == 11
    assert sig["repro_rms_norm_bwd"][7] is _build.ctypes.c_float
    # partial, dscale, blocks, d, is_bf16, stream
    assert len(sig["repro_rms_dscale_sum"]) == 6
    assert sig["repro_empty"] == [_build.ctypes.c_void_p]
    text = (_build.CSRC / "rmsnorm.cu").read_text()
    for name in ("repro_rms_norm_bwd", "repro_rms_dscale_sum", "repro_empty"):
        assert f'extern "C" int {name}(' in text


def test_the_kernel_names_hold_no_other_wrappers():
    """The dry run counts a profile's kernels by substring: no kernel name
    of one wrapper may be found inside another wrapper's names (the new
    gradient's names do not hold `rms_norm_kernel`, and no older name holds
    theirs), and each name is a kernel of the sources."""
    names = dryrun._KERNEL_NAMES
    assert names["rms_norm_bwd"] == ("rms_norm_bwd_kernel", "rms_dscale_sum_kernel")
    for wrapper, kernels in names.items():
        for other, theirs in names.items():
            if other != wrapper:
                assert not any(k in t for k in kernels for t in theirs), (wrapper, other)
    text = "".join(p.read_text() for p in _build.sources())
    for kernels in names.values():
        for k in kernels:
            assert re.search(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+" + k + r"\(",
                             text), k
    assert dryrun.LAUNCHES_A_SCOPE == {"rms_norm_bwd": 2, "flash_attention_bwd": 2,
                                       "ssm_scan_bwd": 3}
    assert set(dryrun._wrapper_launches()) == set(names)


def test_the_empty_kernel_refuses_the_cpu():
    with pytest.raises(ValueError):
        rk.empty_kernel("cpu")


def test_the_launch_path_takes_private_entry_points_torch_still_declares():
    """`_device_and_stream` calls two private entry points of torch's CUDA
    module.  A CPU build of torch lacks them, but its stubs declare them:
    a torch that renames or reshapes one fails here, not first on the
    card."""
    import inspect
    from pathlib import Path

    stubs = (Path(torch.__file__).parent / "_C" / "__init__.pyi").read_text()
    assert "def _cuda_getCurrentRawStream(device: _int) -> _int: ..." in stubs
    assert "def _cuda_getDevice() -> _int: ..." in stubs
    called = set(re.findall(r"torch\._C\.(\w+)\(", inspect.getsource(rk)))
    assert called == {"_cuda_getCurrentRawStream", "_cuda_getDevice"}
