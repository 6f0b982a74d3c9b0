"""The benchmark's work counts: against a hand count at one small shape
each, against the port's own counts where both count the same thing, and
a share at a kernel's least time reading 100 %."""

import pytest
import torch

from conftest import TINY_TRAFFIC, WIDE_HYBRID, tiny
from harness import peaks
from harness.roofline import share
from work import kernels as K
from work import model


def test_causal_pairs_by_hand():
    assert K.causal_pairs(4, 4) == 10            # 1 + 2 + 3 + 4
    assert K.causal_pairs(2, 5) == 3             # queries past no key: 1 + 2
    assert K.causal_pairs(5, 3) == 6 + 2 * 3     # the last two see all three


def test_flash_by_hand():
    # b 1, 4 queries and keys, 2 query heads on 1 kv head, d 8, causal: 10 pairs
    ops, nbytes, peak = K.flash_fwd(1, 4, 4, 2, 1, 8)
    assert ops == 2 * 2 * 10 * 2 * 8             # two products, a multiply-add each
    assert nbytes == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2 + 2 * 4 * 4
    assert peak == peaks.BF16_FLOPS
    ops, nbytes, _ = K.flash_bwd(1, 4, 4, 2, 1, 8)
    assert ops == 5 * 2 * 10 * 2 * 8             # the rule's five products
    assert nbytes == (4 * 4 * 2 * 8 + 4 * 4 * 1 * 8) * 2 + 2 * 4 * 4


def test_rms_norm_and_scan_by_hand():
    assert K.rms_norm_fwd(3, 8) == (4 * 24, (2 * 24 + 8) * 2, peaks.FP32_FLOPS)
    assert K.rms_norm_bwd(3, 8) == (10 * 24, (3 * 24 + 2 * 8) * 2, peaks.FP32_FLOPS)
    # b 1, 2 tokens, 3 heads, P 4, N 5
    ops, nbytes, _ = K.ssm_fwd(1, 2, 3, 4, 5)
    assert ops == 2 * 3 * (5 * 4 * 5 + 3 * 4)
    assert nbytes == (2 * 2 * 3 * 4 + 2 * 2 * 5) * 2 + 2 * 3 * 4 + 2 * 3 * 4
    ops, nbytes, _ = K.ssm_bwd(1, 2, 3, 4, 5)
    assert ops == 2 * 3 * (14 * 4 * 5 + 8 * 4)
    assert nbytes == (3 * 2 * 3 * 4 + 4 * 2 * 5) * 2 + 2 * 2 * 3 * 4 + 4 * 3 * 4


@pytest.mark.parametrize("shape", [(2, 64, 64, 4, 2, 16), (1, 48, 48, 8, 8, 32)])
def test_flash_forward_agrees_with_the_ports_count(shape):
    from repro_torch.kernels import flash_attention as port
    b, sq, sk, hq, hkv, d = shape
    q = torch.empty(b, sq, hq, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, sk, hkv, d, dtype=torch.bfloat16, device="meta")
    assert port.work(q, k, k, True) == K.flash_fwd(*shape)[:2]


@pytest.mark.parametrize("rows,d", [(8192, 2048), (24, 7168)])
def test_rms_norm_agrees_with_the_ports_count(rows, d):
    from repro_torch.kernels import rmsnorm as port
    x = torch.empty(rows, d, dtype=torch.bfloat16, device="meta")
    s = torch.empty(d, dtype=torch.bfloat16, device="meta")
    assert port.work(x, s) == K.rms_norm_fwd(rows, d)[:2]
    assert port.work_bwd(x, s)[1] == K.rms_norm_bwd(rows, d)[1]


def test_model_flops_by_hand():
    cfg = tiny("tiny-dense")          # 2 layers, d 64, 4 heads of 16 (2 kv), ff 128, V 256
    b, s = 2, 8
    per_layer = 2 * 64 * 64 + 2 * 64 * 32 + 3 * 64 * 128
    matmul = 2 * (2 * per_layer + 64 * 256) * b * s
    attn = 2 * 4 * b * K.causal_pairs(s, s) * 4 * 16
    assert model.train_flops(cfg, b, s) == 3 * (matmul + attn)


def test_a_step_applies_each_kernel_as_the_model_does():
    work = model.kernel_work(tiny("tiny-hybrid"), 2, 64)     # 5 layers, shared every 2
    assert len(work["flash_fwd"]) == len(work["flash_bwd"]) == 3          # before 0, 2, 4
    assert len(work["ssm_fwd"]) == len(work["ssm_bwd"]) == 5
    assert len(work["rms_norm"]) == 2 * (2 * 3 + 1 + 2 * 5)              # forward and gradient
    dense = model.kernel_work(tiny("tiny-dense"), 2, 64)
    assert "ssm_fwd" not in dense and len(dense["rms_norm"]) == 2 * (2 * 2 + 1)


@pytest.mark.parametrize("computation,kernels", [
    ("flash_fwd", ("flash_fwd_wgmma_kernel",)), ("flash_bwd", ("flash_bwd_dq_wgmma_kernel",)),
    ("rms_norm", ("rms_norm_kernel",)), ("ssm_fwd", ("ssm_scan_wgmma_kernel",)),
    ("ssm_bwd", ("ssm_bwd_chunk_wgmma_kernel",))])
def test_a_share_at_the_least_time_reads_100(computation, kernels):
    cfg = WIDE_HYBRID
    steps, b, s = 3, 2, 4096
    least = model.step_least_time(cfg, b, s, computation) * steps
    name = f"void (anonymous namespace)::{kernels[0]}<64>(CUtensorMap_st, int)"
    run = {"cfg": cfg, "traffic": dict(TINY_TRAFFIC, batch=b, seq=s),
           "trace": {"ops": {name: least, "ampere_sgemm": 1.0}, "steps": steps}}
    assert share(run, computation, kernels) == pytest.approx(100.0)
    run["trace"]["ops"] = {name: 2 * least}
    assert share(run, computation, kernels) == pytest.approx(50.0)
    run["trace"]["ops"] = {"other_kernel": least}
    assert share(run, computation, kernels) is None       # no launch: no reading, never 0


def test_kernel_names_are_matched_whole():
    from harness.trace import seconds_of
    ops = {"void flash_fwd_wgmma_kernel<64>(a)": 1.0, "flash_fwd_kernel(b)": 2.0,
           "rms_norm_bwd_kernel<float, 4>": 4.0}
    assert seconds_of(ops, ("flash_fwd_kernel",)) == (2.0, 1)
    assert seconds_of(ops, ("rms_norm_kernel",)) == (0.0, 0)
