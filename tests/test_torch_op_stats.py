"""`launch.op_stats`, the tally of the port's own program: FLOPs, bytes,
peak and kernel scopes counted exactly on small programs by hand; the
collective shim's wire bytes on a fake group, exactly by the ring model,
and on four gloo ranks of a real sharded train step, exactly equal to the
fake group's meta trace of the same cell; its FLOPs against the reference's
compiled HLO (`repro.launch.hlo_stats`); and each kernel's ``work()``
against the bound formulas the chip script used before it (PERF.md §6's
bound column)."""

import gc
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.launch import op_stats as tstats
from repro_torch.launch.dryrun import trace
from repro_torch.launch.mesh import close_fake_group, fake_mesh
from repro_torch.launch.plans import CellPlan
from repro_torch.launch.roofline import H100_SXM
from repro_torch.models import ShapeConfig

import torch_dist_util as du


def _tally(fn, mesh=None):
    with tstats.OpStats(mesh) as t:
        out = fn()
    return t.row(), out


def test_a_matmul_and_an_add_by_hand():
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    row, _ = _tally(lambda: (a @ b) + 1.0)
    # mm: 2*4*8*16 FLOPs; reads a and b, writes (4, 16); the add reads it
    # and writes another (4, 16).
    assert row["flops"] == 2 * 4 * 8 * 16
    assert row["bytes"] == (32 + 128 + 64) * 4 + (64 + 64) * 4
    assert row["scopes"] == {} and row["wire_bytes"] == 0.0


def test_views_and_allocations_move_nothing_and_bmm_counts():
    x = torch.ones(2, 3, 4)
    row, _ = _tally(lambda: (x.transpose(1, 2).reshape(2, 12)[:, 1:], torch.empty(100)))
    # transpose and slicing are views; reshape of a transposed tensor copies.
    assert row["flops"] == 0 and row["bytes"] == 2 * 24 * 4
    y = torch.ones(5, 3, 7, dtype=torch.bfloat16)
    z = torch.ones(5, 7, 2, dtype=torch.bfloat16)
    row, _ = _tally(lambda: torch.bmm(y, z))
    assert row["flops"] == 2 * 5 * 3 * 7 * 2
    assert row["bytes"] == (105 + 70 + 30) * 2


def test_an_update_in_place_moves_its_part_not_the_whole_tensor():
    cache = torch.zeros(4, 100, 8)
    new, at = torch.ones(4, 2, 8), torch.tensor([5, 6])
    row, _ = _tally(lambda: cache.index_copy_(1, at, new))
    assert row["bytes"] == 16 + 2 * 64 * 4                # indices read; values read, written
    rows = torch.arange(4)[:, None]
    row, _ = _tally(lambda: cache.__setitem__((rows, at[None, :]), new))
    assert row["bytes"] == (4 * 8 + 2 * 8) + 2 * 64 * 4        # index_put_: both indices
    assert cache[:, 5:7].eq(1).all()


def test_peak_is_the_high_water_mark_of_what_the_run_allocated():
    before = torch.ones(1024)                       # held before: not counted

    def run():
        a = torch.zeros(256)                        # 1 KB
        b = torch.zeros(512)                        # 2 KB: 3 KB live
        del a
        gc.collect()
        c = torch.zeros(256) + before[:256]         # 1 KB + its 1 KB sum: 4 KB
        del b
        return c
    row, out = _tally(run)
    assert row["peak_bytes"] == 4096
    assert out.shape == (256,)


def test_a_kernel_scope_counts_the_kernels_work_not_the_plain_ops():
    x, s = torch.randn(6, 64), torch.ones(64)
    row, out = _tally(lambda: krms.rms_norm(x, s))
    assert row["scopes"] == {"rms_norm": 1}
    assert (row["flops"], row["bytes"]) == krms.work(x, s) == (4 * 384, (2 * 384 + 64) * 4)
    assert row["flops_kernel_interior"] == row["flops"]
    assert row["bytes_kernel_interior"] == row["bytes"]
    assert row["kernel_bound_s"] == pytest.approx(
        max(row["bytes"] / H100_SXM.hbm_bw, row["flops"] / H100_SXM.peak_flops_fp32))
    torch.testing.assert_close(out, krms.rms_norm_plain(x, s, 1e-5))


def test_a_scope_under_autograd_counts_once_and_its_backward_as_ops():
    x = torch.randn(3, 32, requires_grad=True)
    s = torch.ones(32, requires_grad=True)
    row, _ = _tally(lambda: torch.autograd.grad(krms.rms_norm(x, s).sum(), (x, s)))
    assert row["scopes"] == {"rms_norm": 1, "rms_norm_bwd": 1}
    assert row["flops_kernel_interior"] == krms.work(x, s)[0] + krms.work_bwd(x, s)[0]
    assert row["bytes"] > krms.work(x, s)[1] + krms.work_bwd(x, s)[1]   # and the sum's ops


def test_flash_and_decode_scopes_on_meta_tensors():
    q = torch.empty(2, 128, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 128, 2, 64, dtype=torch.bfloat16, device="meta")
    row, (out, lse) = _tally(lambda: kflash.flash_attention(q, k, k, causal=True))
    assert out.is_meta and lse.shape == (2, 2, 4, 128)
    assert row["scopes"] == {"flash_attention": 1}
    assert row["flops"] == 4 * 2 * (128 * 129 // 2) * 8 * 64
    qd = torch.empty(4, 1, 8, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(4, 300, 2, 64, dtype=torch.bfloat16, device="meta")
    lens = torch.empty(4, dtype=torch.int32, device="meta")
    row, _ = _tally(lambda: kdecode.decode_attention(qd, kv, kv, lens))
    assert row["scopes"] == {"decode_attention": 1}
    assert row["flops"] == 4 * (4 * 300) * 8 * 64    # lengths unknown: every slot full


def test_the_shim_counts_each_collective_by_the_ring_model_and_restores():
    originals = {n: getattr(dist, n) for n in ("all_reduce", "all_gather", "isend", "irecv")}
    c10d_isend = dist.distributed_c10d.isend
    mesh = fake_mesh((2, 4), ("data", "model"))
    try:
        x = torch.zeros(1000)                        # 4000 bytes

        def run():
            dist.all_reduce(x, group=mesh.get_group(1))                  # 4 ranks
            dist.all_gather([torch.empty_like(x) for _ in range(2)], x,
                            group=mesh.get_group(0))                     # 2 ranks
            out = torch.empty(250)
            dist.reduce_scatter_tensor(out, x, group=mesh.get_group(1))
            dist.all_gather_into_tensor(torch.empty(4000), x, group=mesh.get_group(1))
            dist.all_to_all_single(torch.empty_like(x), x, group=mesh.get_group(1))
            dist.broadcast(x, 0)                                         # the world, 8
            ops = [dist.P2POp(dist.isend, x, 1), dist.P2POp(dist.irecv, torch.empty(1000), 1)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            dist.send(x, 1)
            dist.recv(x, 1)
        row, _ = _tally(run, mesh)
    finally:
        close_fake_group()
    model = 2 * 3 / 4 * 4000 + 3 / 4 * 4000 + 3 / 4 * 16000 + 3 / 4 * 4000
    assert row["wire_bytes_by_axis"] == {"model": model, "data": 1 / 2 * 8000,
                                         "world": 7 / 8 * 4000 + 4000 + 4000}
    assert row["coll_all-reduce"] == 6000 and row["coll_collective-permute"] == 8000
    assert row["n_collectives"] == 8                   # receives send nothing
    assert row["wire_bytes"] == sum(row["wire_bytes_by_axis"].values())
    assert {n: getattr(dist, n) for n in originals} == originals
    assert dist.distributed_c10d.isend is c10d_isend


def test_dtensors_functional_collectives_count_too():
    """`full_tensor` gathers through a dispatched functional collective:
    counted from its arguments, on the mesh axis of its group."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = fake_mesh((2, 4), ("data", "model"))
    try:
        d = DTensor.from_local(torch.zeros(10, 3), mesh, (Replicate(), Shard(0)),
                               run_check=False)
        row, whole = _tally(lambda: d.full_tensor(), mesh)
    finally:
        close_fake_group()
    assert whole.shape == (40, 3)
    assert row["wire_bytes_by_axis"] == {"model": 3 / 4 * 480}
    assert row["n_collectives"] == 1 and row["coll_all-gather"] == 360


def _fake_trace(mesh_shape, cfg=None):
    shape = ShapeConfig("train_4k", "train", du.LAUNCH_SEQ, du.LAUNCH_BATCH)
    mesh = fake_mesh(mesh_shape, ("data", "model"))
    try:
        stats, _, _ = trace(cfg or du.granite_cut("torch"), shape, mesh, CellPlan())
    finally:
        close_fake_group()
    return stats


def test_wire_bytes_of_four_gloo_ranks_equal_the_fake_groups_meta_trace(tmp_path):
    """A real sharded train step of the reduced granite on (2, 2) gloo ranks
    and the same cell traced on meta as rank 0 of a fake group of four:
    every rank's collectives move exactly the bytes the trace counts."""
    ranks = du.run_ranks("rank_op_stats", 4, tmp_path / "ranks")
    want = _fake_trace((2, 2))
    keys = [k for k in want if k.startswith("coll_")] + ["wire_bytes", "wire_bytes_by_axis",
                                                         "n_collectives"]
    assert want["wire_bytes_by_axis"].keys() == {"data", "model"}
    for r in ranks:
        assert math.isfinite(r["loss"])
        assert {k: r[k] for k in keys} == {k: want[k] for k in keys}


def test_flops_against_the_references_hlo(tmp_path):
    """The reduced granite's train step on a (4, 1) mesh: the reference's
    compiled HLO counted by `hlo_stats` against the port's meta trace.
    They part on attention alone.  The reference trains a sequence this
    short through `gqa_reference` (every (query, key) pair, forward and
    remat forward, and autodiff's 4 products in the backward: 8 F a layer,
    F = 2 B Hq S^2 Dh, one full product); the port runs the flash forward
    over the causal half (a call's work K = F (S + 1) / S) twice and the
    flash backward, whose kernels count five products over the same pairs
    (`work_bwd`, 2.5 K).  So the port counts L (4.5 K - 8 F) = L F (4.5
    (S + 1) / S - 8) less: about 13.9 % of the HLO's FLOPs here.  The rest
    agrees within 0.14 % (measured; allowed 0.2 %)."""
    hlo = du.run_jax("jax_hlo_stats", tmp_path / "hlo", mesh_shape=[4, 1])
    port = _fake_trace((4, 1))
    cfg = du.granite_cut("torch")
    B, S = du.LAUNCH_BATCH // 4, du.LAUNCH_SEQ
    F = 2 * B * cfg.n_heads * S * S * cfg.d_head
    attention_gap = cfg.n_layers * F * (4.5 * (S + 1) / S - 8)
    gap = port["flops"] - hlo["flops"]
    assert -0.145 < attention_gap / hlo["flops"] < -0.135
    assert abs(gap - attention_gap) / hlo["flops"] < 0.002
    assert port["scopes"] == {"flash_attention": 2 * cfg.n_layers,
                              "flash_attention_bwd": cfg.n_layers,
                              "rms_norm": 4 * cfg.n_layers + 1,
                              "rms_norm_bwd": 2 * cfg.n_layers + 1}


# ------------------------------------------- work() against the old bounds --
def _m(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


NORM_SHAPES = [(8, 1, 2048), (16384, 2048), (2, 4096, 7168), (8, 1, 6144), (2, 4096, 6144),
               (8, 1, 4096), (2, 4096, 4096)]
DECODE_SHAPES = [(8, 4096, 32, 8, 64), (8, 4096, 32, 32, 112), (8, 4096, 48, 8, 128),
                 (8, 4096, 64, 8, 128), (8, 4096, 64, 8, 112), (8, 4096, 12, 2, 128),
                 (8, 4096, 16, 16, 64)]
SERVED_LENS = [17, 33, 48, 64, 70, 81, 90, 96]
FLASH_SHAPES = [(2, 4096, 4096, 32, 8, 64, True), (2, 4096, 4096, 32, 32, 112, True),
                (2, 4096, 4096, 48, 8, 128, True), (2, 4096, 4096, 12, 2, 128, True),
                (2, 4096, 2048, 16, 16, 64, False), (2, 2048, 2048, 16, 16, 64, False)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_work_bwd_is_five_products(shape):
    """The gradient's work: 2.5 times the forward's FLOPs over the same
    pairs; q, k, v, out, dout read and dq, dk, dv written once, in bf16,
    the fp32 lse read and delta written once a row."""
    B, Sq, Sk, Hq, Hkv, D, causal = shape
    q, kv = _m((B, Sq, Hq, D)), _m((B, Sk, Hkv, D))
    flops, nbytes = kflash.work_bwd(q, kv, kv, causal)
    assert 2 * flops == 5 * kflash.work(q, kv, kv, causal)[0]
    assert nbytes == (4 * q.numel() + 4 * kv.numel()) * 2 + 2 * B * Hq * Sq * 4


@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_rms_norm_work_is_the_old_bound(shape):
    x, s = _m(shape), _m(shape[-1:])
    assert krms.work(x, s) == (4 * x.numel(), 2 * x.numel() * 2 + s.numel() * 2)


def test_rms_norm_bound_of_perf_table():
    flops, nbytes = krms.work(_m((8, 1, 2048)), _m((2048,)))
    assert round(max(nbytes / 3.35e12, flops / 67e12) * 1e3, 7) == 0.0000208


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_work_is_the_old_bound(shape):
    B, Sk, Hq, Hkv, D = shape
    q, kv = _m((B, 1, Hq, D)), _m((B, Sk, Hkv, D))
    for lens in (torch.full((B,), Sk, dtype=torch.int32), torch.tensor(SERVED_LENS)):
        valid = int(lens.clamp(0, Sk).sum())
        old = (4 * valid * Hq * D, 2 * valid * Hkv * D * 2 + 2 * q.numel() * 2 + lens.numel() * 4)
        assert kdecode.work(q, kv, kv, lens) == old
    assert kdecode.work(q, kv, kv, Sk) == kdecode.work(q, kv, kv, torch.full((B,), Sk))


def test_decode_bound_of_perf_table():
    _, nbytes = kdecode.work(_m((8, 1, 32, 64)), _m((8, 4096, 8, 64)), None,
                             torch.full((8,), 4096))
    assert round(nbytes / 3.35e12 * 1e3, 6) == 0.020052


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_work_is_the_old_bound(shape):
    B, Sq, Sk, Hq, Hkv, D, causal = shape
    q, k = _m((B, Sq, Hq, D)), _m((B, Sk, Hkv, D))
    pairs = B * Sq * (Sq + 1) // 2 if causal else B * Sq * Sk
    old = (4 * pairs * Hq * D, (2 * q.numel() + 2 * k.numel()) * 2 + B * Hq * Sq * 4)
    assert kflash.work(q, k, k, causal) == old


def test_flash_bound_of_perf_table_and_a_longer_query_than_keys():
    k = _m((2, 4096, 8, 64))
    flops, _ = kflash.work(_m((2, 4096, 32, 64)), k, k, True)
    assert round(flops / 989e12 * 1e3, 6) == 0.139002
    q, k = _m((1, 5, 2, 8)), _m((1, 3, 2, 8))        # queries 3, 4 see all 3 keys
    assert kflash.work(q, k, k, True)[0] == 4 * (1 + 2 + 3 + 3 + 3) * 2 * 8


def test_ssm_work_is_the_old_bound():
    B, S, H, P, N, L = 2, 4096, 112, 64, 64, 64
    x, bm = _m((B, S, H, P)), _m((B, S, N))
    dt, h = _m((B, S, H), torch.float32), _m((H,), torch.float32)
    old_flops = 2 * (L * L * N + L * L * P + 2 * L * P * N) * B * H * (S // L)
    old_bytes = 2 * (B * S * H * P) * 2 + 2 * (B * S * N) * 2 + B * S * H * 4 + 2 * H * 4 \
        + B * H * P * N * 4
    assert kssm.work(x, bm, bm, dt, h, h, L) == (old_flops, old_bytes)
    assert round(old_bytes / 3.35e12 * 1e3, 6) == 0.072931
