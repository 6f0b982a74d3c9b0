#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a), holds
each against its plain PyTorch version on the card, then drives the port's
paths with six models at full width (bf16, random weights from seed 0):
it serves requests through `repro_torch.serve.ServeEngine` and trains for a
few steps through `repro_torch.train.Trainer` (2 x 4096 tokens a step,
block remat, the config's optimizer), with granite-3-2b (dense GQA, all 40
layers; phases ``serve``, ``train``), zamba2-7b (Mamba2 hybrid with a
shared attention block; all 81 layers served, 39 trained: ``serve_zamba2``,
``train_zamba2``), dbrx-132b (MoE, 16 experts top-4; 8 layers served, 3
trained: ``serve_dbrx``, ``train_dbrx``) and xlstm-1.3b (mLSTM and sLSTM
blocks at [7:1]; all 48 blocks served, one period of 8 trained:
``serve_xlstm``, ``train_xlstm``, after ``slstm_layer`` times one sLSTM
layer's token loop at the training shape), seamless-m4t-large-v2
(encoder-decoder, 24 + 24 layers, stub frame embeddings: ``serve_seamless``
prefills 8 sequences of 2048 frames and 16 prompt tokens and decodes 48
greedy steps, ``train_seamless`` trains on 2 x 4096 tokens over 2 x 2048
frames) and qwen2-vl-2b (VLM with M-RoPE, all 28 layers: ``serve_qwen2vl``
serves text requests through the engine, ``train_qwen2vl`` trains on 256
stub patch embeddings on a 16 x 16 grid and 3840 text tokens a sequence).
``sharded_train`` trains granite-3-2b (all 40 layers) again through
`Trainer(mesh=, strategy=)` on a one-rank NCCL mesh of shape (1, 1), its
state DTensors placed by `parallel.sharding.state_specs`; its first 3
losses and gradient norms must equal ``train``'s bit for bit.
``relocate_train`` moves a
granite training job through a checkpoint: stopped after a save, resumed by
a fresh `Trainer`, it must restore every leaf bit for bit and repeat the
stopped job's next loss bit for bit; the same checkpoint is then resumed a
second time through `runtime.elastic.ElasticSupervisor` onto a (1, 1)
mesh, bit for bit again, and a third time by the move that the port's LP
chooses on the reference demo's four pods (``live_move``: Steps 5 and 7
through `core.cluster.FleetScheduler`, the move executed by
`fleet.elastic_bridge.LiveElasticBackend`), bit for bit, its measured
phases printed beside the fleet simulator's.  ``adapt`` runs the paper's adaptation flow
for granite-3-2b's train cell on the 256-H100 production mesh (analysis,
GA plan search, sizing and the meta dry run of the chosen plan, in a
host process started with the run) and its verification step on the
card (`repro_torch.launch.dryrun.verify_cell`: granite's train and
decode steps measured beside the roofline of the same cut traced on
meta; the card's FLOPs must equal the trace's, and the profiler's
kernel launches the tally's scopes).  It checks that each path really went
through its kernels (launch counts equal to their per-step formulas), that
the kernels' path agrees with the plain path for serving and for training,
and that a live slot (KV caches, and a recurrent stack's conv windows and
SSM or xLSTM states) moved to another engine goes on decoding
bit-identically, for cuts of the models (seamless: prefill and decode
steps, no migration, as the reference's engine cannot hold an
encoder-decoder slot; qwen2-vl: a vision prefill, then decode steps).  Prints one JSON object a line, and each phase's
seconds as it ends; the last line is ``{"ok": true, "device": {...}}``.
Exits non-zero, without that line, when there is no CUDA device or any
phase fails: nothing is retried on the CPU.

``--only build,kernels,serve_zamba2`` runs some phases alone (then no final
line); ``--verbose-build`` prints the compiler's messages.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import pty
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

PHASES = ("build", "kernels", "adapt", "serve", "train", "sharded_train", "serve_zamba2",
          "train_zamba2", "serve_dbrx", "train_dbrx", "serve_xlstm", "slstm_layer", "train_xlstm",
          "relocate_train", "timing",
          "path_vs_plain", "train_vs_plain", "migrate",
          "path_vs_plain_zamba2", "train_vs_fp32_zamba2", "train_vs_plain_zamba2",
          "migrate_zamba2", "path_vs_plain_dbrx", "migrate_dbrx",
          "path_vs_plain_xlstm", "train_vs_fp32_xlstm", "train_vs_plain_xlstm", "migrate_xlstm",
          "serve_seamless", "train_seamless", "serve_qwen2vl", "train_qwen2vl",
          "path_vs_plain_seamless", "train_vs_fp32_seamless", "train_vs_plain_seamless",
          "path_vs_plain_qwen2vl", "train_vs_fp32_qwen2vl", "train_vs_plain_qwen2vl",
          "migrate_qwen2vl")


TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# flash_attention's output and lse.  Both bf16 outputs are one rounding of
# nearly equal fp32 values, so a right kernel is within one bf16 step of
# the plain output (2^-7 of it at most); 5e-3 is a fifth of a typical late
# row's |out| at the training shape.  The lse is fp32 in both.
FLASH_TOL = {"float32": {"out": TOL["float32"], "lse": TOL["float32"]},
             "bfloat16": {"out": dict(atol=5e-3, rtol=1e-2), "lse": dict(atol=1e-3, rtol=0.0)}}

# ssm_scan's y.  fp32: 2e-5 of the output's largest magnitude plus 2e-5 of
# each element.  An elementwise 2e-5 cannot hold between two fp32 scans
# that add in other orders: each exp(cum_i - cum_j) cancels two running
# sums of up to ~50, so an output small beside its terms moves by more than
# 2e-5 of itself (the reference's own fp32 scan is 1.5 times that
# allowance from a float64 evaluation; tests/test_torch_ssm.py).  bf16: as
# flash_attention's bf16 output, one rounding of nearly equal fp32 values.
# The final state, fp32 in both, at 1e-3 (tests/test_kernels.py).
SSM_STATE_TOL = dict(atol=1e-3, rtol=1e-3)


def ssm_tol(dtype_name, want):
    if dtype_name == "float32":
        return dict(atol=2e-5 * max(1.0, float(want.abs().max())), rtol=2e-5)
    return FLASH_TOL["bfloat16"]["out"]


SERVE_SLOTS, SERVE_MAX_LEN = 8, 4096
# The train phases: sequences x tokens a step, loss chunk, steps.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LOSS_CHUNK, TRAIN_STEPS = 2, 4096, 1024, 6
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)    # fp32 gradients, summed in another order
# zamba2-7b: requests served at 81 layers; depth trained (6 periods of 6 and
# the 3 tail layers: weights, gradients and AdamW moments of 81 layers would
# fill the card); steps; depth of the kernel-vs-plain and migration cuts (1
# period and the 3 tail layers, so that tail and tail_shared are on them).
ZAMBA_REQUESTS, ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_STEPS, ZAMBA_CUT_LAYERS = 16, 39, 3, 9
# dbrx-132b (6.5 GB of bf16 weights a layer): depth served (8 layers beside
# 8 slots' caches), requests; depth trained (3: weights, the layers'
# gradients and their stack at the end of the backward, 6.3 GB a layer
# each, fill the card at 4), steps; depth of the kernel-vs-plain and
# migration cut.
DBRX_SERVE_LAYERS, DBRX_REQUESTS, DBRX_TRAIN_LAYERS, DBRX_TRAIN_STEPS, DBRX_CUT_LAYERS = \
    8, 16, 3, 3, 2
# xlstm-1.3b: requests served at 48 blocks; blocks trained (one period of 7
# mLSTM and 1 sLSTM: each sLSTM layer's token loop costs about 7 s of a
# step at 2 x 4096 tokens, forward 1.2 s and remat's forward and backward
# 5.8 s (`slstm_layer`, NVIDIA H100 80GB HBM3), so a 48-block step is about
# 50 s, and the phase's 3 steps, a host-timed and a profiled one would take
# some 270 s of the run's 600), and steps (2: an 8-block step takes 12-16 s
# on the host's sLSTM loop, and the third step paid for relocate_train's
# live move); the kernel-vs-plain and migration cut (one stacked period,
# and one mLSTM tail block).
XLSTM_REQUESTS, XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_STEPS, XLSTM_CUT_LAYERS = 16, 8, 2, 9
# relocate_train: granite-3-2b layers of the moved job, its steps, the
# checkpoint interval, and the step after which it is stopped.  The state
# is 0.61 GB a layer (bf16 weights, fp32 AdamW m and v) and 1.0 GB for the
# embedding; the H100 machine has no zstandard, and zlib compresses each
# shard on one of its 8 cores, so a save takes about as long as its largest
# shard (2 layers: 6 shards, the largest 537 MB, 51-53 s a save, two saves
# a run; NVIDIA H100 80GB HBM3).  At 5 layers (4.05 GB, 11 shards, the
# largest 545 MB) the phase took 167-190 s, and with the encoder-decoder's
# and the VLM's phases the whole run 652 s, past its 600; 2 layers (2.22
# GB) take the phase back to about 125 s.
RELOCATE_LAYERS, RELOCATE_STEPS, RELOCATE_EVERY, RELOCATE_STOP = 2, 6, 3, 4
# seamless-m4t-large-v2 (24 encoder + 24 decoder layers): frames of stub
# embeddings a sequence served (2048 take the encoder through the flash
# kernel), prompt tokens, greedy decode steps, train steps and the frames a
# training sequence takes.  Its cuts: 4 + 4 layers; `train_vs_plain_seamless`
# takes 3072 frames against 2048 decoder tokens, so that the cross-attention
# also runs with Sq < Sk and the encoder at another length than the decoder.
SEAMLESS_FRAMES, SEAMLESS_PROMPT, SEAMLESS_DECODE_STEPS, SEAMLESS_TRAIN_STEPS = 2048, 16, 48, 3
SEAMLESS_TRAIN_FRAMES, SEAMLESS_CUT_FRAMES = 2048, 3072
# qwen2-vl-2b (28 layers): requests served, train steps, stub patches a
# sequence (a 16 x 16 grid) and the loss chunk (1280 divides the 3840-token
# text suffix; 1024 does not, and without a chunk that divides it the
# reference's rule takes one (2, 3840, 151936) fp32 logits tensor, 4.7 GB);
# the prompt of the cut's vision prefill.
QWEN_REQUESTS, QWEN_TRAIN_STEPS, QWEN_PATCHES, QWEN_LOSS_CHUNK, QWEN_CUT_PROMPT = \
    16, 3, 256, 1280, 32
CUT_LAYERS = 4                 # granite's, seamless's (encoder and decoder) and qwen2-vl's cuts
# The fleet simulator's host phase of a move (repro.fleet.elastic_bridge.
# SimulatedElasticBackend): bytes at 16 Gbit/s plus 0.01 s a shard file.
SIM_HOST_GBPS, SIM_PER_SHARD_S = 16.0, 0.01


def emit(**obj):
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def require(cond, what):
    if not cond:
        raise Failed(what)


# --------------------------------------------------------------- helpers --
def errors(torch, got, want, dtype_name, tol=None):
    """(max abs error, max of error over its allowance) in fp32; the
    allowance is ``tol``, by default `TOL` of the dtype."""
    tol = tol or TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    allowed = tol["atol"] + tol["rtol"] * w.abs()
    return float(err.max()), float((err / allowed).max())


def time_ms(torch, fn, iters=50, warmup=5):
    """Mean milliseconds of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


class DeviceTimer:
    """Device time of a call, apart from the host's time to launch it.

    A run of large matrix products is queued first, so that the card is
    busy while the host queues ``iters`` calls between two events; the
    card then runs them back to back and the events' distance is their
    device time alone.  Valid only if the host was done queueing before the
    card got to the first event, which is checked rather than assumed: on a
    miss the run is repeated with fewer calls (the launch queue holds about
    a thousand, and a plain version is several launches a call) behind a
    longer run of products."""

    def __init__(self, torch, device):
        self.torch = torch
        self.a = torch.randn(8192, 8192, device=device, dtype=torch.bfloat16)
        self.matmul_ms = time_ms(torch, lambda: self.a @ self.a, iters=5, warmup=2)

    def __call__(self, fn, iters=50):
        """(device ms a call, host-inclusive ms a call in a tight loop)."""
        torch = self.torch
        call_ms = time_ms(torch, fn, iters=iters)
        for attempt in range(6):
            busy_ms = (2.0 + attempt) * call_ms * iters + 10.0
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            for _ in range(int(busy_ms / self.matmul_ms) + 1):
                self.a @ self.a
            start.record()
            for _ in range(iters):
                fn()
            stop.record()
            queued_in_time = not start.query()   # the card has not reached it yet
            torch.cuda.synchronize()
            if queued_in_time:
                return start.elapsed_time(stop) / iters, call_ms
            iters = max(5, iters // 2)
        raise Failed("DeviceTimer: the host never got ahead of the card")


def profile_device_time(torch, fn, iters):
    """(device ms a call, the ten kernels that take most of it, kernel
    launches a call) from `torch.profiler` tracing the card alone; (None,
    [], 0) if the trace shows no device time.  The trace's events are read
    as recorded, not through ``key_averages()``, whose processing takes
    minutes for the million launches of a step with an sLSTM token loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    rows = sorted(((us, n, key) for key, (us, n) in by_name.items() if us > 0), reverse=True)
    if not rows:
        return None, [], 0
    top = [dict(kernel=key[:72], ms_a_call=us / iters / 1e3, launches_a_call=n / iters)
           for us, n, key in rows[:10]]
    return (sum(us for us, _, _ in rows) / iters / 1e3, top,
            sum(n for _, n, _ in rows) / iters)


def bound(nbytes, flops, dtype_name):
    """The least ms of a call on the card (`launch.roofline.H100_SXM`, the
    datasheet's memory rate and the peak of ``dtype_name``'s arithmetic),
    and which of the two sets it."""
    from repro_torch.launch.roofline import H100_SXM
    by_bytes = nbytes / H100_SXM.hbm_bw * 1e3
    by_ops = flops / H100_SXM.peak(dtype_name) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def rand(torch, shape, dtype, seed, device):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)


def kernel_wrappers():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rms_norm
    from repro_torch.kernels.ssm_scan import ssm_scan
    return {"rms_norm": rms_norm, "decode_attention": decode_attention,
            "flash_attention": flash_attention, "ssm_scan": ssm_scan}


def zero_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def stack_period(kinds, every):
    """The period the reference's `stack_layout` groups a layer pattern
    by: the pattern's minimal period, or ``shared_attn_every`` where that
    is larger (granite, dbrx: 1; zamba2: 6; xlstm: 8)."""
    period = next(p for p in range(1, len(kinds) + 1)
                  if all(kinds[i] == kinds[i % p] for i in range(len(kinds))))
    return max(period, every)


def launches_per_step(cfg, train, prefill=False):
    """Launches of each kernel in one decode step (``train`` False), one
    train step, or (``prefill``) an encoder-decoder's prefill of ``cfg``,
    counted from the config alone and not from the port's layout code,
    whose placement of the shared block and of the periods the count
    checks.  Every layer (attention, Mamba2, mLSTM or sLSTM: ``norm1`` and
    a second norm) and every application of zamba2's shared block has two
    norms, plus the final norm; an attention layer or shared block runs one
    attention, a Mamba2 layer one scan (decode steps take the one-step
    recurrence, no kernel).  The shared block runs before every layer whose
    index is a multiple of ``shared_attn_every``.  An encoder-decoder's
    decoder layers have a third norm (``norm_cross``) and, in training and
    prefill, a second attention over the encoder's memory; its encoder
    runs in training and prefill, two norms and one attention a layer and
    its final norm.  Decode steps read the cross cache through
    `gqa_reference` (no kernel); in prefill the decoder's attention at the
    prompt's length is `gqa_reference` (below CHUNKED_ATTN_THRESHOLD) and
    the encoder's, at the phases' 2048 frames and more, the flash kernel,
    as is every attention of a train step at the phases' lengths.  A train
    step runs the forward, then recomputes under block remat the layers of
    whole periods (`stack_period`) with their shared blocks and every
    encoder layer, but not the tail layers, the shared blocks before them,
    nor the final norms."""
    kinds = cfg.layer_pattern()
    every = cfg.shared_attn_every            # an MoE layer attends as a dense one does
    shared = [i for i in range(len(kinds)) if every and i % every == 0]
    cross = int(cfg.n_encoder_layers > 0)
    encoder = cfg.n_encoder_layers           # its layers' attentions; twice that in norms

    def count(kinds, shared, final_norm):
        attn = sum(k in ("attn", "moe") for k in kinds)
        return {"rms_norm": 2 * (len(kinds) + len(shared)) + cross * attn + final_norm,
                "attn": attn + len(shared), "cross": cross * attn,
                "ssm_scan": sum(k == "mamba2" for k in kinds)}

    fwd = count(kinds, shared, 1)
    if not train and not prefill:
        return {"rms_norm": fwd["rms_norm"], "decode_attention": fwd["attn"],
                "flash_attention": 0, "ssm_scan": 0}
    fwd_norms = fwd["rms_norm"] + 2 * encoder + cross
    if prefill:
        return {"rms_norm": fwd_norms, "decode_attention": 0, "flash_attention": encoder,
                "ssm_scan": 0}
    period = stack_period(kinds, every)
    whole = len(kinds) // period * period
    again = count(kinds[:whole], [i for i in shared if i < whole], 0)
    return {"rms_norm": fwd_norms + again["rms_norm"] + 2 * encoder, "decode_attention": 0,
            "flash_attention": (fwd["attn"] + fwd["cross"] + again["attn"] + again["cross"]
                                + 2 * encoder),
            "ssm_scan": fwd["ssm_scan"] + again["ssm_scan"]}


# Each main path's launches a step, fixed by hand: granite-3-2b has 40
# attention layers (2 in relocate_train); zamba2-7b 81 Mamba2 layers with the
# shared block before layers 0, 6, ..., 78 (14 times), and 39 layers (6
# periods of 6 and 3 tail layers, 7 shared blocks) when trained; dbrx-132b 8
# attention + MoE layers served and 3 trained; xlstm-1.3b 48 mLSTM and sLSTM
# blocks (6 periods of 8) served and one period trained; seamless-m4t-large-v2
# 24 encoder and 24 decoder layers (a decode step: 3 norms a decoder layer
# and the final norm; its prefill also the encoder's 2 a layer and final
# norm, and the encoder's 24 attentions through the flash kernel; a train
# step both stacks' attentions, the cross-attention too, and again under
# remat); qwen2-vl-2b 28 attention layers.  `launches_per_step` must give
# these.
MAIN_PATH_COUNTS = {
    "serve": dict(rms_norm=81, decode_attention=40, flash_attention=0, ssm_scan=0),
    "train": dict(rms_norm=81 + 80, decode_attention=0, flash_attention=40 + 40, ssm_scan=0),
    "sharded_train": dict(rms_norm=81 + 80, decode_attention=0, flash_attention=40 + 40,
                          ssm_scan=0),
    "serve_zamba2": dict(rms_norm=191, decode_attention=14, flash_attention=0, ssm_scan=0),
    "train_zamba2": dict(rms_norm=93 + 84, decode_attention=0, flash_attention=7 + 6,
                         ssm_scan=39 + 36),
    "serve_dbrx": dict(rms_norm=17, decode_attention=8, flash_attention=0, ssm_scan=0),
    "train_dbrx": dict(rms_norm=7 + 6, decode_attention=0, flash_attention=3 + 3, ssm_scan=0),
    "serve_xlstm": dict(rms_norm=97, decode_attention=0, flash_attention=0, ssm_scan=0),
    "train_xlstm": dict(rms_norm=17 + 16, decode_attention=0, flash_attention=0, ssm_scan=0),
    "serve_seamless": dict(rms_norm=73, decode_attention=24, flash_attention=0, ssm_scan=0),
    "train_seamless": dict(rms_norm=122 + 120, decode_attention=0, flash_attention=72 + 72,
                           ssm_scan=0),
    "serve_qwen2vl": dict(rms_norm=57, decode_attention=28, flash_attention=0, ssm_scan=0),
    "train_qwen2vl": dict(rms_norm=57 + 56, decode_attention=0, flash_attention=28 + 28,
                          ssm_scan=0),
    "relocate_train": dict(rms_norm=5 + 4, decode_attention=0, flash_attention=2 + 2,
                           ssm_scan=0),
    "live_move": dict(rms_norm=5 + 4, decode_attention=0, flash_attention=2 + 2, ssm_scan=0),
    "adapt_train": dict(rms_norm=81 + 80, decode_attention=0, flash_attention=40 + 40,
                        ssm_scan=0),
    "adapt_decode": dict(rms_norm=81, decode_attention=40, flash_attention=0, ssm_scan=0),
    # serve_seamless's prefill, once before its decode steps
    "serve_seamless_prefill": dict(rms_norm=49 + 73, decode_attention=0, flash_attention=24,
                                   ssm_scan=0),
}


def carries_state(cfg):
    """Whether the stack holds a recurrent state (Mamba2, mLSTM or sLSTM
    layers), which carries each bf16 rounding on to every later position."""
    return bool({"mamba2", "mlstm", "slstm"} & set(cfg.layer_pattern()))


def bf16_gradients_are_noise(cfg):
    """Whether some of the stack's leaves have bf16 gradients or first
    updates that rounding decides (see the note at TRAIN_TOL): a recurrent
    state's, an attention's K bias (qkv_bias) or an encoder-decoder's
    cross-attention."""
    return carries_state(cfg) or cfg.qkv_bias or cfg.n_encoder_layers > 0


def check_counts(what, counts, per_step, steps):
    for name, n in per_step.items():
        require(counts[name] == steps * n,
                f"{what}: {name} launched {counts[name]} times, expected {steps} * {n}")


# ---------------------------------------------------------------- phases --
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    require(smi, "nvidia-smi gave no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(phase="device", nvidia_smi=smi[0], torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         python=sys.version.split()[0], cpu_count=os.cpu_count(),
         cores_usable=len(os.sched_getaffinity(0)))
    return smi[0]


# The tensor-core instances: each must hold HMMA instructions in its SASS.
TENSOR_CORE_KERNELS = ("flash_fwd_bf16_kernel", "ssm_scan_bf16_kernel", "decode_bf16_tc_kernel")


def phase_build(verbose):
    """Builds the library; prints each kernel instance's registers, spill
    bytes (ptxas) and tensor-core instructions (HMMA in its SASS), and fails
    if a tensor-core instance holds none.  Returns those resources."""
    from repro_torch.kernels import _build
    built_now = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    resources = _build.kernel_resources()
    emit(phase="build", seconds=round(seconds, 3), built_now=built_now,
         sources=[p.name for p in _build.sources()], library=_build.library_path().name,
         kernels=resources)
    if verbose and built_now:
        print((_build.build_dir() / "build.log").read_text(), flush=True)
    for name in TENSOR_CORE_KERNELS:
        found = {k: r for k, r in resources.items() if k.split("<")[0] == name}
        require(found and all(r.get("hmma", 0) > 0 for r in found.values()),
                f"build: {name} holds no tensor-core instruction: {found}")
    return resources


RMS_CASES = [((8, 1, 2048), "bfloat16"), ((300, 512), "float32"),
             ((2, 37, 256), "bfloat16"), ((1, 5, 7, 64), "float32"),
             ((4096, 2048), "bfloat16"), ((16, 8192), "bfloat16"),
             ((8, 1, 3584), "bfloat16"), ((8192, 3584), "bfloat16"),   # zamba2's d_model
             ((8, 1, 7168), "bfloat16"), ((8192, 7168), "bfloat16"),   # zamba2's gated norm
             ((8, 1, 6144), "bfloat16"), ((8192, 6144), "bfloat16"),   # dbrx's d_model
             ((8, 1, 1536), "bfloat16"), ((8192, 1536), "bfloat16"),   # qwen2-vl's d_model
             ((8, 1, 1024), "bfloat16"), ((8192, 1024), "bfloat16")]   # seamless's d_model

# (name, B, Sk, Hq, Hkv, D, dtype); kv_len is ragged, see ragged_lens.  bf16
# groups of 3 to 8 run the tensor-core instance, fp32 and bf16 groups of 1
# or 2 the SIMT one.
DECODE_CASES = [
    ("granite-3-2b", 8, 4096, 32, 8, 64, "bfloat16"),
    ("qwen1.5-0.5b", 8, 4096, 16, 16, 64, "bfloat16"),
    ("long", 4, 32768, 32, 8, 64, "bfloat16"),
    ("mha-d32", 3, 384, 6, 6, 32, "float32"),
    ("mqa-d128", 1, 200, 8, 1, 128, "float32"),
    ("group6-d128", 2, 1000, 48, 8, 128, "bfloat16"),
    ("group2-fp32", 2, 777, 4, 2, 64, "float32"),
    ("zamba2-7b", 8, 4096, 32, 32, 112, "bfloat16"),
    ("zamba2-7b-fp32", 8, 4096, 32, 32, 112, "float32"),
    ("group4-d112", 2, 777, 16, 4, 112, "bfloat16"),
    ("dbrx-132b", 8, 4096, 48, 8, 128, "bfloat16"),
    ("qwen1.5-110b", 8, 4096, 64, 8, 128, "bfloat16"),
    ("kimi-k2", 8, 4096, 64, 8, 112, "bfloat16"),
    ("group3-d32", 2, 300, 6, 2, 32, "bfloat16"),
    ("padded-d96", 2, 500, 40, 8, 96, "bfloat16"),
    ("qwen2-vl-2b", 8, 4096, 12, 2, 128, "bfloat16"),
]
# The tile edges (a tile is 64 keys, 16 a warp) with Sk = 1000, no multiple
# of 64: kv_len 0, 1, 63, 64, 65, the whole cache and two in between.
DECODE_EDGE_LENS = [0, 1, 63, 64, 65, 1000, 700, 333]
DECODE_EDGE_CASES = [("tile-edge-g4-d64", 8, 1000, 16, 4, 64, "bfloat16"),
                     ("tile-edge-g8-d112", 8, 1000, 64, 8, 112, "bfloat16")]
# The bit-equality checks (stale cache, clamp and zero, rows permuted):
# granite's G 4 at D 64, dbrx's G 6 at D 128, kimi-k2's G 8 at D 112.
DECODE_INVARIANT_SHAPES = [(8, 4096, 32, 8, 64), (8, 4096, 48, 8, 128), (8, 4096, 64, 8, 112)]


# decode_attention's output: one bf16 step for bf16 (the kernel's output and
# the plain version's are each one rounding of nearly equal fp32 values, as
# flash_attention's are), 2e-5 for fp32.
DECODE_TOL = {dt: tol["out"] for dt, tol in FLASH_TOL.items()}


def ragged_lens(torch, B, Sk, device):
    """Per-row valid lengths that include 1 and Sk."""
    lens = [1, Sk] + [max(1, (Sk * (3 * i + 1)) // (3 * B + 1)) for i in range(B)]
    return torch.tensor(lens[:B] if B > 1 else [Sk - 7], dtype=torch.int32, device=device)


# (name, B, Sq, Sk, Hq, Hkv, D): the cases of tests/test_kernels.py::TestFlashAttention,
# ragged lengths, and the train phase's shape.
FLASH_CASES = [
    ("mha", 1, 128, 128, 4, 4, 64), ("gqa4", 2, 256, 256, 8, 2, 64),
    ("odd-heads-d32", 2, 256, 256, 6, 3, 32), ("mqa-d128", 1, 512, 512, 4, 1, 128),
    ("ragged", 1, 1000, 1000, 8, 2, 64), ("sq<sk", 2, 77, 300, 4, 2, 64),
    ("ragged-mha-d112", 1, 1000, 1000, 8, 8, 112), ("sq<sk-d112", 2, 77, 300, 8, 2, 112),
]
# bf16 alone: the tensor-core instance's edges (d_head 32, 112 and 128 with
# Sq != Sk both ways, MQA, GQA 4:1 over 1000 rows, and d_head 96, which runs
# the 128 instance with its last 32 columns zero).
FLASH_BF16_CASES = [
    ("sq<sk-d32", 2, 77, 300, 4, 2, 32), ("sq>sk-d112", 1, 1000, 333, 8, 4, 112),
    ("sq>sk-d128", 2, 300, 77, 4, 2, 128), ("sq<sk-d128", 1, 100, 1000, 4, 4, 128),
    ("mqa", 2, 1000, 1000, 8, 1, 64), ("gqa4-1000", 2, 1000, 1000, 16, 4, 64),
    ("padded-d96", 1, 333, 333, 4, 2, 96),
]
FLASH_TRAIN = ("granite-3-2b train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 8, 64)
FLASH_ZAMBA = ("zamba2-7b train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 112)
FLASH_DBRX = ("dbrx-132b train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 48, 8, 128)
FLASH_QWEN2VL = ("qwen2-vl-2b train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 12, 2, 128)
# seamless's training cross-attention (4096 decoder tokens against 2048
# frames) and its encoder, both non-causal.
FLASH_SEAMLESS_CROSS = ("seamless cross", TRAIN_BATCH, TRAIN_SEQ, SEAMLESS_TRAIN_FRAMES,
                        16, 16, 64)
FLASH_SEAMLESS_ENCODER = ("seamless encoder", TRAIN_BATCH, SEAMLESS_TRAIN_FRAMES,
                          SEAMLESS_TRAIN_FRAMES, 16, 16, 64)

# (B, S, H, P, N, chunk): the cases of tests/test_kernels.py::TestSsmScan, and
# zamba2-7b's training shape (d_inner 7168 = 112 heads of 64, state 64).
SSM_CASES = [(1, 128, 2, 16, 8, 32), (2, 256, 4, 64, 16, 64), (2, 192, 3, 32, 64, 64)]
SSM_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 112, 64, 64, 64)
# bf16 alone: chunk 32, P 16 and N 8, strided as `mamba2_block` hands them;
# P 12 and N 4, whose rows are no multiple of 16 bytes (plain loads); and an
# odd P 7 (y's rows on 2-byte boundaries).
SSM_BF16_CASES = [((2, 96, 3, 16, 8, 32), True), ((1, 64, 3, 12, 4, 16), False),
                  ((1, 64, 2, 7, 4, 16), False)]


def flash_errors(torch, got, want, dt):
    """(out error, out error over allowance, lse error, lse over allowance)."""
    tol = FLASH_TOL[dt]
    return (*errors(torch, got[0], want[0], dt, tol["out"]),
            *errors(torch, got[1], want[1], dt, tol["lse"]))


def check_flash(torch, checks, case, causal, dt, control=False):
    """The kernel against its plain version.  With ``control``, also the
    plain version with the last key tile (the kernel's 4096 / D keys)
    dropped, which the same check must refuse."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    name, B, Sq, Sk, Hq, Hkv, D = case
    dtype = getattr(torch, dt)
    q = rand(torch, (B, Sq, Hq, D), dtype, 21, "cuda")
    k = rand(torch, (B, Sk, Hkv, D), dtype, 22, "cuda")
    v = rand(torch, (B, Sk, Hkv, D), dtype, 23, "cuda")
    out, lse = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal)
    require(out.shape == q.shape and out.dtype == q.dtype and lse.dtype == torch.float32
            and lse.shape == (B, Hkv, Hq // Hkv, Sq), f"flash_attention {name}: shape/dtype")
    err, ratio, lerr, lratio = flash_errors(torch, (out, lse), want, dt)
    row = dict(kernel="flash_attention", case=name, shape=[B, Sq, Sk, Hq, Hkv, D],
               causal=causal, dtype=dt, max_abs_err=err, err_over_tol=ratio,
               lse_max_abs_err=lerr, lse_err_over_tol=lratio, tol=FLASH_TOL[dt])
    checks.append(row)
    require(ratio <= 1.0 and lratio <= 1.0,
            f"flash_attention {name} causal={causal} {dt}: error {err} / lse {lerr}")
    if control:
        tile = 4096 // D
        wrong = flash_attention_plain(q, k[:, :Sk - tile], v[:, :Sk - tile], causal)
        _, c_ratio, _, c_lratio = flash_errors(torch, wrong, want, dt)
        row["control_last_key_tile_dropped"] = dict(keys=tile, err_over_tol=c_ratio,
                                                    lse_err_over_tol=c_lratio)
        require(max(c_ratio, c_lratio) > 1.0,
                f"flash_attention {name}: the check passes a dropped key tile")
    return err


def check_flash_grad(torch, checks, Hq=8, Hkv=2, D=64, causal=True, Sq=300, Sk=300):
    """The training autograd Function (CUDA forward, ported backward) against
    autograd through the plain attention, fp32."""
    from repro_torch.models.attention import flash_attention_jnp, gqa_reference
    B, chunk = 2, 128                                        # ragged last chunks
    base = [rand(torch, shape, torch.float32, 31 + i, "cuda")
            for i, shape in enumerate([(B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)])]
    w = rand(torch, (B, Sq, Hq, D), torch.float32, 34, "cuda")
    grads = []
    for fn in (lambda q, k, v: flash_attention_jnp(q, k, v, causal, chunk, chunk),
               lambda q, k, v: gqa_reference(q, k, v, causal)):
        leaves = [t.clone().requires_grad_(True) for t in base]
        grads.append(torch.autograd.grad((fn(*leaves) * w).sum(), leaves))
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, want in zip("qkv", *grads):
        err = (g - want).abs()
        ratio = float((err / (GRAD_TOL["atol"] + GRAD_TOL["rtol"] * want.abs())).max())
        worst = max(worst, ratio)
        require(ratio <= 1.0, f"flash_attention backward: d{name} differs by {float(err.max())}")
    checks.append(dict(kernel="flash_attention", case="autograd Function vs gqa_reference",
                       shape=[B, Sq, Sk, Hq, Hkv, D], causal=causal, chunk=chunk,
                       dtype="float32",
                       grad_err_over_tol=worst, tol=GRAD_TOL))


def ssm_inputs(torch, case, dtype, seed, device, strided=False):
    """x, Bm, Cm, dt, A_log, D as tests/test_kernels.py draws them.  With
    ``strided``, x, B and C are column slices of one (B, S, H*P + 2N)
    tensor, as `mamba2_block` hands them to the kernel."""
    B, S, H, P, N, _ = case
    if strided:
        conv = rand(torch, (B, S, H * P + 2 * N), dtype, seed, device)
        x = conv[..., :H * P].unflatten(-1, (H, P))
        Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    else:
        x = rand(torch, (B, S, H, P), dtype, seed, device)
        Bm = rand(torch, (B, S, N), dtype, seed + 1, device)
        Cm = rand(torch, (B, S, N), dtype, seed + 2, device)
    dt = torch.nn.functional.softplus(rand(torch, (B, S, H), torch.float32, seed + 3, device))
    A_log = rand(torch, (H,), torch.float32, seed + 4, device) * 0.5
    D = rand(torch, (H,), torch.float32, seed + 5, device)
    return x, Bm, Cm, dt, A_log, D


def check_ssm(torch, checks, case, dt, strided=False, control=False):
    """The kernel against its plain version: y and the final state.  With
    ``control``, also the plain version with the carried state zeroed at
    every chunk (each chunk scanned alone), which the same check must
    refuse."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
    B, S, H, P, N, chunk = case
    args = ssm_inputs(torch, case, getattr(torch, dt), 61, "cuda", strided)
    y, st = ssm_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    wy, ws = ssm_scan_plain(*args, chunk)
    require(y.shape == (B, S, H, P) and y.dtype == args[0].dtype and st.shape == (B, H, P, N)
            and st.dtype == torch.float32, f"ssm_scan {case}: shape/dtype")
    tol = ssm_tol(dt, wy)
    err, ratio = errors(torch, y, wy, dt, tol)
    serr, sratio = errors(torch, st, ws, "float32", SSM_STATE_TOL)
    row = dict(kernel="ssm_scan", shape=list(case), dtype=dt, strided=strided,
               max_abs_err=err, err_over_tol=ratio, tol=tol, state_max_abs_err=serr,
               state_err_over_tol=sratio, state_tol=SSM_STATE_TOL)
    checks.append(row)
    require(ratio <= 1.0 and sratio <= 1.0, f"ssm_scan {case} {dt}: error {err} / state {serr}")
    if control:
        cut = lambda t: t.reshape(B * (S // chunk), chunk, *t.shape[2:])
        x, Bm, Cm, dtt, A_log, D = args
        wrong, _ = ssm_scan_plain(cut(x), cut(Bm), cut(Cm), cut(dtt), A_log, D, chunk)
        _, c_ratio = errors(torch, wrong.reshape(B, S, H, P), wy, dt, tol)
        row["control_state_zeroed_each_chunk"] = dict(err_over_tol=c_ratio)
        require(c_ratio > 1.0, f"ssm_scan {case}: the check passes a scan that drops the state")
    return err


def check_ssm_decay(torch, checks):
    """tests/test_kernels.py's property on the kernel: with a decay of
    exp(-50) a step, the last outputs do not see far-past inputs."""
    from repro_torch.kernels.ssm_scan import ssm_scan
    B, S, H, P, N = 1, 128, 1, 8, 4
    x, Bm, Cm, _, _, _ = ssm_inputs(torch, (B, S, H, P, N, 32), torch.float32, 71, "cuda")
    dt = torch.full((B, S, H), 50.0, device="cuda")
    A_log, D = torch.zeros(H, device="cuda"), torch.zeros(H, device="cuda")
    y1, _ = ssm_scan(x, Bm, Cm, dt, A_log, D, chunk=32)
    x2 = x.clone()
    x2[:, :64] = 123.0
    y2, _ = ssm_scan(x2, Bm, Cm, dt, A_log, D, chunk=32)
    torch.cuda.synchronize()
    late = float((y1[:, -16:] - y2[:, -16:]).abs().max())
    early = float((y1[:, :64] - y2[:, :64]).abs().max())
    checks.append(dict(kernel="ssm_scan", case="decay property", late_max_abs_diff=late,
                       early_max_abs_diff=early, tol=1e-3))
    require(late <= 1e-3 and early > 1e-3, f"ssm_scan decay property: late {late}, early {early}")


def check_ssm_grad(torch, checks):
    """The autograd Function (CUDA forward, plain recompute in the backward)
    against autograd through the plain scan, fp32: gradients of a weighted
    sum of y and the final state for all six inputs."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
    case = (2, 256, 4, 64, 16, 64)
    B, S, H, P, N, chunk = case
    base = ssm_inputs(torch, case, torch.float32, 81, "cuda")
    wy = rand(torch, (B, S, H, P), torch.float32, 87, "cuda")
    ws = rand(torch, (B, H, P, N), torch.float32, 88, "cuda")
    grads = []
    before = ssm_scan.launches
    for fn in (ssm_scan, ssm_scan_plain):
        leaves = [t.clone().requires_grad_(True) for t in base]
        y, st = fn(*leaves, chunk=chunk)
        grads.append(torch.autograd.grad((y * wy).sum() + (st * ws).sum(), leaves))
    torch.cuda.synchronize()
    require(ssm_scan.launches == before + 1, "ssm_scan backward: the Function did not launch")
    worst = 0.0
    for name, g, want in zip(("x", "Bm", "Cm", "dt", "A_log", "D"), *grads):
        err = (g - want).abs()
        allowed = GRAD_TOL["atol"] * max(1.0, float(want.abs().max())) + GRAD_TOL["rtol"] * want.abs()
        ratio = float((err / allowed).max())
        worst = max(worst, ratio)
        require(ratio <= 1.0, f"ssm_scan backward: d{name} differs by {float(err.max())}")
    checks.append(dict(kernel="ssm_scan", case="autograd Function vs plain autograd",
                       shape=list(case), dtype="float32", grad_err_over_tol=worst,
                       tol="1e-4 of the gradient's largest magnitude + 1e-4 of each element"))


def exact_decode(torch, q, k, v, lens):
    """The attention in float64, zeros where kv_len is 0 (as the kernels
    give), rounded once to q's type."""
    B, _, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    s = torch.einsum("bkgd,btkd->bkgt", q.double().reshape(B, Hkv, Hq // Hkv, D),
                     k.double()) / D ** 0.5
    valid = torch.arange(Sk, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf")).softmax(-1).nan_to_num(0.0)
    return torch.einsum("bkgt,btkd->bkgd", s, v.double()).reshape(q.shape).to(q.dtype)


def check_decode(torch, case, lens):
    """The kernel against its plain version at one case, by the case's
    tolerance (`DECODE_TOL`); and the control, the plain version with each
    row's last valid key dropped, which the same check must refuse.  In
    bf16 also how many outputs of each differ from the float64 attention
    rounded once (`exact_decode`): the kernel's count may not exceed three
    times the plain version's and 16 more."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    name, B, Sk, Hq, Hkv, D, dt = case
    dtype, device = getattr(torch, dt), lens.device
    q = rand(torch, (B, 1, Hq, D), dtype, 7, device)
    k = rand(torch, (B, Sk, Hkv, D), dtype, 8, device)
    v = rand(torch, (B, Sk, Hkv, D), dtype, 9, device)
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, lens)
    err, ratio = errors(torch, got, want, dt, DECODE_TOL[dt])
    short = decode_attention_plain(q, k, v, (lens - 1).clamp_min(0))
    out = dict(kernel="decode_attention", case=name, shape=[B, Sk, Hq, Hkv, D], dtype=dt,
               kv_len=lens.tolist(), max_abs_err=err, err_over_tol=ratio, tol=DECODE_TOL[dt],
               control_err_over_tol=errors(torch, short, want, dt, DECODE_TOL[dt])[1])
    if dt == "bfloat16":
        exact = exact_decode(torch, q, k, v, lens)
        out.update(outputs=exact.numel(), off_exact=int((got != exact).sum()),
                   plain_off_exact=int((want != exact).sum()))
    return out


def check_decode_invariants(torch, checks, shape, device):
    """Bit-equalities at one shape: entries past kv_len (999 in K, NaN in V)
    do not touch the result; kv_len past Sk is clamped and 0 gives zeros;
    a row's result does not depend on its slot.  Returns the inputs."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
    dtype = torch.bfloat16
    B, Sk, Hq, Hkv, D = shape
    q = rand(torch, (B, 1, Hq, D), dtype, 10, device)
    k = rand(torch, (B, Sk, Hkv, D), dtype, 11, device)
    v = rand(torch, (B, Sk, Hkv, D), dtype, 12, device)
    lens = torch.tensor([1, 64, 65, 500, 513, 2048, 3000, 4095], dtype=torch.int32,
                        device=device)
    out1 = decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    for b in range(B):
        k2[b, int(lens[b]):] = 999.0
        v2[b, int(lens[b]):] = float("nan")
    out2 = decode_attention(q, k2, v2, lens)
    torch.cuda.synchronize()
    require(torch.equal(out1, out2), f"decode_attention {shape}: stale cache past kv_len leaked")
    checks.append(dict(kernel="decode_attention", case="stale cache past kv_len",
                       shape=list(shape), bit_equal=True))
    del k2, v2

    over = decode_attention(q, k, v, torch.full((B,), Sk + 5, dtype=torch.int32, device=device))
    full = decode_attention(q, k, v, Sk)
    zero = decode_attention(q, k, v, torch.zeros((B,), dtype=torch.int32, device=device))
    torch.cuda.synchronize()
    require(torch.equal(over, full), f"decode_attention {shape}: kv_len > Sk is not clamped")
    require(bool((zero == 0).all()), f"decode_attention {shape}: kv_len == 0 is not zeros")
    err, ratio = errors(torch, over, decode_attention_plain(q, k, v, Sk + 5), "bfloat16",
                        DECODE_TOL["bfloat16"])
    require(ratio <= 1.0, f"decode_attention {shape}: kv_len > Sk disagrees with the plain version")
    checks.append(dict(kernel="decode_attention", case="kv_len > Sk clamped, kv_len == 0 zeros",
                       shape=list(shape), max_abs_err=err, err_over_tol=ratio,
                       bit_equal_to_full=True))

    perm = torch.tensor([3, 0, 7, 1, 6, 2, 5, 4], device=device)
    out_p = decode_attention(q[perm].contiguous(), k[perm].contiguous(),
                             v[perm].contiguous(), lens[perm].contiguous())
    torch.cuda.synchronize()
    require(torch.equal(out_p, out1[perm]), f"decode_attention {shape}: result depends on the slot")
    checks.append(dict(kernel="decode_attention", case="rows permuted", shape=list(shape),
                       bit_equal=True))

    # Two streams at once: each counts its rows' splits on its own counters,
    # and every launch leaves them zero.
    from repro_torch.kernels.decode_attention import _COUNTERS
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(st):
            outs.append(decode_attention(q, k, v, lens))
    torch.cuda.synchronize()
    require(all(torch.equal(o, out1) for o in outs),
            f"decode_attention {shape}: two streams at once disagree")
    require(all(int(c.abs().sum()) == 0 for c in _COUNTERS.values()),
            "decode_attention: a launch left its split counters non-zero")
    checks.append(dict(kernel="decode_attention", case="two streams at once, counters left zero",
                       shape=list(shape), bit_equal=True))
    return q, k, v, lens


def phase_kernels(torch, device):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rms_norm, rms_norm_plain
    from repro_torch.kernels.ssm_scan import ssm_scan

    checks = []
    for shape, dt in RMS_CASES:
        dtype = getattr(torch, dt)
        x = rand(torch, shape, dtype, 13, device) * 3.0
        scale = rand(torch, shape[-1:], dtype, 14, device)
        got = rms_norm(x, scale, 1e-5)
        torch.cuda.synchronize()
        err, ratio = errors(torch, got, rms_norm_plain(x, scale, 1e-5), dt)
        checks.append(dict(kernel="rms_norm", shape=list(shape), dtype=dt,
                           max_abs_err=err, err_over_tol=ratio, tol=TOL[dt]))
        require(got.shape == x.shape and got.dtype == x.dtype, f"rms_norm {shape}: shape/dtype")
        require(ratio <= 1.0, f"rms_norm {shape} {dt}: error {err} beyond tolerance")

    edge_lens = torch.tensor(DECODE_EDGE_LENS, dtype=torch.int32, device=device)
    decode_checks = [check_decode(torch, case, ragged_lens(torch, case[1], case[2], device))
                     for case in DECODE_CASES]
    decode_checks += [check_decode(torch, case, edge_lens) for case in DECODE_EDGE_CASES]
    emit(phase="kernels", decode_cases=decode_checks)
    for c in decode_checks:
        require(c["err_over_tol"] <= 1.0,
                f"decode_attention {c['case']}: error {c['max_abs_err']} beyond tolerance")
        require(c["control_err_over_tol"] > 1.0,
                f"decode_attention {c['case']}: the control (last valid key dropped) passed")
        require(c.get("off_exact", 0) <= 3 * c.get("plain_off_exact", 0) + 16,
                f"decode_attention {c['case']}: {c.get('off_exact')} outputs off the exact "
                f"value, against the plain version's {c.get('plain_off_exact')}")
    checks += decode_checks
    for shape in DECODE_INVARIANT_SHAPES:
        q, k, v, lens = check_decode_invariants(torch, checks, shape, device)

    for case in FLASH_CASES:
        for causal in (True, False):
            for dt in ("float32", "bfloat16"):
                check_flash(torch, checks, case, causal, dt)
    for case in FLASH_BF16_CASES:
        for causal in (True, False):
            check_flash(torch, checks, case, causal, "bfloat16")
    check_flash(torch, checks, FLASH_TRAIN, True, "bfloat16", control=True)
    torch.cuda.empty_cache()
    check_flash(torch, checks, FLASH_ZAMBA, True, "bfloat16", control=True)
    torch.cuda.empty_cache()
    check_flash(torch, checks, FLASH_DBRX, True, "bfloat16", control=True)
    torch.cuda.empty_cache()
    check_flash_grad(torch, checks)
    check_flash_grad(torch, checks, Hq=4, Hkv=4, D=112)
    check_flash_grad(torch, checks, Hq=6, Hkv=1, D=128)      # dbrx's G 6 at d_head 128
    # Non-causal at Sq != Sk both ways: seamless's encoder and cross heads
    # (G 1, d_head 64), and G 6 at d_head 128.
    check_flash_grad(torch, checks, Hq=4, Hkv=4, D=64, causal=False, Sq=300, Sk=172)
    check_flash_grad(torch, checks, Hq=6, Hkv=1, D=128, causal=False, Sq=172, Sk=300)

    for case in SSM_CASES:
        for dt in ("float32", "bfloat16"):
            check_ssm(torch, checks, case, dt)
    check_ssm(torch, checks, SSM_CASES[1], "bfloat16", strided=True)
    for case, strided in SSM_BF16_CASES:
        check_ssm(torch, checks, case, "bfloat16", strided=strided)
    check_ssm(torch, checks, SSM_TRAIN, "bfloat16", strided=True, control=True)
    torch.cuda.empty_cache()
    check_ssm_decay(torch, checks)
    check_ssm_grad(torch, checks)

    # What the wrappers refuse.
    for bad in (lambda: rms_norm(q.half(), q.half()[0, 0, 0], 1e-5),
                lambda: decode_attention(q.double(), k.double(), v.double(), lens),
                lambda: decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                                         v, lens),
                lambda: flash_attention(k.double(), k.double(), k.double()),
                lambda: flash_attention(k.transpose(1, 2).contiguous().transpose(1, 2), k, k),
                lambda: flash_attention(*[k[..., :60].contiguous()] * 3),         # 60 % 8
                lambda: decode_attention(q[..., :60].contiguous(), k[..., :60].contiguous(),
                                         v[..., :60].contiguous(), lens),
                lambda: ssm_scan(*ssm_inputs(torch, (1, 96, 2, 72, 8, 32), torch.float32, 3,
                                             device), chunk=32),                   # P 72
                lambda: ssm_scan(*ssm_inputs(torch, (1, 96, 2, 16, 8, 32), torch.float16, 3,
                                             device), chunk=32)):
        try:
            bad()
        except (TypeError, ValueError):
            continue
        raise Failed("a wrapper took an argument it should refuse")
    emit(phase="kernels", checks=checks)


def build_model(torch, cfg, device):
    from repro_torch.models import DecoderLM
    model = DecoderLM(cfg, generator=torch.Generator(device).manual_seed(0), device=device)
    return model.params


def draw_requests(n, vocab, seed=0):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 65, size=n)
    return [Request(i, rng.integers(1, vocab, size=int(lens[i])).tolist(), max_new_tokens=32)
            for i in range(n)]


def record_logits(torch, engine, keep):
    """Wrap the engine's decode step: checks every step's logits for
    non-finite values (on the device) and keeps them when ``keep``."""
    state = {"finite": torch.ones((), dtype=torch.bool, device=engine.device), "logits": []}
    inner = engine._decode

    def decode(params, cache, tokens):
        cache, logits = inner(params, cache, tokens)
        state["finite"] &= torch.isfinite(logits).all()
        if keep:
            state["logits"].append(logits[:, 0].clone())
        return cache, logits

    engine._decode = decode
    return state


def phase_serve(torch, device, cfg, n_requests, phase="serve"):
    """``cfg`` at full size through `ServeEngine`: 8 slots x 4096 positions,
    ``n_requests`` greedy requests of 16-64 prompt and 32 new tokens, every
    one of which must finish; each kernel's launches equal to steps times its
    per-step count."""
    from repro_torch.serve import ServeEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(torch, cfg, device)
    engine = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                         eos_id=-1, temperature=0.0, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = record_logits(torch, engine, keep=False)
    requests = draw_requests(n_requests, cfg.vocab_size)
    for r in requests:
        engine.submit(r)

    zero_counts()
    t0 = time.perf_counter()
    finished = engine.run_until_done(max_steps=2000)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()

    steps = engine.steps
    tokens = sum(len(r.output) for r in finished)
    per_step = launches_per_step(cfg, train=False)
    require(len(finished) == n_requests and all(r.done and len(r.output) == 32
                                                for r in requests),
            f"{phase}: not every request finished with 32 tokens")
    require(all(0 <= t < cfg.vocab_size for r in requests for t in r.output),
            f"{phase}: a token outside the vocabulary")
    require(bool(state["finite"]), f"{phase}: non-finite logits")
    check_counts(phase, launches, per_step, steps)
    n_params = sum(t.numel() for t in _leaves(params))

    # How much of a step the card works: device time of the decode step (all
    # 8 slots busy) against the host-inclusive time of the same call.
    for r in draw_requests(SERVE_SLOTS, cfg.vocab_size, seed=2):
        engine.submit(r)
    for _ in range(3):
        engine.step()
    tokens_in = torch.ones((SERVE_SLOTS, 1), dtype=torch.int32, device=device)
    scratch = {"cache": engine.cache}

    def one_step():
        scratch["cache"], _ = engine._decode(params, scratch["cache"], tokens_in)

    step_call_ms = time_ms(torch, one_step, iters=3, warmup=1)
    step_device_ms, top, step_launches = profile_device_time(torch, one_step, iters=3)
    emit(phase=phase, model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, dtype=cfg.compute_dtype, slots=SERVE_SLOTS,
         max_len=SERVE_MAX_LEN, requests=n_requests, steps=steps, tokens_generated=tokens,
         slot_tokens_processed=sum(len(r.prompt) + len(r.output) - 1 for r in requests),
         seconds=seconds, generated_tokens_per_s=tokens / seconds,
         ms_per_step=seconds / steps * 1e3, decode_step_device_ms=step_device_ms,
         decode_step_call_ms=step_call_ms,
         device_idle_share=(None if step_device_ms is None
                            else 1.0 - step_device_ms / step_call_ms),
         decode_step_top_kernels=top, decode_step_kernel_launches=step_launches,
         setup_seconds=setup_s, launches=launches,
         launches_per_step=per_step,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         setup_peak_memory_bytes=setup_peak)
    del engine, params, scratch
    torch.cuda.empty_cache()
    return launches


def phase_serve_encdec(torch, device, cfg, phase="serve_seamless"):
    """An encoder-decoder at full size through its prefill and decode steps
    (the engine takes no cross length, as the reference's does not):
    `SERVE_SLOTS` sequences in lockstep, each with `SEAMLESS_FRAMES` stub
    frame embeddings and a `SEAMLESS_PROMPT`-token prompt, through
    ``make_prefill_step(cfg, SERVE_MAX_LEN, cross_len=SEAMLESS_FRAMES)``, then
    `SEAMLESS_DECODE_STEPS` greedy decode steps.  Finite logits, tokens in
    the vocabulary, the prefill's launches equal to its count and the
    decode steps' to steps times theirs."""
    import numpy as np
    from repro_torch.serve import make_decode_step, make_prefill_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(torch, cfg, device)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(
                 SERVE_SLOTS, SEAMLESS_PROMPT)).astype(np.int32)).to(device),
             "encoder_embeds": torch.from_numpy(stub_embeds(
                 rng, (SERVE_SLOTS, SEAMLESS_FRAMES, cfg.d_model))).to(device)}
    prefill = make_prefill_step(cfg, SERVE_MAX_LEN, cross_len=SEAMLESS_FRAMES, device=device)
    decode = make_decode_step(cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    zero_counts()
    t0 = time.perf_counter()
    cache, logits = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    at_prefill = read_counts()
    finite = torch.isfinite(logits).all()
    tokens = [logits[:, -1].argmax(-1, keepdim=True).int()]
    t0 = time.perf_counter()
    for _ in range(SEAMLESS_DECODE_STEPS):
        cache, logits = decode(params, cache, tokens[-1])
        finite &= torch.isfinite(logits).all()
        tokens.append(logits[:, -1].argmax(-1, keepdim=True).int())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = read_counts()

    out = torch.cat(tokens, dim=1)
    require(bool(finite), f"{phase}: non-finite logits")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            f"{phase}: a token outside the vocabulary")
    require(int(cache["index"]) == SEAMLESS_PROMPT + SEAMLESS_DECODE_STEPS,
            f"{phase}: the cache's index is {int(cache['index'])}")
    check_counts(phase + " prefill", at_prefill, launches_per_step(cfg, False, prefill=True), 1)
    check_counts(phase, {k: launches[k] - at_prefill[k] for k in launches},
                 launches_per_step(cfg, train=False), SEAMLESS_DECODE_STEPS)

    # How much of a decode step the card works, as in `phase_serve`.
    box = {"cache": cache}

    def one_step():
        box["cache"], _ = decode(params, box["cache"], tokens[-1])

    step_call_ms = time_ms(torch, one_step, iters=3, warmup=1)
    step_device_ms, top, step_launches = profile_device_time(torch, one_step, iters=3)
    generated = SERVE_SLOTS * SEAMLESS_DECODE_STEPS
    emit(phase=phase, model=cfg.name, layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
         d_model=cfg.d_model, params=sum(t.numel() for t in _leaves(params)),
         dtype=cfg.compute_dtype, rows=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
         encoder_frames=SEAMLESS_FRAMES, prompt_tokens=SEAMLESS_PROMPT,
         decode_steps=SEAMLESS_DECODE_STEPS, prefill_seconds=prefill_s,
         decode_seconds=decode_s, generated_tokens=generated,
         generated_tokens_per_s=generated / decode_s,
         ms_per_step=decode_s / SEAMLESS_DECODE_STEPS * 1e3,
         decode_step_device_ms=step_device_ms, decode_step_call_ms=step_call_ms,
         device_idle_share=(None if step_device_ms is None
                            else 1.0 - step_device_ms / step_call_ms),
         decode_step_top_kernels=top, decode_step_kernel_launches=step_launches,
         first_tokens=out[0, :8].tolist(), setup_seconds=setup_s, prefill_launches=at_prefill,
         launches=launches, launches_per_step=launches_per_step(cfg, train=False),
         cache_bytes=sum(t.numel() * t.element_size() for t in _leaves(cache)),
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         setup_peak_memory_bytes=setup_peak)
    del params, cache, box, batch
    torch.cuda.empty_cache()
    return launches


def stub_embeds(rng, shape):
    """Stub frontend embeddings (frames or patches) at the scale of the
    token embeddings' init, d_model ** -0.5, fp32 on the host."""
    return rng.standard_normal(shape, dtype="float32") * shape[-1] ** -0.5


def grid_positions(batch, patches, n_text):
    """(3, batch, patches + n_text) int32 M-RoPE ids as Qwen2-VL numbers an
    image followed by text: patch i on a square grid of side s at t 0,
    h i // s, w i % s; the text counts on from s on all three axes."""
    import numpy as np
    side = math.isqrt(patches)
    require(side * side == patches, f"{patches} patches make no square grid")
    i = np.arange(patches)
    pos = np.zeros((3, batch, patches + n_text), np.int32)
    pos[1, :, :patches], pos[2, :, :patches] = i // side, i % side
    pos[:, :, patches:] = side + np.arange(n_text)
    return pos


class StubLM:
    """`SyntheticLM`'s step-indexed token batches (``TRAIN_BATCH`` rows),
    with the inputs that a config's stub frontend stands for, drawn from
    (``seed``, step): ``frames`` frame embeddings (an encoder-decoder's
    ``encoder_embeds``), or ``patches`` patch embeddings on a square grid
    with `grid_positions` (a VLM's ``vision_embeds`` and ``positions``).
    ``seq`` positions a row, the patches included."""

    def __init__(self, cfg, seq, seed, frames=0, patches=0):
        from repro_torch.data import DataConfig, SyntheticLM
        self.tokens = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                             global_batch=TRAIN_BATCH, seq_len=seq - patches,
                                             seed=seed))
        self.d, self.seed, self.frames, self.patches = cfg.d_model, seed, frames, patches

    def batch_at(self, step):
        import numpy as np
        batch = dict(self.tokens.batch_at(step))
        rng = np.random.default_rng((self.seed, step))
        if self.frames:
            batch["encoder_embeds"] = stub_embeds(rng, (TRAIN_BATCH, self.frames, self.d))
        if self.patches:
            batch["vision_embeds"] = stub_embeds(rng, (TRAIN_BATCH, self.patches, self.d))
            batch["positions"] = grid_positions(TRAIN_BATCH, self.patches,
                                                batch["inputs"].shape[1])
        return batch


def train_batches(torch, data, device, n):
    """The first ``n`` batches of ``data`` on the device."""
    return [{k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}
            for i in range(n)]


TRAIN_LOGS = {}                 # each train phase's metrics log, by phase


def phase_train(torch, device, cfg, steps, phase="train", data=None,
                loss_chunk=TRAIN_LOSS_CHUNK, mesh=None, optimizer=None, check_state=None):
    """``cfg`` through `Trainer.run`: 2 x 4096 positions a step (``data``,
    by default `SyntheticLM`'s tokens), AdamW, block remat, ``steps``
    steps; finite losses and gradient norms, and each kernel's launches
    equal to steps times its per-step count.  With ``mesh`` the trainer
    is sharded on it (`default_strategy`); ``check_state`` is called with
    the final state."""
    import statistics
    from repro_torch.parallel.sharding import default_strategy
    from repro_torch.train import Trainer, TrainerConfig

    tcfg = TrainerConfig(steps=steps, log_every=10 ** 9, loss_chunk=loss_chunk)
    data = data or StubLM(cfg, TRAIN_SEQ, tcfg.seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    strategy = default_strategy(mesh) if mesh is not None else None
    trainer = Trainer(cfg, tcfg, data, mesh=mesh, strategy=strategy, optimizer=optimizer,
                      device=device)
    state, _ = trainer.init_or_restore()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()

    zero_counts()
    t0 = time.perf_counter()
    state = trainer.run(state=state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    per_step = launches_per_step(cfg, train=True)
    log = trainer.metrics_log
    require(len(log) == steps and int(state["step"]) == steps, f"{phase}: not every step ran")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in log),
            f"{phase}: non-finite loss or gradient norm")
    check_counts(phase, launches, per_step, steps)
    step_s = statistics.median(r["dt_s"] for r in log[1:])

    # How much of a step the card works: device time of one more step from
    # the profiler against the host-clock time of the same step.
    batch = train_batches(torch, StubLM(cfg, TRAIN_SEQ, 7, data.frames, data.patches),
                          device, 1)[0]
    box = {"state": state}

    def one_step():
        box["state"], metrics = trainer._step(box["state"], batch)
        return metrics

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    step_call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step_device_ms, top, step_launches = profile_device_time(torch, one_step, iters=1)
    profile_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    TRAIN_LOGS[phase] = dict(log=log, step_s=step_s, peak=peak, step_device_ms=step_device_ms,
                             step_call_ms=step_call_s * 1e3)
    if check_state is not None:
        check_state(state)
    emit(phase=phase, model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=n_params, dtype=cfg.compute_dtype, remat=cfg.remat, optimizer=cfg.optimizer,
         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, encoder_frames=data.frames,
         patches=data.patches, loss_chunk=loss_chunk, steps=steps,
         per_step=[dict(step=r["step"], loss=r["loss"], grad_norm=r["grad_norm"],
                        seconds=r["dt_s"]) for r in log],
         seconds=seconds, median_step_seconds=step_s,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
         step_device_ms=step_device_ms, step_call_ms=step_call_s * 1e3,
         device_idle_share=(None if step_device_ms is None
                            else 1.0 - step_device_ms / (step_call_s * 1e3)),
         step_top_kernels=top, step_kernel_launches=step_launches,
         profiled_step_seconds=profile_s, launches=launches, launches_per_step=per_step,
         peak_memory_bytes=peak, setup_seconds=setup_s, setup_peak_memory_bytes=setup_peak)
    del trainer, state, box, batch
    torch.cuda.empty_cache()
    return launches


SHARDED_STEPS = 3
_MESH = {}


def one_rank_mesh(torch):
    """A (1, 1) ("data", "model") DeviceMesh on the card, over a one-rank
    NCCL process group (a FileStore under build/), made once a run."""
    if "mesh" not in _MESH:
        from repro_torch.runtime.elastic import MeshPlan, init_process_group

        store = Path(__file__).resolve().parent / "build" / "process_group_store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        init_process_group("cuda", f"file://{store}", 0, 1)
        _MESH["mesh"] = MeshPlan((1, 1), ("data", "model")).build()
    return _MESH["mesh"]


def close_mesh():
    if _MESH:
        import torch.distributed as dist
        _MESH.clear()
        dist.destroy_process_group()


def phase_sharded_train(torch, device, cfg, phase="sharded_train"):
    """``cfg`` through `Trainer(mesh=, strategy=default_strategy(mesh))` on a
    one-rank NCCL (1, 1) mesh: every state leaf a DTensor on the card with
    the placements `state_specs` gives; the first SHARDED_STEPS losses and
    gradient norms equal the unsharded ``train`` phase's bit for bit (same
    seed, batches and schedule: a one-rank gather and reduce-scatter are
    the tensors themselves); launches a step as the formula's."""
    from repro_torch._tree import tree_items
    from repro_torch.parallel.sharding import default_strategy, layouts, state_specs
    from repro_torch.train import make_optimizer, state_shapes
    from torch.distributed.tensor import DTensor

    opt = make_optimizer(cfg.optimizer, lr=1e-3, warmup=max(1, TRAIN_STEPS // 10),
                         total_steps=TRAIN_STEPS)       # the train phase's schedule
    if "train" not in TRAIN_LOGS:
        phase_train(torch, device, cfg, SHARDED_STEPS, "train", optimizer=opt)
    mesh = one_rank_mesh(torch)
    where = dict(tree_items(layouts(state_specs(state_shapes(cfg, opt), mesh,
                                                default_strategy(mesh)), mesh)))
    seen = {}

    def check_state(state):
        leaves = list(tree_items(state))
        require([p for p, _ in leaves] == list(where), f"{phase}: leaf paths differ")
        for path, t in leaves:
            require(isinstance(t, DTensor) and t.to_local().is_cuda
                    and tuple(t.placements) == tuple(where[path].placements),
                    f"{phase}: leaf {path} is not a DTensor on the card placed as "
                    f"state_specs says")
        seen["leaves"] = len(leaves)
        seen["sharded"] = sum(any(p.is_shard() for p in where[k].placements) for k in where)

    launches = phase_train(torch, device, cfg, SHARDED_STEPS, phase, mesh=mesh, optimizer=opt,
                           check_state=check_state)
    mine, plain = TRAIN_LOGS[phase], TRAIN_LOGS["train"]
    for a, b in zip(mine["log"], plain["log"][:SHARDED_STEPS]):
        require(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"],
                f"{phase}: step {a['step']} loss {a['loss']!r} / grad norm "
                f"{a['grad_norm']!r} != train's {b['loss']!r} / {b['grad_norm']!r}")
    emit(phase=phase + "_vs_train", mesh_shape=list(mesh.shape),
         mesh_axes=list(mesh.mesh_dim_names), backend="nccl", leaves=seen["leaves"],
         leaves_with_shard_placements=seen["sharded"],
         losses_and_grad_norms_bit_equal=True,
         step_seconds=mine["step_s"], train_step_seconds=plain["step_s"],
         step_over_train=mine["step_s"] / plain["step_s"],
         peak_memory_bytes=mine["peak"], train_peak_memory_bytes=plain["peak"],
         peak_over_train_bytes=mine["peak"] - plain["peak"],
         step_device_ms=mine["step_device_ms"], train_step_device_ms=plain["step_device_ms"],
         device_idle_share=(None if mine["step_device_ms"] is None
                            else 1.0 - mine["step_device_ms"] / mine["step_call_ms"]),
         train_device_idle_share=(None if plain["step_device_ms"] is None
                                  else 1.0 - plain["step_device_ms"] / plain["step_call_ms"]))
    return launches


# adapt: the adaptation flow's cell (the controller's, on 256 H100s), and
# the verification runs on the card: granite-3-2b at all 40 layers, train
# as the train phase (2 x 4096, block remat, loss_chunk 1024, AdamW) and
# decode as the serve phase's slots (8 x 4096 positions, every slot full),
# ADAPT_STEPS timed steps each and one more under the tally and profiler.
ADAPT_CELL, ADAPT_STEPS = ("granite-3-2b", "train_4k"), 3


def start_controller(out_path):
    """Steps 1-4 and 6 of the adaptation flow for `ADAPT_CELL` on the
    production mesh (`repro_torch.core.adaptation.adapt`, a meta trace on
    the host), in a process of its own that uses no card, so that it runs
    beside the card's phases; `phase_adapt` reads its result."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-W", "ignore", "-m", "repro_torch.core.adaptation",
           "--arch", ADAPT_CELL[0], "--shape", ADAPT_CELL[1], "--out", str(out_path)]
    out_path.unlink(missing_ok=True)
    with open(out_path.with_suffix(".err"), "w") as err:     # read if it fails
        return subprocess.Popen(cmd, env=env, cwd=str(root), stdout=subprocess.DEVNULL,
                                stderr=err)


def phase_adapt(torch, device, cfg, controller, out_path, smi_line):
    """`launch.dryrun.verify_cell`, Step 6 on the card, for granite's train
    step and decode step at the train and serve phases' sizes: the measured
    median step and peak beside the roofline of the same cut traced on
    meta; then the controller's run for `ADAPT_CELL` on the 256-H100 mesh:
    its analysis, GA plan, sizing and the dry run's terms under that plan.
    It runs before the phases that trace much with the profiler: a process
    that has traced much loses more of a trace's records.  Fails if the
    controller failed, a step is not finite,
    the card's FLOPs differ from the meta trace's, a kernel's scopes differ
    from the profiler's launches or from the per-step count, or the
    launches of the path from steps times that count.  Returns the two
    paths' launches."""
    from repro_torch.launch.dryrun import verify_cell
    from repro_torch.launch.plans import CellPlan

    close_mesh()                   # verify_cell opens its own one-rank group
    launches = {}
    runs = {"adapt_train": ("train_4k", TRAIN_BATCH, TRAIN_SEQ,
                            CellPlan(loss_chunk=TRAIN_LOSS_CHUNK), True),
            "adapt_decode": ("decode_32k", SERVE_SLOTS, SERVE_MAX_LEN, CellPlan(), False)}
    for path, (shape, batch, seq, plan, train) in runs.items():
        torch.cuda.empty_cache()
        zero_counts()
        try:
            v = verify_cell(ADAPT_CELL[0], shape, batch, seq, steps=ADAPT_STEPS, device=device,
                            plan=plan)
        except RuntimeError as e:
            raise Failed(f"{path}: {e}") from e
        launches[path] = read_counts()
        per_step = launches_per_step(cfg, train)
        want = {k: n for k, n in per_step.items() if n}
        require(v["card_scopes"] == want and v["op_stats"]["scopes"] == want,
                f"{path}: scopes {v['card_scopes']} on the card, {v['op_stats']['scopes']} "
                f"on meta, expected {want} a step")
        require({k: n for k, n in v["profiler_launches"].items() if n} == want,
                f"{path}: the profiler saw {v['profiler_launches']}, expected {want}")
        check_counts(path, launches[path], per_step, v["steps_run"])
        vr = v["roofline"]
        emit(phase=path, model=cfg.name, layers=cfg.n_layers, kind=v["kind"], cut=v["cut"],
             plan=v["plan"], mesh=v["mesh"], steps=ADAPT_STEPS, step_seconds=v["step_seconds"],
             median_step_s=v["median_step_s"], peak_memory_bytes=v["peak_memory_bytes"],
             roofline=vr, roofline_share=v["roofline_share"],
             flops_meta=v["op_stats"]["flops"], flops_card=v["card_flops"],
             bytes_meta=v["op_stats"]["bytes"], bytes_card=v["card_bytes"],
             wire_bytes=v["op_stats"]["wire_bytes"], scopes=v["card_scopes"],
             profiler_launches=v["profiler_launches"], wrapper_launches=v["wrapper_launches"],
             profiler_lost_records=v["profiler_lost_records"],
             kernels=v["op_stats"]["kernels"],
             meta_trace_s=v["t_trace_s"], nvidia_smi=smi_line, device=v["device"])
    try:
        controller.wait(timeout=600)
    except subprocess.TimeoutExpired as e:
        raise Failed("adapt: the controller ran past 600 s") from e
    require(controller.returncode == 0 and out_path.exists(),
            f"adapt: the controller failed ({controller.returncode}): "
            f"{out_path.with_suffix('.err').read_text()[-2000:]}")
    ctl = json.loads(out_path.read_text())
    row = ctl["verify"]
    require(row["status"] == "ok", f"adapt: the controller's dry run: {row}")
    r = row["roofline"]
    emit(phase="adapt_controller", cell=list(ADAPT_CELL), mesh=row["mesh"], chips=r["chips"],
         families=ctl["analysis"]["families"], offload=ctl["offload"],
         best_plan=ctl["best_plan"], baseline_t_step_s=ctl["baseline_t_step_s"],
         best_t_step_s=ctl["best_t_step_s"], ga_evaluations=ctl["ga_evaluations"],
         cards_needed=ctl["chips"], trace_s=row["t_trace_s"], seconds=ctl["seconds"],
         scopes=row["op_stats"]["scopes"], flops_per_device=row["op_stats"]["flops"],
         bytes_per_device=row["op_stats"]["bytes"],
         wire_bytes_by_axis=row["op_stats"]["wire_bytes_by_axis"],
         peak_bytes=row["op_stats"]["peak_bytes"], roofline=r, hw=r["hw"])
    return launches


def phase_slstm_layer(torch, device, cfg, phase="slstm_layer"):
    """One sLSTM block of ``cfg`` alone at the training shape (2 x 4096
    tokens, bf16, random weights from seed 0): host-clock ms of its forward
    without autograd and of its forward and backward, and from
    `torch.profiler` over one forward and backward the kernels launched,
    their device time, and the seconds the profiler itself took.  Its token
    loop sets a train_xlstm step's cost: block remat runs each sLSTM layer
    forward without autograd, then forward and backward again."""
    from repro_torch._tree import tree_leaves
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.xlstm import init_slstm, slstm_block

    params = init_slstm(torch.Generator(device).manual_seed(0), cfg, dtype_of(cfg.param_dtype),
                        device)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    x = rand(torch, (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), dtype_of(cfg.compute_dtype), 3,
             device)
    x.requires_grad_(True)

    def forward():
        with torch.no_grad():
            return slstm_block(params, x, cfg)[0]

    def forward_backward():
        out, _ = slstm_block(params, x, cfg)
        return torch.autograd.grad(out.float().square().mean(), [x, *leaves])

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    forward()                                    # warm-up
    forward_backward()
    fwd_ms, out = host_ms(forward)
    fb_ms, grads = host_ms(forward_backward)
    require(bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g).all())
                                                    for g in grads),
            f"{phase}: non-finite output or gradient")
    t0 = time.perf_counter()
    device_ms, top, n_launches = profile_device_time(torch, forward_backward, iters=1)
    profile_s = time.perf_counter() - t0
    n_slstm = sum(kind == "slstm" for kind in cfg.layer_pattern())
    emit(phase=phase, model=cfg.name, d_model=cfg.d_model, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
         dtype=cfg.compute_dtype, forward_ms=fwd_ms, forward_backward_ms=fb_ms,
         forward_backward_device_ms=device_ms,
         device_idle_share=None if device_ms is None else 1.0 - device_ms / fb_ms,
         forward_backward_kernel_launches=n_launches,
         kernel_launches_a_loop_step=n_launches / TRAIN_SEQ,
         profiled_seconds=profile_s, top_kernels=top, slstm_layers=n_slstm,
         train_step_slstm_seconds_estimate=n_slstm * (fwd_ms + fb_ms) / 1e3)
    del params, leaves, x, out, grads
    torch.cuda.empty_cache()


# train_vs_plain: how far the kernels' run may be from the plain run.  The
# loss is held absolutely, the gradient norm relatively, and the gradients
# and the run's update (end minus start) of every parameter leaf by
# ||kernel - plain|| / ||plain||: the first step's gradients, taken at the
# same parameters on both paths, most tightly; later steps' gradients
# start from parameters the first update already moved apart.  AdamW's
# first steps move an element by about the learning rate whatever its
# gradient's size, so an element whose gradient is near 0 may move either
# way on the two paths: the update is held more loosely than the gradient.
TRAIN_TOL = dict(loss_atol=1e-3, grad_norm_rtol=1e-2, grad_rel=5e-2, later_grad_rel=0.1,
                 update_rel=0.25)
# A cut with a recurrent state (zamba2's) is held to TRAIN_TOL in fp32.  In
# bf16 zamba2's plain run alone is farther from an fp32 run than TRAIN_TOL
# allows (worst leaf gradient 0.053 at step 0 and 0.41 at step 1, in the
# per-head dt_bias and A_log,
# whose gradients sum many cancelling terms; NVIDIA H100 80GB HBM3), so
# there the kernels' run is held against the fp32 run: loss and gradient
# norm by TRAIN_TOL, each step's worst leaf gradient within FP32_REF_MARGIN
# times the bf16 plain run's distance.  (Updates cannot be compared with an
# fp32 run: bf16 parameters round a step of lr away.)
#
# The seamless and qwen2-vl cuts are held so too.  Softmax ignores what
# adds the same score to every key of a query, so two kinds of leaf have a
# gradient that nearly cancels: a K projection's bias (qwen2-vl's
# qkv_bias; only RoPE's rotation keeps its gradient from 0) and the
# cross-attention's K projection over a memory whose frames share a large
# common part (seamless).  On seamless's 4 + 4 cut, after one AdamW step
# the fp32 gradient of cross.wk.w is 150 times smaller than at the start,
# and the bf16 plain run's lies 1.8-2.6 times its norm from it (the
# kernels' 2.1-2.9; stub frames at unit and at d_model ** -0.5 scale), so
# the kernels' run lies 1.40 from the plain run there, beside TRAIN_TOL's
# 0.1.  qwen2-vl's K bias gradients lie 1.7 % (step 0) and 5.5 % (step 1)
# from fp32 on both bf16 runs, but AdamW's first step moves each element
# by the learning rate in its gradient's sign, and the two runs' K bias
# updates lie 0.47 apart (TRAIN_TOL 0.25).  (This script's phases on an
# NVIDIA H100 80GB HBM3, 700 W; PERF.md §6.)
#
# The xLSTM cut's bf16 runs cannot be held to an fp32 trajectory at all.
# AdamW's first step moves every element by the learning rate in its
# gradient's sign, the bf16 gradients of the mixers' small leaves are
# largely rounding (conv_b's 43 % off fp32's), and the gates turn the
# flipped signs into another loss: after one step, four bf16 runs that
# differ only in how the norms round (the kernels, the plain version, the
# norm in float64 rounded once, the norm through vector_norm) lie 0.0094,
# 0.0007, 0.0068 and 0.0075 from the fp32 run's loss, and 0.0020, 0.0027,
# 0.0016 and 0.0019 at the fp32 run's own step-1 parameters
# (tools/xlstm_bf16_spread.py, NVIDIA H100 80GB HBM3).  There the bf16 runs
# take each step from the fp32 run's parameters, and their loss and
# gradient norm are held as the gradients are.
FP32_POINTS_CUTS = ("_xlstm",)


def rel_err(torch, got, want):
    """||got - want|| / ||want|| in fp32 (0 when both are 0)."""
    diff = float(torch.linalg.vector_norm(got.float() - want.float()))
    norm = float(torch.linalg.vector_norm(want.float()))
    return diff / norm if norm > 0 else (0.0 if diff == 0 else math.inf)


def train_twice(torch, cfg, device, seq, n_steps, fp32_ref=False, at_fp32_points=False,
                frames=0, patches=0):
    """``n_steps`` train steps from one state, on the kernels and under
    `use_plain()` (and with ``fp32_ref``, under `use_plain()` in fp32 from
    the same parameters).  With ``at_fp32_points`` the fp32 run goes first,
    and the kernels' and the plain run take each step from the fp32 run's
    parameters at that step (cast to the model's leaf types): their losses
    and gradients are those of the same parameters, on no trajectory of
    their own.  Returns (start parameters, {"kernel" | "plain" | "fp32":
    (parameters, [(loss, grad norm) a step], [gradients a step])}, each
    kernel's launches in the kernels' run)."""
    from repro_torch._tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.train import Optimizer, init_state, make_optimizer, make_train_step

    opt = make_optimizer("adamw", lr=1e-3, warmup=1, total_steps=n_steps)
    seen, points, recording = [], [], [False]

    def update(grads, state, params):         # keeps each step's gradients
        seen.append(tree_map(lambda g: g.clone(), grads))
        if recording[0]:                      # and the fp32 run's parameters
            points.append(tree_map(lambda t: t.clone(), params))
        return opt.update(grads, state, params)

    step_fn = make_train_step(cfg, Optimizer(opt.name, opt.init, update),
                              loss_chunk=TRAIN_LOSS_CHUNK)
    start = init_state(torch.Generator(device).manual_seed(0), cfg, opt, device=device)
    batches = train_batches(torch, StubLM(cfg, seq, 1, frames, patches), device, n_steps)

    def run(step=step_fn, begin=start):
        seen.clear()
        if points:
            metrics = []
            for point, batch in zip(points, batches):
                params = tree_map(lambda p, like: p.to(like.dtype, copy=True), point,
                                  begin["params"])
                state = {"params": params, "opt": opt.init(params), "step": begin["step"].clone()}
                metrics.append(step(state, batch)[1])
        else:
            state = tree_map(lambda t: t.clone(), begin)
            metrics = [step(state, b)[1] for b in batches]
        return (state["params"], [(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
                list(seen))

    def run_fp32():
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32", param_dtype="float32")
        p32 = tree_map(lambda t: t.float(), start["params"])
        begin = {"params": p32, "opt": opt.init(p32), "step": start["step"].clone()}
        step32 = make_train_step(cfg32, Optimizer(opt.name, opt.init, update),
                                 loss_chunk=TRAIN_LOSS_CHUNK)
        return run(step32, begin)

    runs = {}
    if at_fp32_points:
        recording[0] = True
        with ops.use_plain():
            runs["fp32"] = run_fp32()
        recording[0] = False
    zero_counts()
    runs["kernel"] = run()
    used = read_counts()
    with ops.use_plain():
        runs["plain"] = run()
        if fp32_ref and not at_fp32_points:
            runs["fp32"] = run_fp32()
    require(read_counts() == used, "train_vs_plain: use_plain() still launched a kernel")
    return start["params"], runs, used


def compare_train(torch, start, kern, plain):
    """The kernels' run against the plain run, in `TRAIN_TOL`'s measures,
    each with the leaf where it is largest."""
    from repro_torch._tree import tree_items, tree_leaves
    (kp, km, kg), (pp, pm, pg) = kern, plain

    def worst(triples):
        return max(((rel_err(torch, a, b), path) for path, a, b in triples),
                   default=(0.0, None))

    def grads(first, last):
        return worst((f"step {i}: {path}", a, b)
                     for i, (gk, gp) in enumerate(zip(kg[first:last], pg[first:last]), first)
                     for (path, a), (_, b) in zip(tree_items(gk), tree_items(gp)))

    grad, grad_at = grads(0, 1)
    later, later_at = grads(1, None)
    upd, upd_at = worst((path, a.float() - s.float(), b.float() - s.float())
                        for (path, a), (_, b), s in zip(tree_items(kp), tree_items(pp),
                                                        tree_leaves(start)))
    return dict(finite=all(math.isfinite(x) for step in km for x in step),
                loss_abs=max(abs(k[0] - p[0]) for k, p in zip(km, pm)),
                grad_norm_rel=max(abs(k[1] - p[1]) / p[1] for k, p in zip(km, pm)),
                grad_rel=grad, grad_rel_at=grad_at, later_grad_rel=later,
                later_grad_rel_at=later_at, update_rel=upd, update_rel_at=upd_at)


def train_agrees(m):
    t = TRAIN_TOL
    return (m["finite"] and m["loss_abs"] <= t["loss_atol"]
            and m["grad_norm_rel"] <= t["grad_norm_rtol"]
            and m["grad_rel"] <= t["grad_rel"] and m["later_grad_rel"] <= t["later_grad_rel"]
            and m["update_rel"] <= t["update_rel"])


def zero_scales(torch, tree):
    """A gradient tree with the norms' scales zeroed: what an `rms_norm`
    backward that dropped dscale would give."""
    if not isinstance(tree, dict):
        return tree
    return {k: torch.zeros_like(v) if k == "scale" else zero_scales(torch, v)
            for k, v in tree.items()}


def phase_train_vs_plain(torch, device, cfg4, phase="train_vs_plain", frames=0, patches=0):
    """Two train steps of a cut of the model from one state, on the kernels
    and under `use_plain()`: losses, gradient norms, every leaf's gradients
    and update (2 x 2048 positions, and ``frames`` / ``patches`` of stub
    embeddings, see `StubLM`).  Two controls must fail the same check: no
    update at all, and the gradients of the norms' scales zeroed."""
    seq, n_steps = 2048, 2
    start, runs, used = train_twice(torch, cfg4, device, seq, n_steps, frames=frames,
                                    patches=patches)
    check_counts(phase, used, launches_per_step(cfg4, train=True), n_steps)
    kern, plain = runs["kernel"], runs["plain"]
    got = compare_train(torch, start, kern, plain)
    no_dscale = [zero_scales(torch, grads) for grads in kern[2]]
    controls = {"no update": compare_train(torch, start, (start, *kern[1:]), plain),
                "norm scales' gradients zeroed": compare_train(
                    torch, start, (kern[0], kern[1], no_dscale), plain)}
    emit(phase=phase, model=cfg4.name, layers=cfg4.n_layers, dtype=cfg4.compute_dtype,
         batch=TRAIN_BATCH, seq_len=seq, encoder_layers=cfg4.n_encoder_layers,
         encoder_frames=frames, patches=patches, steps=n_steps, kernel=kern[1],
         plain=plain[1], measures=got, tol=TRAIN_TOL,
         controls={name: dict(m, fails=not train_agrees(m)) for name, m in controls.items()},
         launches=used)
    require(train_agrees(got), f"{phase}: the kernels' run is off: {got}")
    for name, m in controls.items():
        require(not train_agrees(m), f"{phase}: the control '{name}' passed")
    del runs, kern, plain, start, no_dscale
    torch.cuda.empty_cache()


def phase_train_vs_fp32(torch, device, cfg4, phase, at_fp32_points=False, frames=0,
                        patches=0):
    """Two bf16 train steps of a cut of the model, on the kernels and under
    `use_plain()`, each against the same steps in fp32 (see the note at
    TRAIN_TOL).  With ``at_fp32_points`` (see `FP32_POINTS_CUTS`) the bf16
    runs take each step from the fp32 run's parameters, and the loss and
    gradient norm are held like the gradients: within TRAIN_TOL, or within
    FP32_REF_MARGIN times the plain run's distance where that is larger.  A
    control must fail: the gradients of the norms' scales zeroed.
    ``frames`` / ``patches``: stub embeddings, as `phase_train_vs_plain`."""
    seq, n_steps = 2048, 2
    start, runs, used = train_twice(torch, cfg4, device, seq, n_steps, fp32_ref=True,
                                    at_fp32_points=at_fp32_points, frames=frames,
                                    patches=patches)
    check_counts(phase, used, launches_per_step(cfg4, train=True), n_steps)
    kern, plain, ref = runs["kernel"], runs["plain"], runs["fp32"]
    k, p = compare_train(torch, start, kern, ref), compare_train(torch, start, plain, ref)
    margin = FP32_REF_MARGIN if at_fp32_points else 0.0
    loss_tol = max(TRAIN_TOL["loss_atol"], margin * p["loss_abs"])
    norm_tol = max(TRAIN_TOL["grad_norm_rtol"], margin * p["grad_norm_rel"])

    def agrees(m):
        return (m["finite"] and m["loss_abs"] <= loss_tol and m["grad_norm_rel"] <= norm_tol
                and m["grad_rel"] <= FP32_REF_MARGIN * p["grad_rel"]
                and m["later_grad_rel"] <= FP32_REF_MARGIN * p["later_grad_rel"])

    no_dscale = [zero_scales(torch, grads) for grads in kern[2]]
    control = compare_train(torch, start, (kern[0], kern[1], no_dscale), ref)
    emit(phase=phase, model=cfg4.name, layers=cfg4.n_layers, dtype=cfg4.compute_dtype,
         batch=TRAIN_BATCH, seq_len=seq, encoder_frames=frames, patches=patches,
         steps=n_steps, kernel=kern[1], plain=plain[1], fp32=ref[1], kernel_vs_fp32=k,
         plain_vs_fp32=p,
         kernel_vs_plain=compare_train(torch, start, kern, plain), fp32_margin=FP32_REF_MARGIN,
         at_fp32_points=at_fp32_points, loss_tol=loss_tol, grad_norm_tol=norm_tol,
         control_norm_scales_gradients_zeroed=dict(control, fails=not agrees(control)),
         launches=used)
    require(agrees(k), f"{phase}: the kernels' run is farther from fp32 than the plain run's")
    require(not agrees(control), f"{phase}: the control passed")
    del runs, kern, plain, ref, start, no_dscale
    torch.cuda.empty_cache()


def _leaves(tree):
    from repro_torch._tree import tree_leaves
    return tree_leaves(tree)


def phase_timing(torch, device, launches, resources):
    """Times of the kernels at their paths' shapes (serving for rms_norm and
    decode_attention, training for flash_attention and ssm_scan; the other
    configs' heads beside granite's for the attention kernels, and
    seamless's non-causal encoder and cross-attention), beside their
    plain versions, one library call each where there is one, and the
    card's bound.  ``launches`` holds each path's counts by phase name;
    ``resources`` the build's registers, spills and HMMA counts by kernel
    instance, which the tensor-core kernels' rows name."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rms_norm, rms_norm_plain, work

    out = []
    dtype, dt = torch.bfloat16, "bfloat16"
    timer = DeviceTimer(torch, device)
    has_lib_norm = hasattr(F, "rms_norm")
    by_path = lambda name: {path: counts[name] for path, counts in launches.items()
                            if counts.get(name)}

    def norm_times(x, scale):
        """ms = device time a launch; call_ms = a call in a tight host loop.
        The kernel's result is held against the plain version first."""
        err, ratio = errors(torch, rms_norm(x, scale, 1e-5), rms_norm_plain(x, scale, 1e-5), dt)
        require(ratio <= 1.0, f"timing: rms_norm {list(x.shape)} error {err} beyond tolerance")
        ms, call = timer(lambda: rms_norm(x, scale, 1e-5), iters=200)
        plain, plain_call = timer(lambda: rms_norm_plain(x, scale, 1e-5), iters=200)
        lib, lib_call = (timer(lambda: F.rms_norm(x, x.shape[-1:], scale, 1e-5), iters=200)
                         if has_lib_norm else (None, None))
        ms2, call2 = timer(lambda: rms_norm(x, scale, 1e-5), iters=200)
        flops, nbytes = work(x, scale)
        b_ms, b_by = bound(nbytes, flops, "float32")   # fp32 math, no tensor cores
        return dict(max_abs_err=err, ms=min(ms, ms2), plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by,
                    library_ms=lib, call_ms=min(call, call2), plain_call_ms=plain_call,
                    library_call_ms=lib_call, shape=list(x.shape), bytes=nbytes)

    # rms_norm: the decode step's (slots, 1, d_model).
    x = rand(torch, (SERVE_SLOTS, 1, 2048), dtype, 1, device)
    scale = rand(torch, (2048,), dtype, 2, device)
    counts = by_path("rms_norm")
    out.append(dict(name="rms_norm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
                    replaces="src/repro/kernels/rmsnorm.py:24", launches=sum(counts.values()),
                    launches_by_path=counts, tol=TOL[dt],
                    **norm_times(x, scale), library="torch.nn.functional.rms_norm", dtype=dt))
    # The same kernel where bytes, not the launch, set the time; and zamba2's
    # gated norm over d_inner 7168 at the training shape.
    out[-1]["large"] = norm_times(rand(torch, (16384, 2048), dtype, 3, device), scale)
    out[-1]["zamba2_gated_train"] = norm_times(
        rand(torch, (TRAIN_BATCH, TRAIN_SEQ, 7168), dtype, 4, device),
        rand(torch, (7168,), dtype, 5, device))
    dbrx_scale = rand(torch, (6144,), dtype, 7, device)
    out[-1]["dbrx_decode"] = norm_times(rand(torch, (SERVE_SLOTS, 1, 6144), dtype, 6, device),
                                        dbrx_scale)
    out[-1]["dbrx_train"] = norm_times(rand(torch, (TRAIN_BATCH, TRAIN_SEQ, 6144), dtype, 8,
                                            device), dbrx_scale)
    # xlstm-1.3b's mLSTM mixer norm over d_inner 4096, serving and training.
    mlstm_scale = rand(torch, (4096,), dtype, 9, device)
    out[-1]["xlstm_mlstm_decode"] = norm_times(
        rand(torch, (SERVE_SLOTS, 1, 4096), dtype, 10, device), mlstm_scale)
    out[-1]["xlstm_mlstm_train"] = norm_times(
        rand(torch, (TRAIN_BATCH, TRAIN_SEQ, 4096), dtype, 11, device), mlstm_scale)

    counts = by_path("decode_attention")
    with SmiSampler() as smi:
        rows = decode_times(torch, timer, device, DECODE_TIMED[0][1], resources, smi)
        rows.update({key: decode_times(torch, timer, device, shape, resources, smi)
                     for key, shape in DECODE_TIMED[1:]})
    out.append(dict(name="decode_attention", route="cuda",
                    source="src/repro_torch/csrc/decode_attention.cu",
                    replaces="src/repro/kernels/decode_attention.py:59",
                    launches=sum(counts.values()), launches_by_path=counts,
                    library="torch.nn.functional.scaled_dot_product_attention(enable_gqa)",
                    **rows))
    torch.cuda.empty_cache()

    counts = by_path("flash_attention")
    out.append(dict(name="flash_attention", route="cuda",
                    source="src/repro_torch/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention.py:68",
                    launches=sum(counts.values()), launches_by_path=counts,
                    library="torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal, enable_gqa)",
                    **flash_times(torch, timer, device, FLASH_TRAIN, resources),
                    zamba2_d112=flash_times(torch, timer, device, FLASH_ZAMBA, resources),
                    dbrx_d128=flash_times(torch, timer, device, FLASH_DBRX, resources),
                    qwen2vl_g6_d128=flash_times(torch, timer, device, FLASH_QWEN2VL, resources),
                    seamless_cross=flash_times(torch, timer, device, FLASH_SEAMLESS_CROSS,
                                               resources, causal=False),
                    seamless_encoder=flash_times(torch, timer, device, FLASH_SEAMLESS_ENCODER,
                                                 resources, causal=False)))
    torch.cuda.empty_cache()

    counts = by_path("ssm_scan")
    out.append(dict(name="ssm_scan", route="cuda", source="src/repro_torch/csrc/ssm_scan.cu",
                    replaces="src/repro/kernels/ssm_scan.py:66",
                    launches=sum(counts.values()), launches_by_path=counts,
                    library="none: no single PyTorch call computes the scan",
                    **ssm_times(torch, timer, device, SSM_TRAIN, resources)))
    return out


# decode_attention's timed shapes (B, Sk, Hq, Hkv, D): the serve phases'
# slots and cache length at each config's heads; the first is the row's own.
DECODE_TIMED = [("granite_g4_d64", (SERVE_SLOTS, SERVE_MAX_LEN, 32, 8, 64)),
                ("zamba2_d112", (SERVE_SLOTS, SERVE_MAX_LEN, 32, 32, 112)),
                ("dbrx_g6_d128", (SERVE_SLOTS, SERVE_MAX_LEN, 48, 8, 128)),
                ("qwen1_5_110b_g8_d128", (SERVE_SLOTS, SERVE_MAX_LEN, 64, 8, 128)),
                ("kimi_k2_g8_d112", (SERVE_SLOTS, SERVE_MAX_LEN, 64, 8, 112)),
                ("qwen2vl_g6_d128", (SERVE_SLOTS, SERVE_MAX_LEN, 12, 2, 128)),
                ("seamless_d64", (SERVE_SLOTS, SERVE_MAX_LEN, 16, 16, 64))]
# The lengths the serve phase reaches: 499 valid keys over the 8 slots.
SERVED_LENS = [17, 33, 48, 64, 70, 81, 90, 96]
TIMING_REPEATS = 3


SMI_PERIOD_MS = 10


class SmiSampler:
    """One nvidia-smi process that samples card 0's SM clock (MHz), power
    draw (W) and temperature (C) every `SMI_PERIOD_MS` while it is open,
    each sample stamped with `time.monotonic()` as it arrives.  Its output
    goes through a pseudo-terminal, so that nvidia-smi writes each line as
    it takes it.  `window(t0, t1)` gives the median of each field over the
    samples stamped between two readings of the same clock."""

    FIELDS = ("sm_mhz", "power_w", "temp_c")

    def __init__(self, period_ms=SMI_PERIOD_MS):
        self.samples, self.lock = [], threading.Lock()
        master, slave = pty.openpty()
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", f"--loop-ms={period_ms}"],
            stdin=subprocess.DEVNULL, stdout=slave, stderr=subprocess.DEVNULL)
        os.close(slave)
        self.reader = threading.Thread(target=self._read, args=(master,), daemon=True)
        self.reader.start()
        deadline = time.monotonic() + 5.0        # its first sample, before any reading
        while not self.samples and time.monotonic() < deadline and self.proc.poll() is None:
            time.sleep(0.005)

    def _read(self, fd):
        try:
            with open(fd, "r", errors="replace") as lines:
                for line in lines:
                    now = time.monotonic()
                    sample = {}
                    for key, field in zip(self.FIELDS, line.split(",")):
                        try:
                            sample[key] = float(field)
                        except ValueError:          # "[N/A]" and the like
                            pass
                    with self.lock:
                        self.samples.append((now, sample))
        except OSError:                             # the terminal closed with the process
            pass

    def window(self, t0, t1):
        """{"smi_samples": n, field: median or None} over [t0, t1], once a
        sample from after t1 has come (or a second has passed)."""
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline and self.proc.poll() is None:
            with self.lock:
                if self.samples and self.samples[-1][0] >= t1:
                    break
            time.sleep(0.002)
        with self.lock:
            inside = [x for t, x in self.samples if t0 <= t <= t1]
        out = {"smi_samples": len(inside)}
        for key in self.FIELDS:
            xs = sorted(x[key] for x in inside if key in x)
            out[key] = xs[len(xs) // 2] if xs else None
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=5)


def repeated(timer, fns, smi, repeats=TIMING_REPEATS):
    """Each of ``fns`` (name -> (fn, iters)) timed ``repeats`` times in turn,
    beside the nvidia-smi samples (`SmiSampler`) taken during each reading:
    per name the median and the spread (max - min) of the device ms and of
    the host-loop ms, and the readings."""
    runs = {name: [] for name in fns}
    for _ in range(repeats):
        for name, (fn, iters) in fns.items():
            t0 = time.monotonic()
            ms, call = timer(fn, iters=iters)
            runs[name].append(dict(ms=ms, call_ms=call, **smi.window(t0, time.monotonic())))
    med = lambda xs: sorted(xs)[len(xs) // 2]
    return {name: dict(ms=med([r["ms"] for r in rs]), call_ms=med([r["call_ms"] for r in rs]),
                       ms_spread=max(r["ms"] for r in rs) - min(r["ms"] for r in rs),
                       call_ms_spread=max(r["call_ms"] for r in rs) - min(r["call_ms"] for r in rs),
                       runs=rs)
            for name, rs in runs.items()}


def decode_times(torch, timer, device, shape, resources, smi):
    """decode_attention at ``shape`` = (B, Sk, Hq, Hkv, D), bf16: every slot
    full (the most the shape can ask), and at the lengths the serve phase
    reaches; SDPA with the same mask beside it.  Kernel, plain version and
    SDPA are timed `TIMING_REPEATS` times in turn (median and spread), with
    the card's clock, power and temperature during each reading (``smi``); the
    build's registers, spills and HMMA count of the instance that runs."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention, decode_attention_plain,
                                                      kernel_instance, work)
    dtype, dt = torch.bfloat16, "bfloat16"
    B, Sk, Hq, Hkv, D = shape
    q = rand(torch, (B, 1, Hq, D), dtype, 4, device)
    # Two sets of caches, taken in turn: together they exceed the 50 MB L2,
    # so no call finds its keys left there by the call before.
    ks = [rand(torch, (B, Sk, Hkv, D), dtype, 5 + i, device) for i in range(2)]
    vs = [rand(torch, (B, Sk, Hkv, D), dtype, 7 + i, device) for i in range(2)]
    k, v = ks[0], vs[0]
    turn = {"i": 0}

    def caches():
        turn["i"] ^= 1
        return ks[turn["i"]], vs[turn["i"]]

    # The yardstick needs grouped heads in one call; older PyTorch lacks it.
    sdpa_gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")

    def measure(lens):
        mask = (torch.arange(Sk, device=device)[None, :] < lens[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)

        def sdpa():
            kk, vv = caches()
            return F.scaled_dot_product_attention(qt, kk.transpose(1, 2), vv.transpose(1, 2),
                                                  attn_mask=mask, enable_gqa=True)

        got = decode_attention(q, k, v, lens)
        err, ratio = errors(torch, got, decode_attention_plain(q, k, v, lens), dt, DECODE_TOL[dt])
        require(ratio <= 1.0, f"timing: decode_attention {shape} error {err} beyond tolerance")
        fns = {"kernel": (lambda: decode_attention(q, *caches(), lens), 50),
               "plain": (lambda: decode_attention_plain(q, *caches(), lens), 10)}
        if sdpa_gqa:
            fns["library"] = (sdpa, 50)
        t = repeated(timer, fns, smi)
        lib = t.get("library", {})
        valid = int(lens.clamp(0, Sk).sum())
        flops, nbytes = work(q, k, v, lens)
        b_ms, b_by = bound(nbytes, flops, dt)
        return dict(max_abs_err=err, err_over_tol=ratio, tol=DECODE_TOL[dt], ms=t["kernel"]["ms"],
                    ms_spread=t["kernel"]["ms_spread"], plain_ms=t["plain"]["ms"],
                    bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / t["kernel"]["ms"],
                    library_ms=lib.get("ms"), library_ms_spread=lib.get("ms_spread"),
                    call_ms=t["kernel"]["call_ms"], call_ms_spread=t["kernel"]["call_ms_spread"],
                    plain_call_ms=t["plain"]["call_ms"], library_call_ms=lib.get("call_ms"),
                    bytes=nbytes, valid_keys=valid, readings=t)

    full = measure(torch.full((B,), Sk, dtype=torch.int32, device=device))
    served = measure(torch.tensor(SERVED_LENS, dtype=torch.int32, device=device))
    return dict(full, shape=list(shape), dtype=dt, kv_len="every slot full",
                at_served_lengths=served,
                **instance(resources, kernel_instance(dtype, Hq // Hkv, D)))


def instance(resources, name):
    """The build's registers, spill bytes and HMMA count of one kernel
    instance, under its name (empty where the build phase did not run)."""
    return dict(instance=name, **resources.get(name, {}))


def flash_times(torch, timer, device, case, resources, causal=True):
    """flash_attention at a path's shape, bf16 (causal: Sq = Sk); SDPA beside."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain, work
    dtype, dt = torch.bfloat16, "bfloat16"
    _, B, Sq, Sk, Hq, Hkv, D = case
    q = rand(torch, (B, Sq, Hq, D), dtype, 41, device)
    k = rand(torch, (B, Sk, Hkv, D), dtype, 42, device)
    v = rand(torch, (B, Sk, Hkv, D), dtype, 43, device)
    err, ratio, _, lratio = flash_errors(torch, flash_attention(q, k, v, causal),
                                         flash_attention_plain(q, k, v, causal), dt)
    require(ratio <= 1.0 and lratio <= 1.0,
            f"timing: flash_attention {case[0]} error {err} beyond tolerance")
    sdpa_gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms, call = timer(lambda: flash_attention(q, k, v, causal), iters=20)
    plain, plain_call = timer(lambda: flash_attention_plain(q, k, v, causal), iters=3)
    lib, lib_call = (timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), iters=20) if sdpa_gqa else (None, None))
    ms2, call2 = timer(lambda: flash_attention(q, k, v, causal), iters=20)
    flops, nbytes = work(q, k, v, causal)
    b_ms, b_by = bound(nbytes, flops, dt)
    best = min(ms, ms2)
    name = f"flash_fwd_bf16_kernel<{D}, false>"     # the training shapes' D are exact instances
    return dict(max_abs_err=err, tol=FLASH_TOL[dt], ms=best, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib, call_ms=min(call, call2),
                plain_call_ms=plain_call, library_call_ms=lib_call, bytes=nbytes, flops=flops,
                achieved_tflops=flops / (best * 1e-3) / 1e12,
                achieved_gb_per_s=nbytes / (best * 1e-3) / 1e9,
                shape=[B, Sq, Sk, Hq, Hkv, D], dtype=dt, causal=causal,
                **instance(resources, name))


def ssm_times(torch, timer, device, case, resources):
    """ssm_scan at the train_zamba2 phase's shape, bf16, with x, B and C
    strided as `mamba2_block` hands them; the plain version beside it.  No
    single PyTorch call computes the scan, so there is no library time."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain, work
    from repro_torch.launch.roofline import H100_SXM
    dt = "bfloat16"
    L = case[-1]
    args = ssm_inputs(torch, case, torch.bfloat16, 91, device, strided=True)
    y, _ = ssm_scan(*args, chunk=L)
    want, _ = ssm_scan_plain(*args, L)
    tol = ssm_tol(dt, want)
    err, ratio = errors(torch, y, want, dt, tol)
    require(ratio <= 1.0, f"timing: ssm_scan error {err} beyond tolerance")
    del y, want
    ms, call = timer(lambda: ssm_scan(*args, chunk=L), iters=20)
    plain, plain_call = timer(lambda: ssm_scan_plain(*args, L), iters=3)
    ms2, call2 = timer(lambda: ssm_scan(*args, chunk=L), iters=20)
    flops, nbytes = work(*args, chunk=L)
    b_ms, b_by = bound(nbytes, flops, dt)
    best = min(ms, ms2)
    return dict(max_abs_err=err, tol=tol, ms=best, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, call_ms=min(call, call2),
                plain_call_ms=plain_call, library_call_ms=None, bytes=nbytes, flops=flops,
                fp32_core_ops_ms=flops / H100_SXM.peak_flops_fp32 * 1e3,
                achieved_gb_per_s=nbytes / (best * 1e-3) / 1e9,
                achieved_tflops=flops / (best * 1e-3) / 1e12,
                shape=list(case), dtype=dt, strided=True,
                **instance(resources, "ssm_scan_bf16_kernel"))


def run_engine_steps(torch, cfg, params, device, n_steps, requests, **kw):
    from repro_torch.serve import ServeEngine
    engine = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                         eos_id=-1, device=device, **kw)
    state = record_logits(torch, engine, keep=True)
    for r in requests:
        engine.submit(r)
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    require(bool(state["finite"]), f"{cfg.name}: non-finite logits")
    return torch.stack(state["logits"])          # (steps, slots, vocab)


# path_vs_plain against an fp32 run: at every decode step, the kernels'
# run's largest logit error against the same weights run in fp32 on the
# plain path may be at most this many times the bf16 plain run's.  The
# bf16 plain run is itself no exact answer: on zamba2's 9-layer cut it is
# 0.107 from the fp32 run (the phase prints it, and its error over the
# elementwise bf16 allowance 5e-2 + 5e-2·|want|), and a kernel that rounds
# one bf16 value the other way moves the hybrid's recurrent state by as
# much (NVIDIA H100 80GB HBM3).
FP32_REF_MARGIN = 1.25


@contextlib.contextmanager
def newest_key_dropped(torch):
    """Within the block, the plain decode attention leaves out each row's
    newest key."""
    from repro_torch.kernels import decode_attention as _decode
    plain_fn = _decode.decode_attention_plain
    _decode.decode_attention_plain = lambda q, k, v, kv_len: plain_fn(
        q, k, v, (torch.as_tensor(kv_len, device=q.device) - 1).clamp(min=1))
    try:
        yield
    finally:
        _decode.decode_attention_plain = plain_fn


# The decode step (counted from 0) at which the xLSTM control skips the
# update of every mLSTM layer's matrix memory C.
SKIPPED_C_STEP = 1


@contextlib.contextmanager
def mlstm_update_skipped(cfg):
    """Within the block, every mLSTM layer keeps its C of the step before at
    decode step `SKIPPED_C_STEP` (each decode step calls the recurrence once
    a mLSTM layer); its output and n and m are computed as ever."""
    from repro_torch.models import xlstm
    inner = xlstm.mlstm_recurrence
    layers = sum(kind == "mlstm" for kind in cfg.layer_pattern())
    calls = [0]

    def recurrence(q, k, v, igate, fgate, init=None):
        h, (C, n, m) = inner(q, k, v, igate, fgate, init)
        if calls[0] // layers == SKIPPED_C_STEP:
            C = init[0]
        calls[0] += 1
        return h, (C, n, m)

    xlstm.mlstm_recurrence = recurrence
    try:
        yield
    finally:
        xlstm.mlstm_recurrence = inner


PATH_STEPS = 16                # decode steps of each path_vs_plain run


def prefill_then_decode(torch, cfg, params, device, batch, cross_len=0, zero_cross=False):
    """``batch`` (on the device) through `make_prefill_step` (max_len
    SERVE_MAX_LEN, ``cross_len``), then `PATH_STEPS` decode steps fed the
    same tokens in every run (drawn from seed 2), so that runs compare
    step by step: the prefill's last logits and each step's, (PATH_STEPS +
    1, rows, vocab) fp32.  ``zero_cross``: every cross cache is zeroed
    after the prefill (a control)."""
    import numpy as np
    from repro_torch._tree import tree_items
    from repro_torch.serve import make_decode_step, make_prefill_step
    cache, logits = make_prefill_step(cfg, SERVE_MAX_LEN, cross_len=cross_len,
                                      device=device)(params, batch)
    if zero_cross:
        for path, t in tree_items(cache):
            if ".cross." in path:
                t.zero_()
    out, decode = [logits[:, -1]], make_decode_step(cfg)
    feed = np.random.default_rng(2).integers(1, cfg.vocab_size, size=(
        PATH_STEPS, batch["tokens"].shape[0], 1)).astype(np.int32)
    for tokens in feed:
        cache, logits = decode(params, cache, torch.from_numpy(tokens).to(device))
        out.append(logits[:, -1])
    torch.cuda.synchronize()
    logits = torch.stack(out).float()
    require(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite logits")
    return logits


def prefilled_runs(torch, cfg4, device):
    """For a cut that is prefilled (seamless's 4 + 4 layers: SERVE_SLOTS
    rows of SEAMLESS_FRAMES frames and a SEAMLESS_PROMPT-token prompt;
    qwen2-vl's: QWEN_PATCHES patches on their grid and a QWEN_CUT_PROMPT-
    token prompt), `phase_path_vs_plain`'s ``steps`` and ``control``.  The
    controls: the cross caches zeroed after the prefill; the patches given
    one id on all three axes (text's numbering)."""
    import numpy as np
    rng = np.random.default_rng(1)
    on = lambda a: torch.from_numpy(a).to(device)
    if cfg4.n_encoder_layers:
        batch = {"tokens": on(rng.integers(1, cfg4.vocab_size, size=(
                     SERVE_SLOTS, SEAMLESS_PROMPT)).astype(np.int32)),
                 "encoder_embeds": on(stub_embeds(rng, (SERVE_SLOTS, SEAMLESS_FRAMES,
                                                        cfg4.d_model)))}
        run = lambda zero: lambda cfg, params: prefill_then_decode(
            torch, cfg, params, device, batch, SEAMLESS_FRAMES, zero_cross=zero)
        return run(False), ("cross_cache_zeroed_after_prefill", run(True))
    n = QWEN_PATCHES + QWEN_CUT_PROMPT
    batch = {"tokens": on(rng.integers(1, cfg4.vocab_size, size=(
                 SERVE_SLOTS, QWEN_CUT_PROMPT)).astype(np.int32)),
             "vision_embeds": on(stub_embeds(rng, (SERVE_SLOTS, QWEN_PATCHES, cfg4.d_model))),
             "positions": on(grid_positions(SERVE_SLOTS, QWEN_PATCHES, QWEN_CUT_PROMPT))}
    flat = dict(batch, positions=on(np.broadcast_to(np.arange(n, dtype=np.int32),
                                                    (3, SERVE_SLOTS, n)).copy()))
    run = lambda b: lambda cfg, params: prefill_then_decode(torch, cfg, params, device, b)
    return run(batch), ("patches_on_one_id_for_all_three_axes", run(flat))


def phase_path_vs_plain(torch, device, cfg4, params4, phase="path_vs_plain", elementwise=True,
                        steps=None, control=None):
    """`PATH_STEPS` decode steps of a cut of the model through the engine
    (or ``steps(cfg, params)``, a prefill and decode steps: then the
    prefill's logits too), on the kernels, under `use_plain()`, and under
    `use_plain()` in fp32: logits and greedy tokens.  ``elementwise`` also
    holds the kernels' logits to the bf16 plain run's elementwise.  A
    control that must fail: the plain run with the newest key of every
    decode attention dropped, or, for a stack without attention (xLSTM),
    with one decode step's update of every mLSTM layer's C skipped, or
    ``control`` = (its name, its ``steps``)."""
    from repro_torch._tree import tree_map
    from repro_torch.kernels import ops

    n_steps = PATH_STEPS
    per_step = launches_per_step(cfg4, train=False)
    expected = {name: n_steps * n for name, n in per_step.items()}
    if steps is None:
        steps = lambda cfg, params: run_engine_steps(
            torch, cfg, params, device, n_steps,
            draw_requests(SERVE_SLOTS, cfg4.vocab_size, seed=1)).float()
    else:                                    # and one prefill
        expected = {name: n + launches_per_step(cfg4, False, prefill=True)[name]
                    for name, n in expected.items()}
    if control is not None:
        control_name, control_steps = control
        control_ctx = contextlib.nullcontext()
    elif any(kind in ("attn", "moe") for kind in cfg4.layer_pattern()) or cfg4.shared_attn_every:
        control_name, control_ctx = "newest_key_dropped", newest_key_dropped(torch)
        control_steps = steps
    else:
        control_name, control_ctx = "mlstm_C_update_skipped", mlstm_update_skipped(cfg4)
        control_steps = steps
    zero_counts()
    kern = steps(cfg4, params4)
    used = read_counts()
    with ops.use_plain():
        plain = steps(cfg4, params4)
        cfg32 = dataclasses.replace(cfg4, compute_dtype="float32", param_dtype="float32")
        ref = steps(cfg32, tree_map(lambda t: t.float() if t.is_floating_point() else t,
                                    params4))
        with control_ctx:
            control = control_steps(cfg4, params4)
    require(read_counts() == used, f"{phase}: use_plain() still launched a kernel")
    require(used == expected, f"{phase}: launches {used}, expected {expected}")
    err, ratio = errors(torch, kern, plain, "bfloat16")

    def against_ref(run):
        """Largest over the steps of (run's largest error against the fp32
        run) / (the bf16 plain run's)."""
        step_err = lambda x: (x - ref).abs().flatten(1).amax(1)
        return float((step_err(run) / step_err(plain).clamp_min(1e-6)).max())

    ref_ratio, control_ratio = against_ref(kern), against_ref(control)
    # Greedy tokens agree wherever the plain path's top-two gap is decisive.
    top2 = plain.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * (0.05 + 0.05 * top2[..., 0].abs())
    same = kern.argmax(-1) == plain.argmax(-1)
    emit(phase=phase, model=cfg4.name, layers=cfg4.n_layers, steps=n_steps, max_abs_err=err,
         err_over_tol=ratio, tol=TOL["bfloat16"], elementwise_required=elementwise,
         kernel_over_plain_error_vs_fp32=ref_ratio,
         plain_max_abs_err_vs_fp32=float((plain - ref).abs().max()),
         kernel_max_abs_err_vs_fp32=float((kern - ref).abs().max()),
         plain_err_over_tol_vs_fp32=errors(torch, plain, ref, "bfloat16")[1],
         kernel_err_over_tol_vs_fp32=errors(torch, kern, ref, "bfloat16")[1],
         fp32_margin=FP32_REF_MARGIN,
         **{"control_" + control_name: dict(
             over_plain_error_vs_fp32=control_ratio,
             times_the_allowance=control_ratio / FP32_REF_MARGIN,
             fails=control_ratio > FP32_REF_MARGIN)},
         decisive_positions=int(decisive.sum()), positions=int(decisive.numel()),
         tokens_equal=int(same.sum()), launches=used)
    require(not elementwise or ratio <= 1.0, f"{phase}: logits differ by {err}")
    require(ref_ratio <= FP32_REF_MARGIN,
            f"{phase}: the kernels' logits are {ref_ratio} times the plain run's error "
            "against fp32")
    require(control_ratio > FP32_REF_MARGIN, f"{phase}: the control ({control_name}) passed")
    require(bool((same | ~decisive).all()), f"{phase}: greedy tokens differ")


def _payload(state):
    """The tensors of an `export_slot` payload, by leaf path (every part:
    blocks, tail, and a hybrid's shared and tail_shared)."""
    from repro_torch._tree import tree_items
    return [(path, t) for path, t in tree_items(state) if path != "offset"]


def phase_migrate(torch, device, cfg4, params4, phase="migrate"):
    """Run to the end on one engine; run a twin to 4 generated tokens on a
    second, export its slot, import it into another slot of a third, finish
    there: same tokens, same slot state (every part of the payload), bit
    for bit."""
    from repro_torch.serve import Request, ServeEngine

    mk = lambda: ServeEngine(cfg4, params4, batch_slots=2, max_len=SERVE_MAX_LEN,
                             eos_id=-1, temperature=0.7, rng_seed=3, device=device)
    prompt = list(range(7, 31))
    ref_eng, ref = mk(), Request(5, prompt=list(prompt), max_new_tokens=16)
    ref_eng.submit(ref)
    ref_eng.run_until_done(500)

    src, mig = mk(), Request(5, prompt=list(prompt), max_new_tokens=16)
    src.submit(mig)
    while len(mig.output) < 4:
        src.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = src.export_slot(0)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    frozen = [t.clone() for _, t in _payload(state)]
    src.step()                                    # the source moves on ...
    require(all(torch.equal(a, b) for a, (_, b) in zip(frozen, _payload(state))),
            f"{phase}: the exported payload changed when the source stepped on")
    mig.output = mig.output[:4]                   # ... but its 5th token is not ours
    mig.done = False

    dst = mk()
    t0 = time.perf_counter()
    dst.import_slot(1, state)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    dst.slots[1] = mig
    dst.run_until_done(500)
    require(mig.done and mig.output == ref.output,
            f"{phase}: outputs differ: {mig.output} vs {ref.output}")
    got, want = dst.export_slot(1), ref_eng.export_slot(0)
    require(got["offset"] == want["offset"], f"{phase}: offsets differ")
    got, want = _payload(got), _payload(want)
    require([p for p, _ in got] == [p for p, _ in want], f"{phase}: payload trees differ")
    for (path, a), (_, b) in zip(got, want):
        require(torch.equal(a, b), f"{phase}: slot states differ at {path}")
    parts = {}
    for path, t in _payload(state):
        part = path.split(".")[0]
        parts[part] = parts.get(part, 0) + t.numel() * t.element_size()
    emit(phase=phase, model=cfg4.name, layers=cfg4.n_layers, tokens=ref.output,
         payload_bytes=sum(parts.values()), payload_bytes_by_part=parts,
         full_size_slot_bytes={name: slot_bytes(name) for name in (cfg4.name, "granite-3-2b")},
         export_seconds=export_s, import_seconds=import_s, outputs_equal=True,
         slot_state_bit_equal=True, leaves_compared=len(got))


def slot_bytes(name):
    """One slot's payload bytes of the named config at full size and
    `SERVE_MAX_LEN` positions, from its cache's shapes."""
    from repro_torch._tree import tree_items
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache
    cache = init_cache(get_config(name), 1, SERVE_MAX_LEN, device="meta")
    return sum(t.numel() * t.element_size() for path, t in tree_items(cache) if path != "index")


# ------------------------------------------------------------- relocation --
class _Stop(Exception):
    pass


def _rates(stats, payload):
    """Each stage's seconds and GB/s (the payload's bytes, or the file's for
    reading and writing, over the stage's seconds)."""
    out = {}
    for key, value in stats.items():
        if key.endswith("bytes") or key == "seconds":
            continue
        nbytes = stats.get("file_bytes", payload) if key in ("read", "write") else payload
        out[key] = dict(seconds=value, gb_per_s=nbytes / value / 1e9 if value else None)
    return out


def phase_relocate_train(torch, device, cfg, phase="relocate_train"):
    """A training job moved through a checkpoint.  An uninterrupted run
    gives the losses to follow.  The job saves after step RELOCATE_EVERY
    (its host snapshot is kept here) and is stopped after step
    RELOCATE_STOP; it is dropped and the card's cache emptied.  A fresh
    `Trainer` on the same directory resumes: (a) every restored leaf equals
    the snapshot, the int32 step counters included; (b) its first step's
    loss equals the stopped job's loss of that step (same state, same
    batch) bit for bit; (c) its later losses equal the uninterrupted run's
    bit for bit where the job's own steps did (the step is then
    deterministic), else lie within that spread.  Control: the checkpoint
    of another step (the resumed job's final one) must fail (b)."""
    import shutil
    from repro_torch._tree import tree_items
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.train import TrainerConfig, make_synthetic_trainer

    root = Path(__file__).resolve().parent / "build" / phase
    shutil.rmtree(root, ignore_errors=True)
    base = dict(steps=RELOCATE_STEPS, log_every=10 ** 9, loss_chunk=TRAIN_LOSS_CHUNK)
    jobcfg = TrainerConfig(ckpt_every=RELOCATE_EVERY, ckpt_dir=str(root), **base)
    make = lambda tcfg, **kw: make_synthetic_trainer(cfg, tcfg, TRAIN_BATCH, TRAIN_SEQ,
                                                     device=device, **kw)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def stop(tr, step, state, rec):
        if step == RELOCATE_STOP:
            raise _Stop

    try:
        straight = make(TrainerConfig(**base))
        straight.run()
        want = [r["loss"] for r in straight.metrics_log]
        del straight
        free()

        job = make(jobcfg, step_hooks=[stop])
        kept = {}
        snapshot = job.ckpt.snapshot
        job.ckpt.snapshot = lambda tree: kept.setdefault("tree", snapshot(tree))
        stopped = False
        try:
            job.run()
        except _Stop:
            stopped = True
        job.ckpt.wait()
        require(stopped, f"{phase}: the job was not stopped")
        ran = [r["loss"] for r in job.metrics_log]
        pause_s, save = job.ckpt.last_snapshot_s, job.ckpt.last_save
        path = ck.latest_checkpoint(str(root))
        require(path is not None and path.endswith(f"step_{RELOCATE_EVERY:08d}"),
                f"{phase}: the job's checkpoint is {path}")
        payload, shards = ck.checkpoint_nbytes(path)
        files = sorted(Path(path).iterdir())
        disk = sum(f.stat().st_size for f in files)
        codec = json.loads((Path(path) / "manifest.json").read_text())["codec"]
        del job
        free()

        moved = make(jobcfg)
        t0 = time.perf_counter()
        state, start = moved.init_or_restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore = moved.ckpt.last_restore
        require(start == RELOCATE_EVERY + 1, f"{phase}: resumed at step {start}")
        mine, theirs = list(tree_items(state)), list(tree_items(kept.pop("tree")))
        require([p for p, _ in mine] == [p for p, _ in theirs], f"{phase}: leaf paths differ")
        for (p, a), (_, b) in zip(mine, theirs):
            require(a.device.type == "cuda" and a.dtype == b.dtype
                    and torch.equal(a.cpu(), b), f"{phase}: (a) leaf {p} differs")
        counters = [p for p, t in mine if t.dtype == torch.int32]
        elastic = resume_elastic(torch, phase, cfg, root, moved, theirs, ran[RELOCATE_EVERY + 1])
        live, live_launches = live_move(torch, phase, cfg, root, moved, theirs,
                                        ran[RELOCATE_EVERY + 1])
        del theirs
        free()
        zero_counts()
        moved.run(state=state, start_step=start)
        torch.cuda.synchronize()
        launches = read_counts()
        after = {r["step"]: r["loss"] for r in moved.metrics_log}
        final_save = moved.ckpt.last_save
        del moved, state
        free()
        check_counts(phase, launches, launches_per_step(cfg, train=True),
                     RELOCATE_STEPS - start)

        # (b): the first resumed step against the stopped job's same step.
        first = RELOCATE_EVERY + 1
        require(after[first] == ran[first],
                f"{phase}: (b) step {first} loss {after[first]!r} != {ran[first]!r}")
        # (c): later steps against the uninterrupted run.
        spread = max(abs(a - b) for a, b in zip(ran, want))
        deterministic = spread == 0.0
        later = {s: abs(after[s] - want[s]) for s in after if s > first}
        require(all(d <= spread for d in later.values()),
                f"{phase}: (c) later losses {later} beyond the spread {spread}")

        # Control: the resumed job's final checkpoint (after step
        # RELOCATE_STEPS - 1) restored, and step `first`'s batch run from it.
        ctl = make(jobcfg)
        cstate, cstart = ctl.init_or_restore()
        batch = {k: torch.as_tensor(v).to(device) for k, v in ctl.data.batch_at(first).items()}
        _, metrics = ctl._step(cstate, batch)
        control_loss = float(metrics["loss"])
        control_restore = ctl.ckpt.last_restore
        del ctl, cstate, batch, metrics
        free()
        require(cstart == RELOCATE_STEPS and control_loss != ran[first],
                f"{phase}: the control (checkpoint of step {cstart}) passed (b)")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    sim_s = payload * 8.0 / 1e9 / SIM_HOST_GBPS + shards * SIM_PER_SHARD_S
    emit(phase=phase, model=cfg.name, layers=cfg.n_layers, optimizer=cfg.optimizer,
         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=RELOCATE_STEPS,
         checkpoint_step=RELOCATE_EVERY, stopped_after_step=RELOCATE_STOP,
         resumed_at_step=first, codec=codec, payload_bytes=payload, shard_files=shards,
         disk_bytes=disk, files=len(files), leaves=len(mine), int32_counters=counters,
         pause_seconds=pause_s, pause_gb_per_s=payload / pause_s / 1e9,
         save_seconds=save["seconds"], save_gb_per_s=payload / save["seconds"] / 1e9,
         save_stages=_rates(save, payload),
         restore_seconds=restore_s, restore_gb_per_s=payload / restore_s / 1e9,
         restore_stages=_rates(restore, payload),
         final_save_seconds=final_save["seconds"],
         control_restore_seconds=control_restore["seconds"],
         simulator=dict(host_gbps=SIM_HOST_GBPS, per_shard_s=SIM_PER_SHARD_S,
                        host_phase_seconds=sim_s,
                        save_over_simulated=save["seconds"] / sim_s,
                        restore_over_simulated=restore_s / sim_s),
         uninterrupted_losses=want, stopped_job_losses=ran, resumed_losses=after,
         a_leaves_bit_equal=True, b_first_loss_bit_equal=True,
         c_deterministic=deterministic, c_spread=spread, c_later_abs_diff=later,
         control=dict(checkpoint_step=cstart, loss=control_loss, fails_b=True),
         elastic=elastic, live_move=live, launches=launches)
    return launches, live_launches


def resume_elastic(torch, phase, cfg, root, moved, saved, want_loss):
    """The job's checkpoint resumed a second time, through
    `ElasticSupervisor.rescale` onto a (1, 1) NCCL mesh (`reshard_restore`
    into `state_specs`' placements): every leaf a DTensor equal to the
    saved one bit for bit, and the first resumed step's loss ``want_loss``
    bit for bit.  It writes no checkpoint."""
    from repro_torch._tree import tree_items
    from repro_torch.runtime.elastic import ElasticSupervisor, MeshPlan
    from repro_torch.train import Trainer, TrainerConfig
    from torch.distributed.tensor import DTensor

    one_rank_mesh(torch)
    sup = ElasticSupervisor(str(root), cfg, moved.optimizer, MeshPlan((1, 1), ("data", "model")))
    t0 = time.perf_counter()
    state, step, mesh, strat = sup.rescale(0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(step == RELOCATE_EVERY + 1 and tuple(mesh.shape) == (1, 1),
            f"{phase}: the rescale resumed at step {step} on {tuple(mesh.shape)}")
    for (p, a), (_, b) in zip(tree_items(state), saved):
        require(isinstance(a, DTensor) and a.to_local().is_cuda and a.dtype == b.dtype
                and torch.equal(a.full_tensor().cpu(), b),
                f"{phase}: the rescaled leaf {p} differs from the saved one")
    tcfg = TrainerConfig(steps=step + 1, log_every=10 ** 9, loss_chunk=TRAIN_LOSS_CHUNK)
    job = Trainer(cfg, tcfg, moved.data, mesh=mesh, strategy=strat, optimizer=moved.optimizer)
    job.run(state=state, start_step=step)
    loss = job.metrics_log[0]["loss"]
    require(loss == want_loss, f"{phase}: the rescaled job's step {step} loss {loss!r} != "
                               f"{want_loss!r}")
    del job, state
    return dict(mesh_shape=list(mesh.shape), resumed_at_step=step, restore_seconds=restore_s,
                leaves_bit_equal=True, first_loss=loss, first_loss_bit_equal=True,
                rescales=sup.rescales)


# The demo fleet of examples/reconfiguration_demo.py: pods (name, chips,
# $ a chip-hour, the reference's TPU figures), and the jobs admitted FCFS.
DEMO_PODS = (("tokyo-a", 256, 1.2), ("tokyo-b", 256, 1.2), ("osaka-spot", 256, 0.85),
             ("osaka-v5p", 256, 2.1))
DEMO_JOBS, DEMO_WINDOW, DEMO_RELEASED = 14, 24, (1, 2)


def demo_trial():
    """Steps 5 and 7 of the paper through the port's LP on the demo fleet:
    the jobs admitted FCFS by a `FleetScheduler`, jobs 1 and 2 released,
    then the reconfiguration trial over the most recent 24.  Returns the
    scheduler, the trial and the admissions."""
    import numpy as np
    from repro_torch.core.cluster import FleetScheduler, JobSpec, PodSpec, build_fleet_topology

    sched = FleetScheduler(build_fleet_topology([PodSpec(*p) for p in DEMO_PODS]),
                           reconfig_every=10 ** 9, window=DEMO_WINDOW)
    rng = np.random.default_rng(0)
    placed = []
    for i in range(DEMO_JOBS):
        fast = i % 3 == 0
        t = float(rng.uniform(0.8, 2.0))
        placed.append(sched.submit(JobSpec(
            job_id=i, arch="granite-3-2b", shape="train_4k", chips=64, step_time_s=t,
            step_slo_s=t + (0.1 if fast else 2.0), budget_usd_month=None if fast else 90_000.0)))
    for done in DEMO_RELEASED:
        sched.engine.release(done)
    return sched, sched.recon.plan(sched.engine.recent(DEMO_WINDOW)), placed


def live_move(torch, phase, cfg, root, moved, saved, want_loss):
    """One move chosen by the port's LP (`demo_trial`'s first), executed on
    the card through `fleet.elastic_bridge.LiveElasticBackend`: the job is
    registered with the phase's checkpoint directory and no live state, so
    `execute_move`'s snapshot takes the latest committed checkpoint; the
    restore rebuilds its (1, 1) plan over the one-rank NCCL group and
    `reshard_restore`s it (stop-and-copy; the transfer is priced over the
    move's links).  Every leaf a CUDA DTensor equal to the saved one bit
    for bit; the first resumed step's loss ``want_loss`` bit for bit, and
    its launches one train step's.  Control: a job whose directory holds
    no committed checkpoint cannot be snapshotted.  The measured phases
    stand beside `SimulatedElasticBackend`'s for the same request and
    checkpoint bytes.  Returns (the record, the resumed step's launches)."""
    import tempfile

    import scipy
    import scipy.optimize
    from repro_torch._tree import tree_items
    from repro_torch.ckpt import checkpoint_nbytes, latest_checkpoint
    from repro_torch.fleet.elastic_bridge import (LiveElasticBackend, SimulatedElasticBackend,
                                                  execute_move)
    from repro_torch.runtime.elastic import MeshPlan
    from repro_torch.train import Trainer, TrainerConfig
    from torch.distributed.tensor import DTensor

    t0 = time.perf_counter()
    sched, res, placed = demo_trial()
    lp_s = time.perf_counter() - t0
    require(res.n_moved > 0 and res.s_after <= res.s_before,
            f"{phase}: the LP's trial moved {res.n_moved} jobs, S {res.s_before} -> "
            f"{res.s_after}")
    mv = res.moves[0]
    req = sched.engine.placed[mv.req_id].request
    plan = MeshPlan((1, 1), ("data", "model"))
    one_rank_mesh(torch)
    backend = LiveElasticBackend()
    require(backend.name == "live", f"{phase}: the backend is {backend.name}")
    backend.register_job(mv.req_id, str(root), cfg, moved.optimizer, plan)
    path = latest_checkpoint(str(root))
    t0 = time.perf_counter()
    phases = execute_move(backend, req, mv)
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t0
    resumed = backend.resumed[mv.req_id]
    require(resumed.plan.shape == (1, 1) and tuple(resumed.mesh.shape) == (1, 1)
            and resumed.step == RELOCATE_EVERY + 1,
            f"{phase}: the live move resumed at step {resumed.step} on {resumed.plan.shape}")
    mine = list(tree_items(resumed.state))
    require([p for p, _ in mine] == [p for p, _ in saved], f"{phase}: the live move's leaves")
    for (p, a), (_, b) in zip(mine, saved):
        require(isinstance(a, DTensor) and a.to_local().is_cuda and a.dtype == b.dtype
                and torch.equal(a.full_tensor().cpu(), b),
                f"{phase}: the live move's leaf {p} differs from the saved one")
    tcfg = TrainerConfig(steps=resumed.step + 1, log_every=10 ** 9, loss_chunk=TRAIN_LOSS_CHUNK)
    job = Trainer(cfg, tcfg, moved.data, mesh=resumed.mesh, strategy=resumed.strategy,
                  optimizer=moved.optimizer)
    zero_counts()
    job.run(state=resumed.state, start_step=resumed.step)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts(f"{phase}: the live move's step", launches, launches_per_step(cfg, train=True),
                 1)
    loss = job.metrics_log[0]["loss"]
    require(loss == want_loss, f"{phase}: the live move's step {resumed.step} loss {loss!r} != "
                               f"{want_loss!r}")
    del job, resumed, mine
    backend.release(mv.req_id)

    with tempfile.TemporaryDirectory(dir=root.parent) as empty:
        backend.register_job(-1, empty, cfg, moved.optimizer, plan)
        try:
            backend.snapshot(dataclasses.replace(req, req_id=-1), mv, 0.0)
            refused = False
        except FileNotFoundError:
            refused = True
    require(refused, f"{phase}: a job with no committed checkpoint was snapshotted")

    payload, shards = checkpoint_nbytes(path)
    sim = SimulatedElasticBackend()
    sim.attach_job(mv.req_id, state_bytes=payload)
    predicted = sim.predict_phases(req, mv)
    simulated = execute_move(sim, req, mv)
    record = dict(
        lp=dict(s_before=res.s_before, s_after=res.s_after, gain=res.gain, n_moved=res.n_moved,
                moves=[dict(job=m.req_id, source=m.old.node.site_id,
                            destination=m.new.node.site_id, ratio=m.ratio) for m in res.moves],
                admitted=placed, solver=res.solver.status if res.solver else None,
                seconds=lp_s, scipy=scipy.__version__,
                scipy_milp=hasattr(scipy.optimize, "milp")),
        moved_job=mv.req_id, source=mv.old.node.site_id, destination=mv.new.node.site_id,
        checkpoint=Path(path).name, payload_bytes=payload, shard_files=shards,
        measured=dataclasses.asdict(phases), execute_seconds=move_s,
        simulated=dataclasses.asdict(simulated),
        predicted=dict(mbits=predicted[0], snapshot_s=predicted[1], restore_s=predicted[2]),
        restore_over_simulated=phases.restore_s / simulated.restore_s,
        mesh_shape=[1, 1], resumed_at_step=RELOCATE_EVERY + 1, leaves_bit_equal=True,
        first_loss=loss, first_loss_bit_equal=True, launches=launches,
        control=dict(no_checkpoint_refused=True))
    emit(phase="live_move", **record)
    return record, launches


# -------------------------------------------------------------------- MoE --
def record_routes():
    """Wrap the MoE router so that each call's router probabilities and
    top-k expert ids are kept; returns (the list the (probs, ids) pairs go
    to, a function that unwraps)."""
    from repro_torch.models import moe
    inner, seen = moe.router_probs, []

    def router_probs(params, x_flat, cfg):
        out = inner(params, x_flat, cfg)
        seen.append((out[1].clone(), out[3].clone()))
        return out

    moe.router_probs = router_probs
    return seen, lambda: setattr(moe, "router_probs", inner)


# The most two chosen experts' router probabilities may lie apart on the
# plain path where the kernel path takes them in the other order.  A swap by
# itself puts their gap within twice the paths' largest probability
# difference at that token, so a margin relative to that difference could
# not fail; this one is absolute, and under the noise measured on an H100:
# the paths' router probabilities differ by up to 0.00138 over the phase
# (`router_probs_max_diff`), and the one swap seen there has a gap of 0.000401.
REORDER_MARGIN = 1e-3


def phase_path_vs_plain_moe(torch, device, cfg, params, phase):
    """16 decode steps of an MoE cut's engine (8 slots); at each, the step is
    run from the same cache on the kernels, under `use_plain()`, and under
    `use_plain()` with the newest key of every decode attention dropped (the
    control), before the engine steps on.  At every step the two paths
    must choose the same experts (every layer's top-k ids equal as a set
    for every token: their order within a token changes no dispatch, only
    the order in which the combine adds the token's k outputs, and two
    chosen experts swap places wherever their probabilities lie closer than
    the paths' bf16 noise).  Each such swap must be a near-tie: the two
    experts' probabilities on the plain path at most `REORDER_MARGIN` apart.
    The kernels' logits are held to the plain ones elementwise (bf16 `TOL`)
    and their greedy tokens where decisive.  The control must fail the
    elementwise check."""
    from repro_torch._tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    n_steps = 16
    engine = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                         eos_id=-1, device=device)
    for r in draw_requests(SERVE_SLOTS, cfg.vocab_size, seed=1):
        engine.submit(r)
    for _ in range(4):
        engine.step()
    routes, unwrap = record_routes()
    used = {name: 0 for name in kernel_wrappers()}
    worst = control_worst = 0.0
    tokens_equal, decisive_n, positions, reordered = 0, 0, 0, []
    probs_max_diff = 0.0
    try:
        for step in range(n_steps):
            tokens = torch.from_numpy(engine._slot_tokens()).to(device)

            def run():
                routes.clear()
                cache = tree_map(lambda t: t.clone(), engine.cache)
                _, logits = engine._decode(params, cache, tokens)
                return logits[:, 0].float(), list(routes)

            zero_counts()
            kern, kern_routes = run()
            torch.cuda.synchronize()
            for name, n in read_counts().items():
                used[name] += n
            with ops.use_plain():
                plain, plain_routes = run()
                with newest_key_dropped(torch):
                    control, _ = run()
            rerouted = [layer for layer, ((_, a), (_, b)) in enumerate(zip(kern_routes, plain_routes))
                        if not torch.equal(a.sort(-1).values, b.sort(-1).values)]
            # Same experts in another order: the experts out of place (in the
            # plain path's order) and the spread of their plain-path
            # probabilities, beside how far the paths' probabilities differ.
            for layer, ((pa, a), (pb, b)) in enumerate(zip(kern_routes, plain_routes)):
                probs_max_diff = max(probs_max_diff, float((pa - pb).abs().max()))
                for tok in (a != b).any(-1).nonzero().flatten().tolist():
                    moved = b[tok][a[tok] != b[tok]]
                    p = pb[tok, moved]
                    reordered.append(dict(
                        step=step, layer=layer, token=tok, experts=moved.tolist(),
                        plain_gap=float(p.max() - p.min()),
                        paths_max_diff=float((pa[tok] - pb[tok]).abs().max())))
            require(len(kern_routes) == len(plain_routes) == cfg.n_layers and not rerouted,
                    f"{phase}: step {step} routed differently on the two paths "
                    f"(layers {rerouted})")
            wide = [r for r in reordered if r["step"] == step and r["plain_gap"] > REORDER_MARGIN]
            require(not wide, f"{phase}: step {step} took experts in another order where "
                              f"they are no near-tie (margin {REORDER_MARGIN}): {wide}")
            worst = max(worst, errors(torch, kern, plain, "bfloat16")[1])
            control_worst = max(control_worst, errors(torch, control, plain, "bfloat16")[1])
            top2 = plain.topk(2, dim=-1).values
            decisive = (top2[:, 0] - top2[:, 1]) > 2 * (0.05 + 0.05 * top2[:, 0].abs())
            same = kern.argmax(-1) == plain.argmax(-1)
            require(bool((same | ~decisive).all()), f"{phase}: greedy tokens differ")
            tokens_equal += int(same.sum())
            decisive_n += int(decisive.sum())
            positions += int(same.numel())
            engine.step()
    finally:
        unwrap()
    check_counts(phase, used, launches_per_step(cfg, train=False), n_steps)
    emit(phase=phase, model=cfg.name, layers=cfg.n_layers, steps=n_steps, err_over_tol=worst,
         tol=TOL["bfloat16"], control_newest_key_dropped=dict(err_over_tol=control_worst,
                                                                fails=control_worst > 1.0),
         decisive_positions=decisive_n, positions=positions, tokens_equal=tokens_equal,
         same_experts_in_another_order=reordered, reorder_margin=REORDER_MARGIN,
         router_probs_max_diff=probs_max_diff, launches=used)
    require(worst <= 1.0, f"{phase}: logits differ by {worst} of the allowance")
    require(control_worst > 1.0, f"{phase}: the control with a key dropped passed")
    del engine


def phase_migrate_moe(torch, device, cfg, params, phase):
    """An MoE engine's two slots moved together: run two requests to the end
    on one engine; run twins to 4 generated tokens on a second, export both
    slots, import each into the same slot of a third, finish there: same
    tokens, same slot states, bit for bit (the neighbours, whose tokens
    share the experts' capacity in a decode step, are the same).  Then the
    first request's slot alone into another slot beside another request:
    there capacity drops may differ, and the first token where its
    continuation leaves the reference's is printed, not held."""
    from repro_torch.serve import Request, ServeEngine

    mk = lambda: ServeEngine(cfg, params, batch_slots=2, max_len=SERVE_MAX_LEN, eos_id=-1,
                             temperature=0.7, rng_seed=3, device=device)
    prompts = [list(range(7, 31)), list(range(40, 57))]
    reqs = lambda: [Request(5 + i, prompt=list(p), max_new_tokens=16)
                    for i, p in enumerate(prompts)]
    ref_eng, ref = mk(), reqs()
    for r in ref:
        ref_eng.submit(r)
    ref_eng.run_until_done(500)

    src, moved = mk(), reqs()
    for r in moved:
        src.submit(r)
    while len(moved[0].output) < 4:
        src.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = [src.export_slot(slot) for slot in (0, 1)]
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    outputs = [list(r.output) for r in moved]
    frozen = [[t.clone() for _, t in _payload(st)] for st in states]
    src.step()                                    # the source moves on
    require(all(torch.equal(a, b) for fr, st in zip(frozen, states)
                for a, (_, b) in zip(fr, _payload(st))),
            f"{phase}: an exported payload changed when the source stepped on")
    for r, out in zip(moved, outputs):
        r.output, r.done = list(out), False

    dst = mk()
    t0 = time.perf_counter()
    for slot, st in enumerate(states):
        dst.import_slot(slot, st)
        dst.slots[slot] = moved[slot]
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    dst.run_until_done(500)
    for slot, (got, want) in enumerate(zip(moved, ref)):
        require(got.done and got.output == want.output,
                f"{phase}: slot {slot} outputs differ: {got.output} vs {want.output}")
        a, b = dst.export_slot(slot), ref_eng.export_slot(slot)
        require(a["offset"] == b["offset"], f"{phase}: offsets differ")
        for (path, x), (_, y) in zip(_payload(a), _payload(b)):
            require(torch.equal(x, y), f"{phase}: slot {slot} states differ at {path}")

    other = mk()
    lone = Request(5, prompt=list(prompts[0]), max_new_tokens=16)
    lone.output = list(outputs[0])
    other.import_slot(1, states[0])
    other.slots[1] = lone
    other.submit(Request(9, prompt=list(range(60, 80)), max_new_tokens=16))
    other.run_until_done(500)
    diverged = next((i for i, (a, b) in enumerate(zip(lone.output, ref[0].output)) if a != b),
                    None)
    emit(phase=phase, model=cfg.name, layers=cfg.n_layers, tokens=[r.output for r in ref],
         payload_bytes=sum(t.numel() * t.element_size() for st in states
                           for _, t in _payload(st)),
         export_seconds=export_s, import_seconds=import_s, outputs_equal=True,
         slot_states_bit_equal=True, capacity_per_expert_at_two_slots=_capacity(cfg, 2),
         other_neighbour=dict(tokens=lone.output, first_divergent_token=diverged))


def _capacity(cfg, n_tokens):
    from repro_torch.models.moe import capacity
    return capacity(n_tokens, cfg)


# ------------------------------------------------------------------ main --
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", help="comma-separated phases of " + ",".join(PHASES))
    ap.add_argument("--verbose-build", action="store_true")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    unknown = sorted(set(only) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    run = lambda p: p in PHASES and (not only or p in only)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here if the package is missing)
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi_line = phase_device(torch)
    granite, zamba = get_config("granite-3-2b"), get_config("zamba2-7b")
    dbrx, xlstm = get_config("dbrx-132b"), get_config("xlstm-1.3b")
    seamless, qwen = get_config("seamless-m4t-large-v2"), get_config("qwen2-vl-2b")

    def cut(cfg, n):
        """``cfg``'s first ``n`` layers (and its layer pattern's), and as many
        of an encoder-decoder's encoder layers."""
        pattern = cfg.block_pattern and cfg.block_pattern[:n]
        return dataclasses.replace(cfg, n_layers=n, block_pattern=pattern,
                                   n_encoder_layers=min(cfg.n_encoder_layers, n))

    # Each path's launches, read just after it ran with every count at 0.
    paths = {"serve": (granite, False), "train": (granite, True),
             "sharded_train": (granite, True),
             "serve_zamba2": (zamba, False),
             "train_zamba2": (cut(zamba, ZAMBA_TRAIN_LAYERS), True),
             "serve_dbrx": (cut(dbrx, DBRX_SERVE_LAYERS), False),
             "train_dbrx": (cut(dbrx, DBRX_TRAIN_LAYERS), True),
             "serve_xlstm": (xlstm, False),
             "train_xlstm": (cut(xlstm, XLSTM_TRAIN_LAYERS), True),
             "serve_seamless": (seamless, False), "train_seamless": (seamless, True),
             "serve_qwen2vl": (qwen, False), "train_qwen2vl": (qwen, True),
             "relocate_train": (cut(granite, RELOCATE_LAYERS), True),
             "live_move": (cut(granite, RELOCATE_LAYERS), True),
             "adapt_train": (granite, True), "adapt_decode": (granite, False)}
    launches = {path: {} for path in paths}
    seconds = {}
    controller = None
    controller_out = Path(__file__).resolve().parent / "build" / "adapt_controller.json"

    def timed(name, fn, *a, **kw):
        """Runs one phase and prints its seconds as it ends."""
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[name] = time.perf_counter() - t0
        emit(phase_seconds=name, seconds=seconds[name],
             since_start=time.perf_counter() - t_start)
        return out

    try:
        for path, (cfg, train) in paths.items():
            require(launches_per_step(cfg, train) == MAIN_PATH_COUNTS[path],
                    f"{path}: launches a step {launches_per_step(cfg, train)}, "
                    f"expected {MAIN_PATH_COUNTS[path]}")
        require(launches_per_step(seamless, False, prefill=True)
                == MAIN_PATH_COUNTS["serve_seamless_prefill"],
                f"serve_seamless: the prefill's launches "
                f"{launches_per_step(seamless, False, prefill=True)}")
        resources = {}
        if run("adapt"):           # host-side: runs beside the card's phases
            controller_out.parent.mkdir(parents=True, exist_ok=True)
            controller = start_controller(controller_out)
        if run("build"):
            resources = timed("build", phase_build, args.verbose_build)
        if run("kernels"):
            timed("kernels", phase_kernels, torch, device)
        if run("adapt"):           # before the phases that trace much with the profiler
            launches.update(timed("adapt", phase_adapt, torch, device, granite, controller,
                                  controller_out, smi_line))
        if run("serve"):
            launches["serve"] = timed("serve", phase_serve, torch, device, granite, 24)
        if run("train"):
            launches["train"] = timed("train", phase_train, torch, device, granite, TRAIN_STEPS)
        if run("sharded_train"):
            launches["sharded_train"] = timed("sharded_train", phase_sharded_train, torch,
                                              device, granite)
        if run("serve_zamba2"):
            launches["serve_zamba2"] = timed("serve_zamba2", phase_serve, torch, device, zamba,
                                             ZAMBA_REQUESTS, "serve_zamba2")
        if run("train_zamba2"):
            launches["train_zamba2"] = timed("train_zamba2", phase_train, torch, device,
                                             paths["train_zamba2"][0], ZAMBA_TRAIN_STEPS,
                                             "train_zamba2")
        if run("serve_dbrx"):
            launches["serve_dbrx"] = timed("serve_dbrx", phase_serve, torch, device,
                                           paths["serve_dbrx"][0], DBRX_REQUESTS, "serve_dbrx")
        if run("train_dbrx"):
            launches["train_dbrx"] = timed("train_dbrx", phase_train, torch, device,
                                           paths["train_dbrx"][0], DBRX_TRAIN_STEPS,
                                           "train_dbrx")
        if run("serve_xlstm"):
            launches["serve_xlstm"] = timed("serve_xlstm", phase_serve, torch, device, xlstm,
                                            XLSTM_REQUESTS, "serve_xlstm")
        if run("slstm_layer"):
            timed("slstm_layer", phase_slstm_layer, torch, device, xlstm)
        if run("train_xlstm"):
            launches["train_xlstm"] = timed("train_xlstm", phase_train, torch, device,
                                            paths["train_xlstm"][0], XLSTM_TRAIN_STEPS,
                                            "train_xlstm")
        if run("serve_seamless"):
            launches["serve_seamless"] = timed("serve_seamless", phase_serve_encdec, torch,
                                               device, seamless)
        if run("train_seamless"):
            launches["train_seamless"] = timed(
                "train_seamless", phase_train, torch, device, seamless, SEAMLESS_TRAIN_STEPS,
                "train_seamless", data=StubLM(seamless, TRAIN_SEQ, 0,
                                              frames=SEAMLESS_TRAIN_FRAMES))
        if run("serve_qwen2vl"):
            launches["serve_qwen2vl"] = timed("serve_qwen2vl", phase_serve, torch, device, qwen,
                                              QWEN_REQUESTS, "serve_qwen2vl")
        if run("train_qwen2vl"):
            launches["train_qwen2vl"] = timed(
                "train_qwen2vl", phase_train, torch, device, qwen, QWEN_TRAIN_STEPS,
                "train_qwen2vl", data=StubLM(qwen, TRAIN_SEQ, 0, patches=QWEN_PATCHES),
                loss_chunk=QWEN_LOSS_CHUNK)
        if run("relocate_train"):
            launches["relocate_train"], launches["live_move"] = timed(
                "relocate_train", phase_relocate_train, torch, device,
                paths["relocate_train"][0])
        if run("timing"):
            kernels = timed("timing", phase_timing, torch, device, launches, resources)
            emit(phase="timing", kernels=kernels)
            if not only:
                for path, (cfg, train) in paths.items():
                    for name, n in launches_per_step(cfg, train).items():
                        require(n == 0 or launches[path][name] > 0,
                                f"{name} was not launched by the {path} path")
        cuts = [("", cut(granite, CUT_LAYERS)), ("_zamba2", cut(zamba, ZAMBA_CUT_LAYERS)),
                ("_dbrx", cut(dbrx, DBRX_CUT_LAYERS)), ("_xlstm", cut(xlstm, XLSTM_CUT_LAYERS)),
                ("_seamless", cut(seamless, CUT_LAYERS)), ("_qwen2vl", cut(qwen, CUT_LAYERS))]
        # The stub inputs of the prefilled cuts' train_vs_plain.
        train_stubs = {"_seamless": dict(frames=SEAMLESS_CUT_FRAMES),
                       "_qwen2vl": dict(patches=QWEN_PATCHES)}
        for suffix, cfg in cuts:
            recurrent, moe = carries_state(cfg), "moe" in cfg.layer_pattern()
            if run("path_vs_plain" + suffix) or run("migrate" + suffix):
                params = build_model(torch, cfg, device)
                if run("path_vs_plain" + suffix):
                    if moe:
                        timed("path_vs_plain" + suffix, phase_path_vs_plain_moe, torch, device,
                              cfg, params, "path_vs_plain" + suffix)
                    else:
                        steps, control = (prefilled_runs(torch, cfg, device)
                                          if suffix in train_stubs else (None, None))
                        timed("path_vs_plain" + suffix, phase_path_vs_plain, torch, device,
                              cfg, params, "path_vs_plain" + suffix, elementwise=not recurrent,
                              steps=steps, control=control)
                if run("migrate" + suffix):
                    timed("migrate" + suffix, phase_migrate_moe if moe else phase_migrate,
                          torch, device, cfg, params, "migrate" + suffix)
                del params
                torch.cuda.empty_cache()
            noisy = bf16_gradients_are_noise(cfg)
            if not moe and noisy and run("train_vs_fp32" + suffix):
                timed("train_vs_fp32" + suffix, phase_train_vs_fp32, torch, device, cfg,
                      "train_vs_fp32" + suffix, at_fp32_points=suffix in FP32_POINTS_CUTS,
                      **train_stubs.get(suffix, {}))
            if not moe and run("train_vs_plain" + suffix):
                if noisy:
                    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                              param_dtype="float32")
                timed("train_vs_plain" + suffix, phase_train_vs_plain, torch, device, cfg,
                      "train_vs_plain" + suffix, **train_stubs.get(suffix, {}))
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        close_mesh()
        if controller is not None and controller.poll() is None:
            controller.kill()
            controller.wait()
    print(smi_line, flush=True)
    emit(phase="done", seconds=time.perf_counter() - t_start, phases=only or list(PHASES),
         phase_seconds=seconds)
    if run("timing"):
        emit(kernels=kernels)
    if only:
        return 0
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
