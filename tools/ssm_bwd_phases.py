#!/usr/bin/env python3
"""Where the bf16 gradient of the Mamba2 scan spends its time, on the card.

    python3 tools/ssm_bwd_phases.py [ROOT] [--stamps DESIGN]   # one CUDA device, ~60 s

ROOT is the checkout whose ``src/repro_torch`` is measured (default: this
one), so two commits can be read side by side on one card; DESIGN names
the set of stamps that fits its ``csrc/ssm_scan_bwd.cu``: ``segment`` (the
default: the chains keep the states two chunks apart, the chunk pass
recomputes a chunk's from them, two warpgroups a chunk block) or
``per-chunk`` (the earlier kernels: the chains write every chunk's start
state and end gradient, one warpgroup a chunk block).

Builds a copy of that source with ``clock64`` stamps at named points of
`ssm_bwd_state_wgmma_kernel` (each block's first thread) and
`ssm_bwd_chunk_wgmma_kernel` (the first thread of the warpgroup that takes
the head), calls it through the checkout's own wrapper (`ssm_scan_bwd`,
its library swapped for the stamped one) at zamba2-7b's training shape
(`chip_smoke.SSM_TRAIN`, x, B and C strided as `mamba2_block` hands them,
no final-state gradient), checks that it gives the unstamped kernels' bits,
and prints for each pass:

* the chains: each phase's median cycles a block (setup with the tiles'
  wait, sweep 1, the look-back's wait, the publish and the writes);
* the chunk pass: each phase's median cycles a head (the wait for the
  head's tiles and states, each product group until its wait returns, the
  elementwise phases between them, cum's reverse sum, the gap to the next
  head), the block's prologue and epilogue;
* each SM's busy cycles (the sum of its blocks') and span, the busiest SM
  against the median SM.

Beside them, both builds' device ms a call (three readings in turns,
`chip_smoke.repeated`, the SM clock beside each; the stamps' own cost is
the difference), registers and spills.  A stamp anchors on the source's
text: the script fails if an anchor is not found exactly once in its
kernel's text.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

BLOCKS = 8192          # blocks a stamp array holds, for each pass
HEADS = 16             # heads a chunk block stamps
STEPS = 16             # stamps a head
MARKS = 8              # stamps of a block's prologue
SLOT = 4 + MARKS + STEPS * HEADS   # smid, start, end, heads; the prologue's; then the heads'
HEAD = f"""
__device__ unsigned long long stamp_chain[{BLOCKS} * {SLOT}];
__device__ unsigned long long stamp_chunk[{BLOCKS} * {SLOT}];
extern "C" int stamp_copy(void* a, void* b, int n) {{
  int e = (int)cudaMemcpyFromSymbol(a, stamp_chain, n);
  return e ? e : (int)cudaMemcpyFromSymbol(b, stamp_chunk, n);
}}
extern "C" int stamp_clear() {{
  void* p = nullptr;
  int e = (int)cudaGetSymbolAddress(&p, stamp_chain);
  if (!e) e = (int)cudaMemset(p, 0, sizeof(stamp_chain));
  if (!e) e = (int)cudaGetSymbolAddress(&p, stamp_chunk);
  return e ? e : (int)cudaMemset(p, 0, sizeof(stamp_chunk));
}}
#define SB_SLOT(a) (a + (size_t)blockIdx.x * {SLOT})
#define SB_START(a, who) if (threadIdx.x == (who) && blockIdx.x < {BLOCKS}) {{ unsigned sm_; \\
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_)); \\
    SB_SLOT(a)[0] = sm_; SB_SLOT(a)[1] = clock64(); }}
#define SB_END(a, who, n) if (threadIdx.x == (who) && blockIdx.x < {BLOCKS}) {{ \\
    SB_SLOT(a)[2] = clock64(); SB_SLOT(a)[3] = (n); }}
#define SB_MARK(a, who, m) if (threadIdx.x == (who) && blockIdx.x < {BLOCKS}) \\
    SB_SLOT(a)[4 + (m)] = clock64()
#define SB_AT(a, who, h, k) if (threadIdx.x == (who) && (h) < {HEADS} && blockIdx.x < {BLOCKS}) \\
    SB_SLOT(a)[4 + {MARKS} + {STEPS} * (h) + (k)] = clock64()
"""
# Each kernel's text runs from its first anchor to its second.
REGIONS = {
    "per-chunk": {"chain": ("void chain_body(", "ssm_bwd_state_kernel(const"),
                  "chunk": ("void chunk_body(", "ssm_bwd_chunk_kernel(const")},
    "segment": {"chain": ("void chain_body(", "ssm_bwd_state_kernel(const"),
                "chunk": ("void chunk_consumer(", "ssm_bwd_chunk_kernel(const")},
}
# Per design and kernel: (anchor, text inserted before it, text inserted
# after it).  The chains stamp head slot 0; the chunk pass head hh.
STAMPS = {
    "per-chunk": {
        "chain": [
            ("  const int role = blockIdx.x & 1;", "  SB_START(stamp_chain, 0);\n", ""),
            ("  // Sweep 1: the segment's own state", "  SB_AT(stamp_chain, 0, 0, 0);\n", ""),
            ("  // The look-back: the neighbour's", "  SB_AT(stamp_chain, 0, 0, 1);\n", ""),
            ("  if (pos + 1 < n_seg) {\n", "  SB_AT(stamp_chain, 0, 0, 2);\n", ""),
            ("  // Sweep 2: each chunk's tile", "  SB_AT(stamp_chain, 0, 0, 3);\n", ""),
            ("  // The call's last block leaves the counters zero",
             "  SB_AT(stamp_chain, 0, 0, 4);\n", ""),
            ("      for (int e = 0; e < 3 + 2 * BH; ++e) g.sync[e] = 0;\n      __threadfence();\n"
             "    }\n  }\n", "", "  SB_END(stamp_chain, 0, 1);\n"),
        ],
        "chunk": [
            ("  const int tid = threadIdx.x;\n", "", "  SB_START(stamp_chunk, 0);\n"),
            ("    issue(hh + 1);\n", "", "    SB_AT(stamp_chunk, 0, hh, 0);\n"),
            ("    // C B^T and dy x^T, then the weighted", "    SB_AT(stamp_chunk, 0, hh, 1);\n", ""),
            ("      repro::fence_regs(gm);\n      repro::fence_regs(mm);\n    }\n", "",
             "    SB_AT(stamp_chunk, 0, hh, 2);\n"),
            ("    // dy S (dC's state term)", "    SB_AT(stamp_chunk, 0, hh, 3);\n", ""),
            ("      repro::fence_regs(dc);\n      repro::fence_regs(db);\n    }\n", "",
             "    SB_AT(stamp_chunk, 0, hh, 4);\n"),
            ("    // B G^T (dx's state term) and x G", "    SB_AT(stamp_chunk, 0, hh, 5);\n", ""),
            ("      repro::fence_regs(vx);\n      repro::fence_regs(yy);\n    }\n", "",
             "    SB_AT(stamp_chunk, 0, hh, 6);\n"),
            ("    // dx = Wg^T dy + wl (B G^T) + D dy.", "    SB_AT(stamp_chunk, 0, hh, 7);\n", ""),
            ("      OutT* dxb = ", "      SB_AT(stamp_chunk, 0, hh, 8);\n", ""),
            ("    if (tid < 32) {\n      const float* el = ax.el[hh];",
             "    SB_AT(stamp_chunk, 0, hh, 9);\n", ""),
            ("    if constexpr (BF) repro::fence_proxy_async();   // before TMA writes",
             "    SB_AT(stamp_chunk, 0, hh, 10);\n", ""),
            ("      pc[(size_t)i * g.groups * g.N + n] = dc[e];\n    }\n  }\n", "",
             "  SB_END(stamp_chunk, 0, nh);\n"),
        ],
    },
    "segment": {
        "chain": [
            ("  const int role = blockIdx.x & 1;", "  SB_START(stamp_chain, 0);\n", ""),
            ("  const int pos = ax.ticket / BH, bh = ax.ticket % BH;\n", "",
             "  SB_MARK(stamp_chain, 0, 0);\n"),
            ("  if (tid < n) cum_loop(ax.dt[tid], ax.cum[tid], A);\n", "  SB_MARK(stamp_chain, 0, 1);\n",
             "  SB_MARK(stamp_chain, 0, 2);\n"),
            ("  // Sweep: the segment's own state", "  SB_AT(stamp_chain, 0, 0, 0);\n", ""),
            ("  // The look-back: the neighbour's", "  SB_AT(stamp_chain, 0, 0, 1);\n", ""),
            ("  // The inclusive state into the neighbour's", "  SB_AT(stamp_chain, 0, 0, 2);\n", ""),
            ("  // The boundary states: ", "  SB_AT(stamp_chain, 0, 0, 3);\n", ""),
            ("    write_state(g.kept(role, b, role ? first / R : first / R + 1, h), mid);\n  }\n",
             "", "  SB_AT(stamp_chain, 0, 0, 4);\n  SB_END(stamp_chain, 0, 1);\n"),
        ],
        # Head i (of the block's group) by the first thread of the warpgroup
        # that takes it; the block's start and end by the first consumer.
        "chunk": [
            ("  const ChunkPlace pl = chunk_place(g);\n", "", "  SB_START(stamp_chunk, 0);\n"),
            ("  // The tables of the group's heads:", "  SB_MARK(stamp_chunk, 0, 0);\n", ""),
            ("  // The first loads, under the tables:", "  SB_MARK(stamp_chunk, 0, 1);\n", ""),
            ("  if (tid < pl.nh) {\n    cum_loop(", "  SB_MARK(stamp_chunk, 0, 2);\n", ""),
            ("  chunk_consumer<BF>(q, t_bc, work);\n", "  SB_MARK(stamp_chunk, 0, 3);\n", ""),
            ("  float db[ACC], dc[ACC];\n  zero(db);", "  SB_MARK(stamp_chunk, 0, 4);\n", ""),
            ("    // The head's tiles and states.\n", "", "    SB_AT(stamp_chunk, cw * WG, i, 0);\n"),
            ("    // The chunk's states, recomputed", "    SB_AT(stamp_chunk, cw * WG, i, 1);\n", ""),
            ("    // C B^T and dy x^T, then the weighted", "    SB_AT(stamp_chunk, cw * WG, i, 2);\n",
             ""),
            ("      repro::fence_regs(mm);\n    }\n", "", "    SB_AT(stamp_chunk, cw * WG, i, 3);\n"),
            ("    // The group's Wm B and Wm^T C", "    SB_AT(stamp_chunk, cw * WG, i, 4);\n", ""),
            ("      repro::fence_regs(yy);\n    }\n", "", "    SB_AT(stamp_chunk, cw * WG, i, 5);\n"),
            ("    // dx = wl (B G^T) + Wg^T dy + D dy.", "    SB_AT(stamp_chunk, cw * WG, i, 6);\n", ""),
            ("    q.issue_head(k + 1);\n", "    SB_AT(stamp_chunk, cw * WG, i, 7);\n",
             "    SB_AT(stamp_chunk, cw * WG, i, 8);\n"),
            ("        // dx's rows from the staged tile", "        SB_AT(stamp_chunk, cw * WG, i, 9);\n",
             ""),
            ("    // The gradient of cum row by row", "    SB_AT(stamp_chunk, cw * WG, i, 10);\n", ""),
            ("    // The head is done.", "    SB_AT(stamp_chunk, cw * WG, i, 11);\n", ""),
            ("  const bool pairs = g.N % 2 == 0;\n", "  SB_END(stamp_chunk, 0, pl.nh);\n", ""),
        ],
    },
}
# Per design: the chains' phases, then a head's, as (from, to) stamps.
CHAIN_PHASES = {
    "per-chunk": {"sweep 1": (0, 1), "look-back wait": (1, 2), "publish": (2, 3),
                  "sweep 2 (every chunk's tile written)": (3, 4)},
    "segment": {"sweep": (0, 1), "look-back wait": (1, 2), "publish, the block counted": (2, 3),
                "boundary tiles written": (3, 4)},
}
HEAD_PHASES = {
    "per-chunk": {"states read, tiles' wait": (0, 1), "C B^T, dy x^T": (1, 2),
                  "w, cum's sums, splits": (2, 3), "dy S, Wm B, Wm^T C": (3, 4),
                  "dC's state term, G's split": (4, 5), "B G^T, x G": (5, 6),
                  "wl terms": (6, 7), "Wg^T dy": (7, 8), "dx written": (8, 9),
                  "cum's reverse sum": (9, 10)},
    "segment": {"tiles' and states' wait": (0, 1), "S_c or G_c recomputed": (1, 2),
                "dy S, dC's state term; C B^T, dy x^T": (2, 3), "w, splits": (3, 4),
                "Wm B, Wm^T C, B G^T, x G": (4, 5), "dB's state term, wl (B G^T), sums": (5, 6),
                "Wg^T dy, barrier": (6, 7), "the next head's states issued": (7, 8),
                "dx staged, barrier": (8, 9), "dx written": (9, 10),
                "cum's gradient by row, barrier, tiles issued": (10, 11)},
}
LAST_STEP = {"per-chunk": 10, "segment": 11}
# Heads apart that one warpgroup takes in turn.
HEAD_STRIDE = {"per-chunk": 1, "segment": 2}


def stamped_source(text, design):
    head, rest = text.split('#include "mma.cuh"\n', 1)
    text = head + '#include "mma.cuh"\n' + HEAD + rest
    for kernel, stamps in STAMPS[design].items():
        first, end = REGIONS[design][kernel]
        a = text.index(first)
        b = text.index(end, a)
        region = text[a:b]
        for anchor, before, after in stamps:
            if region.count(anchor) != 1:
                raise SystemExit(f"{design}: anchor not found once in the {kernel} pass: "
                                 f"{anchor!r}")
            region = region.replace(anchor, before + anchor + after)
        text = text[:a] + region + text[b:]
    return text


def build(root, name, text):
    """A library of the gradient's source ``text`` alone (with the
    checkout's headers); prints the bf16 kernels' registers and spills."""
    from repro_torch.kernels import _build
    d = HERE / "build" / "ssm_bwd_phases" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in (root / "src/repro_torch/csrc").glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / "ssm_scan_bwd.cu").write_text(text)
    nvcc = _build.find_nvcc()
    obj, lib = d / "ssm_scan_bwd.o", d / "lib.so"
    for cmd in (_build.compile_command(d / "ssm_scan_bwd.cu", obj, nvcc),
                _build.link_command([obj], lib, nvcc)):
        cmd = [c if c != str(_build.CSRC) else str(d) for c in cmd]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"{name}: build failed\n{r.stdout}{r.stderr}")
        res = _build.parse_ptxas(r.stdout + r.stderr)
        names = _build.demangle(sorted(res))
        for fn, row in sorted(res.items()):
            print(f"{name}: {names[fn]} {row['registers']} registers, "
                  f"{row['spill_bytes']} spill bytes"
                  + (", wgmma serialized by ptxas" if row.get("wgmma_serialized") else ""))
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.repro_ssm_scan_bwd
    fn.argtypes, fn.restype = _build.SIGNATURES["repro_ssm_scan_bwd"], ctypes.c_int
    if name == "stamped":
        cdll.stamp_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        cdll.stamp_copy.restype = ctypes.c_int
        cdll.stamp_clear.restype = ctypes.c_int
    return cdll


def sm_balance(sm, start, end):
    busy, span = {}, {}
    for s, a, b in zip(sm, start, end):
        busy[s] = busy.get(s, 0) + (b - a)
        lo, hi = span.get(s, (a, b))
        span[s] = (min(lo, a), max(hi, b))
    busy_v = np.array(sorted(busy.values()))
    span_v = np.array(sorted(hi - lo for lo, hi in span.values()))
    return dict(sms=len(busy), sm_busy_max=int(busy_v[-1]), sm_busy_median=int(np.median(busy_v)),
                sm_busy_max_over_median=float(busy_v[-1] / np.median(busy_v)),
                sm_span_max=int(span_v[-1]), sm_span_median=int(np.median(span_v)))


def summary(buf, phases_of, last_step, per_head, stride=1):
    """The pass's phases from its stamp array (the blocks that stamped an
    end); each phase's stamps in ``phases_of``."""
    rows = buf.reshape(BLOCKS, SLOT).astype(np.int64)
    rows = rows[rows[:, 2] != 0]
    sm, start, end, n = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    marks = rows[:, 4:4 + MARKS]
    st = rows[:, 4 + MARKS:].reshape(len(rows), HEADS, STEPS)
    ok = (st[:, :, 0] != 0) & (st[:, :, last_step] != 0)
    phases = {}
    for name, (a, b) in phases_of.items():
        d = (st[:, :, b] - st[:, :, a])[ok & (st[:, :, a] != 0) & (st[:, :, b] != 0)]
        phases[name] = int(np.median(d)) if d.size else None
    out = dict(blocks=len(rows), block_median_cycles=int(np.median(end - start)),
               phases_median_cycles=phases)
    # The prologue's marks, each from the one before (the first from the start).
    prev = start
    for m_ in range(MARKS):
        have = marks[:, m_] != 0
        if have.any():
            out[f"prologue_mark_{m_}_cycles"] = int(np.median((marks[:, m_] - prev)[have]))
            prev = np.where(have, marks[:, m_], prev)
    if not per_head:
        phases["setup, tiles' wait"] = int(np.median(st[ok[:, 0], 0, 0] - start[ok[:, 0]]))
    else:
        has = ok[:, 0]
        gaps = (st[:, stride:, 0] - st[:, :-stride, last_step])[ok[:, stride:] & ok[:, :-stride]]
        phases["gap to the next head"] = int(np.median(gaps)) if gaps.size else None
        k = np.maximum(np.minimum(n, HEADS) - 1, 0)
        last = st[np.arange(len(rows)), k, last_step]
        whole = (n <= HEADS) & ok[np.arange(len(rows)), k]
        out.update(heads_a_block_median=int(np.median(n)),
                   head_median_cycles=int(np.median((st[:, :, last_step] - st[:, :, 0])[ok])),
                   prologue_median_cycles=int(np.median(st[has, 0, 0] - start[has])),
                   epilogue_median_cycles=(int(np.median(end[whole] - last[whole]))
                                           if whole.any() else None))
    out.update(sm_balance(sm, start, end))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--stamps", default="segment", choices=sorted(STAMPS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("ssm_bwd_phases runs on a CUDA device")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import ssm_scan as sc
    print("measuring", root / "src/repro_torch", "with the", args.stamps, "stamps")
    dev = torch.device("cuda", 0)
    source = (root / "src/repro_torch/csrc/ssm_scan_bwd.cu").read_text()
    libs = {"kernel": build(root, "kernel", source),
            "stamped": build(root, "stamped", stamped_source(source, args.stamps))}
    whole = sc._build.library

    def call(lib, tensors):
        sc._build.library = lambda: lib
        try:
            return sc.ssm_scan_bwd(*tensors)
        finally:
            sc._build.library = whole

    smi_line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi_line.strip())
    timer = cs.DeviceTimer(torch, dev)
    B, S, H, P, N, L = case = cs.SSM_TRAIN
    args_ = cs.ssm_inputs(torch, case, torch.bfloat16, 131, dev, strided=True)
    dy = cs.rand(torch, (B, S, H, P), torch.bfloat16, 137, dev)
    tensors = (*args_, dy, None, L)
    want = call(libs["kernel"], tensors)
    got = call(libs["stamped"], tensors)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("the stamped kernels' gradients differ from the kernels'")
    with cs.SmiSampler() as smi:
        t = cs.repeated(timer, {n: (lambda lib=lib: call(lib, tensors), 20)
                                for n, lib in libs.items()}, smi)
    print(f"== zamba2-7b's training shape (B {B}, S {S}, H {H}, P {P}, N {N}, chunk {L}, "
          "bf16, strided)")
    for n, r in t.items():
        print(f"{n}: {r['ms']:.6f} ms a call (spread {r['ms_spread']:.6f}); readings",
              [(round(x["ms"], 6), x["sm_mhz"]) for x in r["runs"]])
    lib = libs["stamped"]
    if lib.stamp_clear():
        raise SystemExit("stamp_clear failed")
    call(lib, tensors)
    torch.cuda.synchronize()
    chain = np.zeros(BLOCKS * SLOT, dtype=np.uint64)
    chunk = np.zeros(BLOCKS * SLOT, dtype=np.uint64)
    if lib.stamp_copy(chain.ctypes.data, chunk.ctypes.data, chain.nbytes):
        raise SystemExit("stamp_copy failed")
    print("chains:", summary(chain, CHAIN_PHASES[args.stamps], 0, False))
    print("chunk pass:", summary(chunk, HEAD_PHASES[args.stamps], LAST_STEP[args.stamps], True,
                                 HEAD_STRIDE[args.stamps]))


if __name__ == "__main__":
    main()
