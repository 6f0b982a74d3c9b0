#!/usr/bin/env python3
"""Where the bf16 flash-attention gradient's time goes, on the card.

    python3 tools/flash_bwd_phases.py [ROOT] [--stamps DESIGN]   # one CUDA device, ~60 s

ROOT is the checkout whose ``src/repro_torch`` is measured (default: this
one), so two commits can be read side by side on one card; DESIGN names
the set of stamps that fits its ``csrc/flash_attention_bwd.cu``:
``balanced`` (the default: dQ from dS rounded once, the dk/dv key blocks
cut into pieces) or ``split-ds`` (the earlier kernels, dS split into bf16
hi + lo in both passes and one dk/dv block a key block).

Builds a copy of that source with ``clock64`` stamps at named points of
`flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkdv_wgmma_kernel` (the first
consumer warpgroup's first thread stamps each tile; the block's first
thread its start and ``%smid``), calls it through the checkout's own
wrapper (`flash_attention_bwd`, its library swapped for the stamped one)
at granite-3-2b's and qwen2-vl-2b's training shapes (`chip_smoke
.FLASH_TRAIN`, `FLASH_QWEN2VL`), checks that it gives the unstamped
kernels' bits, and prints for each pass:

* each phase's median cycles a tile: the wait for the tile's loads, the
  first products (S and dP) until their wait returns, P and dS, the second
  products until their wait returns, and the gap to the next tile;
* the median block's cycles, its prologue (start to the first tile) and
  epilogue (the last tile to the stores' end);
* each SM's busy cycles (the sum of its blocks') and span (its first
  start to its last end): the busiest SM's against the median SM's, which
  is how far the pass's causal work is out of balance.

Beside them, both builds' device ms a call (three readings in turns,
`chip_smoke.repeated`, the SM clock beside each; the stamps' own cost is
the difference), registers and spills.  A stamp anchors on the source's
text: the script fails if an anchor is not found exactly once in its
kernel.
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
TILES = 48             # tiles a block stamps (its first)
SLOT = 4 + 6 * TILES   # smid, start, end, tiles; then 6 stamps a tile
HEAD = f"""
__device__ unsigned long long stamp_dq[{BLOCKS} * {SLOT}];
__device__ unsigned long long stamp_kv[{BLOCKS} * {SLOT}];
extern "C" int stamp_copy(void* dq, void* kv, int n) {{
  int e = (int)cudaMemcpyFromSymbol(dq, stamp_dq, n);
  return e ? e : (int)cudaMemcpyFromSymbol(kv, stamp_kv, n);
}}
extern "C" int stamp_clear() {{
  void* p = nullptr;
  int e = (int)cudaGetSymbolAddress(&p, stamp_dq);
  if (!e) e = (int)cudaMemset(p, 0, sizeof(stamp_dq));
  if (!e) e = (int)cudaGetSymbolAddress(&p, stamp_kv);
  return e ? e : (int)cudaMemset(p, 0, sizeof(stamp_kv));
}}
#define FB_ID (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define FB_SLOT(a) (a + (size_t)FB_ID * {SLOT})
#define FB_START(a) if (threadIdx.x == 0 && FB_ID < {BLOCKS}) {{ unsigned sm_; \\
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_)); \\
    FB_SLOT(a)[0] = sm_; FB_SLOT(a)[1] = clock64(); }}
#define FB_END(a, n) if (threadIdx.x == WG && FB_ID < {BLOCKS}) {{ \\
    FB_SLOT(a)[2] = clock64(); FB_SLOT(a)[3] = (n); }}
#define FB_TILE(a, j, k) if (threadIdx.x == WG && (j) < {TILES} && FB_ID < {BLOCKS}) \\
    FB_SLOT(a)[4 + 6 * (j) + (k)] = clock64()
"""
# Each kernel's text runs from its name to the next anchor.
REGIONS = {"dq": ("flash_bwd_dq_wgmma_kernel(const", "flash_bwd_dkdv_wgmma_kernel(const"),
           "kv": ("flash_bwd_dkdv_wgmma_kernel(const", "int launch_bf16(")}
# Per design and kernel: (anchor, text inserted before it, text inserted
# after it).  Tile stamps: 0 before the wait for the tile's loads, 1 after
# it, 2 after the first products' wait, 3 after P and dS, 4 after the
# second products' wait.
STAMPS = {
    "split-ds": {
        "dq": [
            ("  const int wg = threadIdx.x / WG;\n", "", "  FB_START(stamp_dq);\n"),
            ("    repro::mbar_wait(&full[s], (j / STAGES) & 1);\n",
             "    FB_TILE(stamp_dq, j, 0);\n", "    FB_TILE(stamp_dq, j, 1);\n"),
            ("    repro::fence_regs(sc);\n    repro::fence_regs(dp);\n", "",
             "    FB_TILE(stamp_dq, j, 2);\n"),
            ("    to_a_split(sc, a);\n", "",
             "    repro::fence_regs(a[0][3]);\n    FB_TILE(stamp_dq, j, 3);\n"),
            ("    repro::fence_regs(acc);\n    if (tid == 0) repro::mbar_arrive(&empty[s]);\n", "",
             "    FB_TILE(stamp_dq, j, 4);\n"),
            ("               row0, Sq, t, d_rt);\n", "", "  FB_END(stamp_dq, n_tiles);\n"),
        ],
        "kv": [
            ("  const int wg = threadIdx.x / WG;\n", "", "  FB_START(stamp_kv);\n"),
            ("    repro::mbar_wait(&full[s], (j / STAGES) & 1);\n",
             "    FB_TILE(stamp_kv, j, 0);\n", "    FB_TILE(stamp_kv, j, 1);\n"),
            ("    repro::fence_regs(st);\n    repro::fence_regs(dpt);\n", "",
             "    FB_TILE(stamp_kv, j, 2);\n"),
            ("    to_a_split(dpt, as);\n", "",
             "    repro::fence_regs(as[0][3]);\n    FB_TILE(stamp_kv, j, 3);\n"),
            ("    repro::fence_regs(dka);\n    if (tid == 0) repro::mbar_arrive(&empty[s]);\n", "",
             "    FB_TILE(stamp_kv, j, 4);\n"),
            ("  store_acc<D>(dv + base, (size_t)Hkv * d_rt, dva, 1.f, key0, Sk, t, d_rt);\n", "",
             "  FB_END(stamp_kv, n_tiles);\n"),
        ],
    },
    "balanced": {
        # Tile j + 1 of the loop: 0 at the iteration's top, 1 once its S and
        # dP and tile j's dQ product are issued (after the wait for its K and
        # V), 2 once S has landed, 3 after P, dP's wait and dS, 4 once the dQ
        # product has.
        "dq": [
            ("  const int wg = threadIdx.x / WG;\n", "", "  FB_START(stamp_dq);\n"),
            ("    repro::mbar_wait(&full[s], (j / STAGES) & 1);\n", "",
             "    FB_TILE(stamp_dq, j, 5);\n"),
            ("    first(j + 1);\n", "    FB_TILE(stamp_dq, j + 1, 0);\n", ""),
            ("    second(j, cur);\n", "", "    FB_TILE(stamp_dq, j + 1, 1);\n"),
            ("    repro::wgmma_wait<2>();\n    repro::fence_regs(sc);\n", "",
             "    FB_TILE(stamp_dq, j + 1, 2);\n"),
            ("    grads();\n", "", "    FB_TILE(stamp_dq, j + 1, 3);\n"),
            ("    repro::fence_regs(acc);\n"
             "    if (tid == 0) repro::mbar_arrive(&empty[j % STAGES]);\n",
             "", "    FB_TILE(stamp_dq, j + 1, 4);\n"),
            ("               row0, Sq, t, d_rt);\n", "", "  FB_END(stamp_dq, n_tiles);\n"),
        ],
        # D 64 (tile j + 1, as the dq kernel's) and D 128 (tile j): 0 before
        # the tile's first products' issue, 1 after the issue (with the
        # wait for its loads), 2 once S^T has landed, 3 after P^T and dS^T
        # (with dP^T's wait; at D 128 also dV's issue and dS^T's split), 4
        # once the second products have (and the stage is released).
        "kv": [
            ("  const int wg = threadIdx.x / WG;\n", "", "  FB_START(stamp_kv);\n"),
            ("    repro::mbar_wait(&full[s], (j / STAGES) & 1);\n", "",
             "    FB_TILE(stamp_kv, j, 5);\n"),
            ("      first(j + 1);\n      dv_product(j, cp);\n      dk_product(j, cs);\n"
             "      repro::wgmma_commit();\n",
             "      FB_TILE(stamp_kv, j + 1, 0);\n", "      FB_TILE(stamp_kv, j + 1, 1);\n"),
            ("      repro::wgmma_wait<2>();\n      repro::fence_regs(st);\n", "",
             "      FB_TILE(stamp_kv, j + 1, 2);\n"),
            ("      grads(j + 1);\n", "", "      FB_TILE(stamp_kv, j + 1, 3);\n"),
            ("    };\n    auto last = [&]", "      FB_TILE(stamp_kv, j + 1, 4);\n", ""),
            ("      first(j);\n", "      FB_TILE(stamp_kv, j, 0);\n",
             "      FB_TILE(stamp_kv, j, 1);\n"),
            ("      probs(j);\n", "      FB_TILE(stamp_kv, j, 2);\n", ""),
            ("      grads(j);\n      to_a_split(dpt, as0);\n", "",
             "      repro::fence_regs(as0[0][3]);\n      FB_TILE(stamp_kv, j, 3);\n"),
            ("    }\n  }\n  repro::wgmma_wait<0>();\n  repro::fence_regs(dva);",
             "      FB_TILE(stamp_kv, j, 4);\n", ""),
            ("    return;\n  }\n\n  // A piece of a cut key block",
             "    FB_END(stamp_kv, n_tiles);\n", ""),
            ("  if (!last_piece) return;\n", "  if (!last_piece) FB_END(stamp_kv, n_tiles);\n", ""),
            ("  if (threadIdx.x == WG) *ticket = 0;   // for the next call\n", "",
             "  FB_END(stamp_kv, n_tiles);\n"),
        ],
    },
}
# Per design and kernel, each phase's stamps (from, to).
TILE_PHASES = {
    "split-ds": {k: {"load wait": (0, 1), "first products": (1, 2), "P and dS": (2, 3),
                     "second products": (3, 4)} for k in ("dq", "kv")},
    "balanced": {k: {"load wait": (0, 5), "issue": (5, 1), "S's wait": (1, 2),
                     "P and dS (with dP's wait)": (2, 3), "second products' wait": (3, 4)}
                 for k in ("dq", "kv")},
}


def stamped_source(text, design):
    head, rest = text.split('#include "mma.cuh"\n', 1)
    text = head + '#include "mma.cuh"\n' + HEAD + rest
    for kernel, stamps in STAMPS[design].items():
        first, end = REGIONS[kernel]
        a = text.index(first)
        b = text.index(end, a)
        region = text[a:b]
        for anchor, before, after in stamps:
            if region.count(anchor) != 1:
                raise SystemExit(f"{design}: anchor not found once in the {kernel} kernel: "
                                 f"{anchor!r}")
            region = region.replace(anchor, before + anchor + after)
        text = text[:a] + region + text[b:]
    return text


def build(root, name, text):
    """A library of the gradient's source ``text`` alone (with the
    checkout's headers); prints the bf16 kernels' registers and spills."""
    from repro_torch.kernels import _build
    d = HERE / "build" / "flash_bwd_phases" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in _build.headers():
        (d / h.name).write_text(h.read_text())
    (d / "flash_attention_bwd.cu").write_text(text)
    nvcc = _build.find_nvcc()
    obj, lib = d / "flash_attention_bwd.o", d / "lib.so"
    for cmd in (_build.compile_command(d / "flash_attention_bwd.cu", obj, nvcc),
                _build.link_command([obj], lib, nvcc)):
        cmd = [c if c != str(_build.CSRC) else str(d) for c in cmd]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"{name}: build failed\n{r.stdout}{r.stderr}")
        res = _build.parse_ptxas(r.stdout + r.stderr)
        names = _build.demangle(sorted(res))
        for fn, row in sorted(res.items()):
            if "wgmma" in fn:
                print(f"{name}: {names[fn]} {row['registers']} registers, "
                      f"{row['spill_bytes']} spill bytes"
                      + (", wgmma serialized by ptxas" if row.get("wgmma_serialized") else ""))
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.repro_flash_attention_bwd
    fn.argtypes, fn.restype = _build.SIGNATURES["repro_flash_attention_bwd"], ctypes.c_int
    if name == "stamped":
        cdll.stamp_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        cdll.stamp_copy.restype = ctypes.c_int
        cdll.stamp_clear.restype = ctypes.c_int
    return cdll


def summary(buf, blocks, phases_of, design):
    """The pass's phases from its stamp array (``blocks`` rows), each
    phase's stamps in ``phases_of``."""
    rows = buf.reshape(BLOCKS, SLOT)[:blocks].astype(np.int64)
    sm, start, end, n = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    tiles = rows[:, 4:].reshape(blocks, TILES, 6)
    ok = (tiles[:, :, 0] != 0) & (tiles[:, :, 4] != 0)      # the tiles stamped in full
    if design == "balanced":
        ok &= tiles[:, :, 5] != 0
    phases = {}
    for name, (a, b) in phases_of.items():
        phases[name] = int(np.median((tiles[:, :, b] - tiles[:, :, a])[ok]))
    nxt = ok[:, 1:] & ok[:, :-1]
    gaps = (tiles[:, 1:, 0] - tiles[:, :-1, 4])[nxt]
    phases["gap to the next tile"] = int(np.median(gaps)) if gaps.size else 0
    kept = np.minimum(n, TILES)
    has = ok.any(axis=1)
    first_tile = np.argmax(ok, axis=1)
    cycles = end - start
    busy, span = {}, {}
    for s, a, b in zip(sm, start, end):
        busy[s] = busy.get(s, 0) + (b - a)
        lo, hi = span.get(s, (a, b))
        span[s] = (min(lo, a), max(hi, b))
    busy_v = np.array(sorted(busy.values()))
    span_v = np.array(sorted(hi - lo for lo, hi in span.values()))
    at_last = np.maximum(kept - 1, 0)
    last = tiles[np.arange(blocks), at_last, 4]
    whole = (n <= TILES) & ok[np.arange(blocks), at_last]    # the last tile stamped
    return dict(
        blocks=blocks, sms=len(busy), tiles_a_block_median=int(np.median(n)),
        tile_phases_median_cycles=phases,
        block_median_cycles=int(np.median(cycles)),
        prologue_median_cycles=int(np.median(tiles[has, first_tile[has], 0] - start[has])),
        epilogue_median_cycles=int(np.median(end[whole] - last[whole])) if whole.any() else None,
        sm_busy_max=int(busy_v[-1]), sm_busy_median=int(np.median(busy_v)),
        sm_busy_max_over_median=float(busy_v[-1] / np.median(busy_v)),
        sm_span_max=int(span_v[-1]), sm_span_median=int(np.median(span_v)),
        sm_span_max_over_median=float(span_v[-1] / np.median(span_v)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--stamps", default="balanced", choices=sorted(STAMPS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_phases runs on a CUDA device")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    print("measuring", root / "src/repro_torch", "with the", args.stamps, "stamps")
    dev = torch.device("cuda", 0)
    source = (root / "src/repro_torch/csrc/flash_attention_bwd.cu").read_text()
    libs = {"kernel": build(root, "kernel", source),
            "stamped": build(root, "stamped", stamped_source(source, args.stamps))}
    _build.library()                     # the forward's kernels, built as the wrapper builds them
    whole = _build.library

    def call(lib, tensors, causal):
        fa._build.library = lambda: lib
        try:
            return fa.flash_attention_bwd(*tensors, causal)
        finally:
            fa._build.library = whole

    smi_line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi_line.strip())
    timer = cs.DeviceTimer(torch, dev)
    for case in (cs.FLASH_TRAIN, cs.FLASH_QWEN2VL):
        name, B, Sq, Sk, Hq, Hkv, D = case
        q = cs.rand(torch, (B, Sq, Hq, D), torch.bfloat16, 61, dev)
        k = cs.rand(torch, (B, Sk, Hkv, D), torch.bfloat16, 62, dev)
        v = cs.rand(torch, (B, Sk, Hkv, D), torch.bfloat16, 63, dev)
        dout = cs.rand(torch, (B, Sq, Hq, D), torch.bfloat16, 64, dev)
        out, lse = fa.flash_attention(q, k, v, True)
        tensors = (q, k, v, out, lse, dout)
        want = call(libs["kernel"], tensors, True)
        got = call(libs["stamped"], tensors, True)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{name}: the stamped kernels' gradients differ from the kernels'")
        with cs.SmiSampler() as smi:
            t = cs.repeated(timer, {n: (lambda lib=lib: call(lib, tensors, True), 20)
                                    for n, lib in libs.items()}, smi)
        print(f"== {name} (B {B}, S {Sq}, Hq {Hq}, Hkv {Hkv}, D {D}, causal)")
        for n, r in t.items():
            print(f"{n}: {r['ms']:.6f} ms a call (spread {r['ms_spread']:.6f}); readings",
                  [(round(x["ms"], 6), x["sm_mhz"]) for x in r["runs"]])
        # One call alone on cleared stamp arrays; each pass's blocks from its grid.
        lib = libs["stamped"]
        if lib.stamp_clear():
            raise SystemExit("stamp_clear failed")
        call(lib, tensors, True)
        torch.cuda.synchronize()
        dq_buf = np.zeros(BLOCKS * SLOT, dtype=np.uint64)
        kv_buf = np.zeros(BLOCKS * SLOT, dtype=np.uint64)
        if lib.stamp_copy(dq_buf.ctypes.data, kv_buf.ctypes.data, dq_buf.nbytes):
            raise SystemExit("stamp_copy failed")
        for kernel, buf in (("dq", dq_buf), ("kv", kv_buf)):
            rows = buf.reshape(BLOCKS, SLOT)
            blocks = int(np.flatnonzero(rows[:, 2])[-1]) + 1     # stamped an end
            print(f"{kernel} pass:",
                  summary(buf, blocks, TILE_PHASES[args.stamps][kernel], args.stamps))


if __name__ == "__main__":
    main()
