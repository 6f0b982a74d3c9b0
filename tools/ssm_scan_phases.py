#!/usr/bin/env python3
"""Where the bf16 scan kernel's time goes, on the card.

    python3 tools/ssm_scan_phases.py     # one CUDA device, ~40 s

Builds a copy of ``src/repro_torch/csrc/ssm_scan.cu`` with ``clock64``
stamps (thread 0's, into a device array) at named points of
`ssm_scan_wgmma_kernel`, runs it and the unstamped kernel at zamba2-7b's
training shape (`chip_smoke.SSM_TRAIN`, x, B and C strided as
`mamba2_block` hands them), and prints: both kernels' device ms (three
readings in turns, `chip_smoke.repeated`, the SM clock beside each; the
stamps' own cost is the difference), each block phase's median cycles
(setup, sweep 1, the look-back's wait, the publish, sweep 2), and the
median cycles of the steps of a chunk of sweep 2 that carries the state
on (its state tiles, barrier and mbarrier wait: the segment's first) and
of sweep 1's second chunk.
A stamp anchors on the source's text: the script fails if one is missing.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssm_scan import _STATE_TILE  # noqa: E402

SLOTS = 16384                          # blocks the stamp array holds
HEAD = """#include "mma.cuh"
__device__ unsigned long long stamp_t[16384 * 30];
extern "C" int stamp_copy(void* dst, int n) { return (int)cudaMemcpyFromSymbol(dst, stamp_t, n); }
#define BLK(k) if (threadIdx.x == 0) stamp_t[ax.ticket * 10 + (k)] = clock64()
#define STEP(k) if (threadIdx.x == 0) stamp_t[16384 * 10 + blockIdx.x * 20 + (k)] = clock64()
"""
U = "  if (UPDATE) { STEP(%d); }\n"
# (anchor, text inserted before it, text inserted after it)
STAMPS = [
    ('#include "mma.cuh"\n', "", HEAD[len('#include "mma.cuh"\n'):]),
    ("  const int seg = ax.ticket / BH, bh = ax.ticket % BH;\n", "", "  BLK(0);\n"),
    ("  // Sweep 1: S_loc", "  BLK(1);\n", ""),
    ("  // The look-back: segment", "  BLK(2);\n", ""),
    ("  for (int e = 0; e < ACC; ++e) s[e] = dseg * s_in[e] + s[e];\n", "", "  BLK(3);\n"),
    ("  // Sweep 2: each chunk", "  BLK(4);\n", ""),
    ("    __syncthreads();   // every thread is done with the stage and the state's tiles\n  }\n",
     "", "  BLK(5);\n"),
    ("  float gw[ACC], yy[ACC];\n", U % 0, ""),
    ("  // The next item's TMA loads", U % 1, ""),
    ("  in.ld->issue(in.next);\n", "", U % 2),
    ("  repro::wgmma_wait<1>();\n  repro::fence_regs(gw);\n", "", U % 3),
    ("  Split wa, ua;\n", "  repro::fence_regs(gw);\n" + U % 4, ""),
    ("  split_acc(gw, wa);\n", "", "  repro::fence_regs(wa[1][3]);\n" + U % 5),
    ("    repro::wgmma_wait<0>();\n    repro::fence_regs(s);\n  }\n", "", U % 8),
    ("    repro::fence_proxy_async();   // before TMA writes the stage again\n", "", U % 9),
    ("    store_state(s, s_hi, s_lo);\n", "    if (c == 0) { STEP(10); }\n",
     "    if (c == 0) { STEP(11); }\n"),
    ("    __syncthreads();   // the state's tiles are written\n", "",
     "    if (c == 0) { STEP(12); }\n"),
    ("    ld.wait(q);\n", "", "    if (c == 0) { STEP(13); }\n"),
    ("    ld.wait(c);\n", "    if (c == 1) { STEP(14); }\n", "    if (c == 1) { STEP(15); }\n"),
    ("    ld.issue(c + STAGES - 1);\n", "", "    if (c == 1) { STEP(16); }\n"),
    ("    split_xt(st, ax.wl[c], ua);\n", "",
     "    repro::fence_regs(ua[1][3]);\n    if (c == 1) { STEP(17); }\n"),
    ("    repro::fence_regs(s);\n    __syncthreads();   // every thread is done with the stage\n",
     "    if (c == 1) { STEP(18); }\n", "    if (c == 1) { STEP(19); }\n"),
]
# the C S^T wait (stamped 6), W x with the (wl x)^T split beside it (7)
CS_WAIT = ("  repro::wgmma_wait<0>();\n  repro::fence_regs(yy);\n\n  // y = exp",
           "  repro::wgmma_wait<0>();\n  repro::fence_regs(yy);\n" + U % 6 + "\n  // y = exp")
WX_WAIT = ("  repro::wgmma_wait<0>();\n  repro::fence_regs(yy);\n  if (UPDATE) {\n",
           "  repro::wgmma_wait<0>();\n  repro::fence_regs(yy);\n" + U % 7 + "  if (UPDATE) {\n")
BLOCK_PHASES = {"setup (tables)": (0, 1), "sweep 1": (1, 2), "look-back wait": (2, 3),
                "publish": (3, 4), "sweep 2": (4, 5), "block": (0, 5)}
STEP_PHASES = {
    "sweep 2: state tiles": (10, 11), "barrier": (11, 12), "mbarrier wait": (12, 13),
    "wgmma issue (G, C S^T)": (0, 1), "TMA issue": (1, 2), "G wait": (2, 3), "W": (3, 4),
    "W split": (4, 5), "C S^T wait": (5, 6), "W x (beside it the (wl x)^T split)": (6, 7),
    "update": (7, 8), "y + D x staged and stored": (8, 9),
    "sweep 1: mbarrier wait": (14, 15), "sweep 1: TMA issue": (15, 16),
    "sweep 1: (wl x)^T split": (16, 17), "sweep 1: update": (17, 18), "sweep 1: barrier": (18, 19)}


def stamped_source():
    text = (ROOT / "src/repro_torch/csrc/ssm_scan.cu").read_text()
    for anchor, before, after in STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in ssm_scan.cu: {anchor!r}")
        text = text.replace(anchor, before + anchor + after)
    for anchor, stamped in (CS_WAIT, WX_WAIT):
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in ssm_scan.cu: {anchor!r}")
        text = text.replace(anchor, stamped)
    return text


def build(name, text):
    """The scan's library from ``text`` (with the package's headers)."""
    d = ROOT / "build" / "ssm_scan_phases" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in _build.headers():
        (d / h.name).write_text(h.read_text())
    (d / "ssm_scan.cu").write_text(text)
    nvcc = _build.find_nvcc()
    obj, lib = d / "ssm_scan.o", d / "lib.so"
    for cmd in (_build.compile_command(d / "ssm_scan.cu", obj, nvcc),
                _build.link_command([obj], lib, nvcc)):
        cmd = [c if c != str(_build.CSRC) else str(d) for c in cmd]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"{name}: build failed\n{r.stdout}{r.stderr}")
        for fn, res in _build.parse_ptxas(r.stdout + r.stderr).items():
            if "ssm_scan_wgmma_kernel" in fn:
                print(f"{name}: {res['registers']} registers, {res['spill_bytes']} spill bytes"
                      + (", wgmma serialized by ptxas" if res.get("wgmma_serialized") else ""))
    return ctypes.CDLL(str(lib))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssm_scan_phases runs on a CUDA device")
    dev = torch.device("cuda", 0)
    case = cs.SSM_TRAIN
    B, S, H, P, N, chunk = case
    args = cs.ssm_inputs(torch, case, torch.bfloat16, 91, dev, strided=True)
    x, Bm, Cm, dt, A_log, D = args
    libs = {"kernel": build("kernel", (ROOT / "src/repro_torch/csrc/ssm_scan.cu").read_text()),
            "stamped": build("stamped", stamped_source())}
    carry = torch.empty((2 * B * H * _STATE_TILE,), dtype=torch.float32, device=dev)

    def launcher(lib):
        fn = lib.repro_ssm_scan
        fn.argtypes, fn.restype = _build.SIGNATURES["repro_ssm_scan"], ctypes.c_int

        def call():
            y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
            st = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
            sync = torch.zeros((2 + B * H,), dtype=torch.int32, device=dev)
            code = fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                      A_log.data_ptr(), D.data_ptr(), y.data_ptr(), st.data_ptr(),
                      carry.data_ptr(), sync.data_ptr(), B, S, H, P, N, chunk, x.stride(0),
                      x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1), 1,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"launch failed: {code}")
            return y
        return call

    calls = {name: launcher(lib) for name, lib in libs.items()}
    want = calls["kernel"]()
    got = calls["stamped"]()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit("the stamped kernel's y differs from the kernel's")
    smi_line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi_line.strip())
    timer = cs.DeviceTimer(torch, dev)
    with cs.SmiSampler() as smi:
        t = cs.repeated(timer, {name: (fn, 20) for name, fn in calls.items()}, smi)
    for name, r in t.items():
        print(f"{name}: {r['ms']:.6f} ms (spread {r['ms_spread']:.6f}); readings",
              [(round(x["ms"], 6), x["sm_mhz"]) for x in r["runs"]])
    calls["stamped"]()
    torch.cuda.synchronize()
    buf = np.zeros(SLOTS * 30, dtype=np.uint64)
    lib = libs["stamped"]
    lib.stamp_copy.argtypes, lib.stamp_copy.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    if lib.stamp_copy(buf.ctypes.data, buf.nbytes):
        raise SystemExit("stamp_copy failed")
    segments = B * H * -(-(S // chunk) // 4)
    blk = buf[:SLOTS * 10].reshape(SLOTS, 10)[:segments].astype(np.int64)
    step = buf[SLOTS * 10:].reshape(SLOTS, 20).astype(np.int64)
    step = step[step[:, 0] != 0]         # the blocks that ran (one a segment, or fewer)
    print("block phases, median cycles:",
          {k: int(np.median(blk[:, b] - blk[:, a])) for k, (a, b) in BLOCK_PHASES.items()})
    print("chunk steps, median cycles:",
          {k: int(np.median(step[:, b] - step[:, a]))
           for k, (a, b) in STEP_PHASES.items()})


if __name__ == "__main__":
    main()
