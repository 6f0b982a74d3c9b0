#!/usr/bin/env python3
"""rms_norm's forward at the decode shapes, one checkout: the host loop's
ms a call beside the device's, for the kernel and for `F.rms_norm`.

    python3 tools/norm_host_loop.py [ROOT]    # one CUDA device, ~30 s with the build

ROOT is the checkout whose `repro_torch` is measured (default: this one),
so that two commits can be held side by side on one card: run it for each
in turns (parent, change, change, parent) in one call.  At the decode
step's (8, 1, d) bf16 for granite's, zamba2's and xlstm's mLSTM widths:
``call_ms`` is `chip_smoke.py`'s host-loop reading (CUDA events around a
tight loop of calls, which the host sets where a call's host path is
longer than its kernel), ``host_us`` the same loop on the host's clock,
``ms`` the device time a call (`chip_smoke.DeviceTimer`), each the median
of three passes in turns.  Where the checkout has the empty kernel
(`empty_kernel`), its floor too.  ``pieces`` holds, on the host's clock,
the calls a launch's host path can take for its device and stream: the
parent's (``device_context``: `torch.cuda.device` entered; ``stream_object``:
a `Stream` object built for its handle; ``build_check``: `_build.check`
on a zero code) beside the ones that replaced them (``device_check``,
``raw_stream``).  Prints one JSON object.
"""

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
HERE = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(HERE))           # chip_smoke's timer, from this checkout

import torch  # noqa: E402

WIDTHS = (2048, 3584, 4096)
CALLS, PASSES = 2000, 3


def host_us(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    us = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize()
    return us


def main():
    if not torch.cuda.is_available():
        print("norm_host_loop: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rk   # from ROOT: before chip_smoke's path
    import chip_smoke
    device = torch.device("cuda", 0)
    timer = chip_smoke.DeviceTimer(torch, device)
    gen = torch.Generator(device).manual_seed(0)
    fns = {}
    for d in WIDTHS:
        x = torch.randn(8, 1, d, device=device, generator=gen).bfloat16()
        scale = torch.randn(d, device=device, generator=gen).bfloat16()
        fns[f"rms_norm_{d}"] = lambda x=x, scale=scale: rk.rms_norm(x, scale, 1e-5)
        fns[f"library_{d}"] = lambda x=x, scale=scale, d=d: F.rms_norm(x, (d,), scale, 1e-5)
    if hasattr(rk, "empty_kernel"):
        fns["empty_kernel"] = lambda: rk.empty_kernel(device)

    def device_context():
        with torch.cuda.device(device):
            pass

    from repro_torch.kernels import _build
    pieces = {"device_context": device_context,
              "stream_object": lambda: torch.cuda.current_stream().cuda_stream,
              "build_check": lambda: _build.check(0, "rms_norm"),
              "device_check": lambda: torch._C._cuda_getDevice() == 0,
              "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0)}
    runs = {name: [] for name in fns}
    piece_runs = {name: [] for name in pieces}
    for _ in range(PASSES):
        for name, fn in fns.items():
            ms, call_ms = timer(fn, iters=200)
            runs[name].append(dict(ms=ms, call_ms=call_ms, host_us=host_us(fn)))
        for name, fn in pieces.items():
            piece_runs[name].append(host_us(fn))
    med = {name: {key: statistics.median(r[key] for r in rs) for key in rs[0]}
           for name, rs in runs.items()}
    print(json.dumps(dict(root=str(ROOT), module=rk.__file__,
                          device=torch.cuda.get_device_name(0), shape="(8, 1, d) bf16",
                          calls=CALLS, median=med, runs=runs,
                          pieces={name: dict(host_us=statistics.median(us), runs=us)
                                  for name, us in piece_runs.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
