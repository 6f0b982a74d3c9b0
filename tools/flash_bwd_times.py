#!/usr/bin/env python3
"""flash attention's gradient at the seven training paths' shapes, for one
checkout, on the card.

    python3 tools/flash_bwd_times.py [ROOT [TAG]]     # one CUDA device, ~40 s with the build

ROOT is the checkout whose ``repro_torch`` and ``chip_smoke.py`` are used
(default: this one), so two commits can be timed in turns in one call
(parent, change, change, parent).  Each shape goes through that checkout's
`chip_smoke.flash_bwd_times`: the kernels held against the plain rule,
then the kernels and SDPA's backward (cuDNN's) timed three times in turns
with the SM clock beside each reading.  Prints one JSON object: per shape
the median device ms, cuDNN's, kernel / cuDNN, the share of the bound,
the error over its allowance, and each reading with its clock.
"""

import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_times runs on a CUDA device")
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    _build.library()
    resources = _build.kernel_resources()
    timer = cs.DeviceTimer(torch, dev)
    rows = {}
    with cs.SmiSampler() as smi:
        for key, case, causal in [("granite", cs.FLASH_TRAIN, True),
                                  ("zamba2", cs.FLASH_ZAMBA, True),
                                  ("dbrx", cs.FLASH_DBRX, True),
                                  ("qwen2vl", cs.FLASH_QWEN2VL, True),
                                  ("seamless_decoder", cs.FLASH_SEAMLESS_DECODER, True),
                                  ("seamless_cross", cs.FLASH_SEAMLESS_CROSS, False),
                                  ("seamless_encoder", cs.FLASH_SEAMLESS_ENCODER, False)]:
            r = cs.flash_bwd_times(torch, timer, dev, case, resources, smi, causal)
            rows[key] = dict(ms=r["ms"], library_ms=r["library_ms"], ratio=r["library_ratio"],
                             share=r["bound_share"], err_over_tol=r["err_over_tol"],
                             clocks=[x["sm_mhz"] for x in r["readings"]["kernel"]["runs"]],
                             readings=[x["ms"] for x in r["readings"]["kernel"]["runs"]])
    tag = sys.argv[2] if len(sys.argv) > 2 else str(ROOT)
    print(json.dumps({"tag": tag, "root": str(ROOT), "rows": rows}))


if __name__ == "__main__":
    main()
