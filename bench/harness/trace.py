"""From a device trace to what the per-layer metrics read.

The traced steps run under `torch.profiler` (CUDA activity only, so that
tracing adds no per-operator cost on the host); the host's spans (the
batch, the step call, the wait for the loss, the hook) are stamped by the
benchmark on the wall clock, which the profiler's events share.  `reduce`
gives, over the traced window: the seconds in which some operation ran on
the device (overlaps counted once), each device operation's summed
seconds, the operations that took most time and the longest idle gaps
labelled by the host span that held the gap's start."""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, int, int]        # (name, start ns, end ns)

TOP = 10


def device_events(prof) -> List[Event]:
    """The CUDA events (kernels, copies, fills) of a stopped profiler."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _merged(events: Sequence[Event], t0: int, t1: int) -> List[Tuple[int, int]]:
    spans = sorted((max(s, t0), min(e, t1)) for _, s, e in events if e > t0 and s < t1)
    merged: List[Tuple[int, int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _holder(spans: Sequence[Event], t: int) -> str:
    """The name of the shortest host span that holds the instant ``t``
    (a collection inside a step call is named as the collection)."""
    held = [(e - s, name) for name, s, e in spans if s <= t < e]
    return min(held)[1] if held else "between spans"


def reduce(events: Sequence[Event], spans: Sequence[Event], t0: int, t1: int) -> Dict:
    """The traced window [t0, t1) (ns): ``window_s``, ``busy_s``,
    ``ops`` (name -> seconds, inside the window), ``device_ops`` and
    ``idle_gaps`` (at most `TOP` [name, seconds] each)."""
    merged = _merged(events, t0, t1)
    busy = sum(e - s for s, e in merged)
    ops: Dict[str, float] = {}
    for name, s, e in events:
        if e > t0 and s < t1:
            ops[name] = ops.get(name, 0.0) + (min(e, t1) - max(s, t0)) / 1e9
    edges = [t0] + [x for span in merged for x in span] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": busy / 1e9,
        "ops": ops,
        "device_ops": [[n, s] for n, s in sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[_holder(spans, s), (e - s) / 1e9] for s, e in gaps[:TOP]],
    }


def seconds_of(ops: Dict[str, float], kernels: Sequence[str]) -> Tuple[float, int]:
    """(summed seconds, distinct names) of the operations whose name holds
    one of ``kernels`` as a whole identifier (``flash_fwd_kernel`` is not
    found in ``flash_fwd_wgmma_kernel<64>``)."""
    found = [(n, s) for n, s in ops.items()
             if any(re.search(rf"(?<![A-Za-z0-9_]){k}(?![A-Za-z0-9_])", n) for k in kernels)]
    return sum(s for _, s in found), len(found)
