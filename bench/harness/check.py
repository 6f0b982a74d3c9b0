"""The comparison that decides ``correct`` for a training cell.

Each side (the program, or a stand-in for it, and the plain float32
reference) gives the same readings of its first steps from the same
weights and batches:

* ``loss``: each step's loss;
* ``grad``: each leaf's norm of the first gradient as the optimizer takes
  it (after clipping); the program's is read from AdamW's first moment
  after one step, m = (1 - b1) g;
* ``delta``: each leaf's norm of the parameters' change over the steps.

A leaf is one layer's part of a parameter (`weights.slices`).  The numbers
compared, each against a limit of its own:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the two gradient norms, over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger (some gradients are all but zero);
* ``delta_gap``: the same for the change, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's: a leaf whose
  gradient is nought to rounding moves under AdamW by round-off alone."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

#: A leaf whose reference gradient norm is under this share of the median
#: leaf's is left out of ``delta_gap``.
FLAT_GRAD = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "delta_gap")


def _gap(a: float, b: float, scale: float) -> float:
    """|a - b| / scale; infinite where a is not a number."""
    gap = abs(a - b) / scale
    return gap if math.isfinite(gap) else math.inf


def _worst(ours: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> Tuple[float, str]:
    """(the worst leaf's gap, that leaf) over ``keys``."""
    if set(ours) != set(ref):
        missing = sorted(set(ours) ^ set(ref))[:5]
        raise ValueError(f"the two sides' leaves differ, e.g. {missing}")
    floor = statistics.median(ref[k] for k in keys)
    return max((_gap(ours[k], ref[k], max(ref[k], floor, 1e-30)), k) for k in keys)


def compare(ours: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """Each number compared, from the two sides' readings, with where it
    is worst (a step, or a leaf)."""
    if len(ours["loss"]) != len(ref["loss"]):
        raise ValueError(f"{len(ours['loss'])} losses against {len(ref['loss'])}")
    loss = max((_gap(a, b, abs(b)), f"step {i + 1}")
               for i, (a, b) in enumerate(zip(ours["loss"], ref["loss"])))
    g_floor = statistics.median(ref["grad"].values())
    moving = sorted(k for k, g in ref["grad"].items() if g >= FLAT_GRAD * g_floor)
    delta = _worst({k: ours["delta"][k] for k in moving}, {k: ref["delta"][k] for k in moving},
                   moving)
    return {"loss_gap": loss, "grad_gap": _worst(ours["grad"], ref["grad"], sorted(ref["grad"])),
            "delta_gap": delta}


def numbers(ours: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared, from the two sides' readings."""
    return {k: v for k, (v, _) in compare(ours, ref).items()}


def verdict(found: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number compared beside its limit, in `NUMBERS` order; a number
    whose limit is null is not compared (a cell's limits file says why)."""
    return {k: {"value": found[k], "limit": limits[k]} for k in NUMBERS
            if limits.get(k) is not None}


def passed(checked: Dict[str, Dict[str, float]]) -> bool:
    return all(v["value"] <= v["limit"] for v in checked.values())
