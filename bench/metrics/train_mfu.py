"""The step's share of the card's bf16 peak: the model's operations in a
training step (`work.model.train_flops`: the forward's products times
three, nothing recomputed counted) over the window's mean step time on
the host's clock, over 989 TFLOP/s, in %."""

from harness.peaks import BF16_FLOPS
from work.model import train_flops


def read(run):
    if not run["window_s"] or not run["steps"]:
        return None
    t = run["traffic"]
    step_s = run["window_s"] / run["steps"]
    return 100.0 * train_flops(run["cfg"], t["batch"], t["seq"]) / step_s / BF16_FLOPS
