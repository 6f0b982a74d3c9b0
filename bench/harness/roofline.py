"""A kernel computation's share of its least time over the traced steps,
which the roofline readers of `bench/metrics/` share.

The least time is what one step's applications of the computation need
(`work.model.step_least_time`, each application counted once), times the
traced steps; the device time is every launch of the kernels named, in
the trace, over those steps.  None where the trace holds no launch of
them (the metric is then left out, never read as 0)."""

from harness.trace import seconds_of
from work.model import step_least_time


def share(run, computation: str, kernels):
    t = run["trace"]
    if t is None:
        return None
    spent, _ = seconds_of(t["ops"], kernels)
    if spent <= 0:
        return None
    tr = run["traffic"]
    least = step_least_time(run["cfg"], tr["batch"], tr["seq"], computation) * t["steps"]
    return 100.0 * least / spent
