"""The share of the traced steps' wall time in which no operation ran on
the card (`torch.profiler`'s CUDA events, overlaps counted once), in %."""


def read(run):
    t = run["trace"]
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
