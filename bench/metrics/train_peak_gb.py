"""The most memory the card held for the program over the window,
`torch.cuda.max_memory_allocated` with its peak reset at the window's
start, in 1e9 bytes."""


def read(run):
    return run["peak_bytes"] / 1e9 if run["peak_bytes"] else None
