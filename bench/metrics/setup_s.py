"""Set-up seconds: from the process's start to the first timed step's
start (imports, the port's kernels loaded or built, the weights and the
optimizer state made on the card, the checked warm-up steps)."""


def read(run):
    return run["setup_s"]
