"""Training tokens a second: every token of the steps completed in the
window, over the time from the first timed step's start to the last one's
end (the host's clock; each step ends once its loss is read)."""


def read(run):
    if not run["window_s"] or not run["steps"]:
        return None
    return run["tokens"] / run["window_s"]
