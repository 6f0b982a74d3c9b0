"""Runtime: fault tolerance, elastic rescale, straggler mitigation; the
port of `repro.runtime`."""
