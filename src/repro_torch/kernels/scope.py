"""Kernel scopes: the stretch of a kernel wrapper that launches the kernel
(or, for a tensor off the card, runs its plain version).

A tally of the port's own program (`repro_torch.launch.op_stats`) listens
here: inside a scope it counts the kernel's work, as its wrapper's
``work(...)`` gives it, in place of whatever ops the plain version
dispatches, and it counts the scope once.  With no listener a scope costs
one global read, so serving and training pay nothing for it.

The listener is process-wide, not per thread: a remat'd period is
recomputed inside the backward, which autograd runs on a thread of its own
for a CUDA device.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

#: What listens to the scopes: an object with ``enter(name, work, peak)``
#: and ``exit(name)``, or None.
_listener = None


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Scope:
    __slots__ = ("listener", "name", "work", "peak")

    def __init__(self, listener, name, work, peak):
        self.listener, self.name, self.work, self.peak = listener, name, work, peak

    def __enter__(self):
        self.listener.enter(self.name, self.work, self.peak)
        return None

    def __exit__(self, *exc):
        self.listener.exit(self.name)
        return False


def kernel_scope(name: str, work: Callable[[], Tuple[int, int]], peak: str):
    """A ``with`` block around one call of the kernel ``name``: ``work()``
    gives (FLOPs, bytes) of the call, evaluated only where a listener is
    on; ``peak`` names the arithmetic the FLOPs run at ("bfloat16" for the
    tensor cores' rate, "float32" for the fp32 cores')."""
    listener = _listener
    if listener is None:
        return _NULL
    return _Scope(listener, name, work, peak)


def set_listener(listener) -> Optional[object]:
    """Install ``listener`` (None removes it); returns the one it replaces."""
    global _listener
    before, _listener = _listener, listener
    return before
