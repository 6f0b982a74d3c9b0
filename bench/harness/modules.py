"""Which forbidden packages a process has loaded.

The port must run without JAX and without the JAX package it was ported
from.  The port's own name, ``repro_torch``, begins with that package's,
``repro``, so names are compared whole, by the part before the first dot:
``repro.models`` is forbidden, ``repro_torch.models`` is not."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules this process has loaded), sorted."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
