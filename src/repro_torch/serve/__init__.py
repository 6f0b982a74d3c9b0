"""Serving substrate: prefill/decode steps + continuous-batching engine."""
from .engine import (  # noqa: F401
    Request, ServeEngine, make_decode_step, make_prefill_step, sample,
)
