"""Data sources for the torch port: numpy batches, moved to the device by
the trainer."""

from .pipeline import (  # noqa: F401
    ByteTokenizer,
    DataConfig,
    Prefetcher,
    SyntheticLM,
    TextFileLM,
)
