"""Atomic sharded checkpointing, in the reference's on-disk format."""
from .checkpoint import (  # noqa: F401
    CheckpointManager, checkpoint_nbytes, latest_checkpoint, list_checkpoints,
    read_extra, restore, save, shard_count, tree_nbytes,
)
