"""Model substrate of the torch port: every architecture family of the
reference, for serving and training."""

from .config import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    reduced,
)
from .transformer import (  # noqa: F401
    DecoderLM,
    encode,
    forward,
    init_cache,
    init_lm,
    lm_loss,
    logits_fn,
    reset_slot,
    stack_layout,
)
