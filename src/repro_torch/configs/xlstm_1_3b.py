"""xlstm-1.3b — xLSTM stack, [7:1] mLSTM:sLSTM ratio (Beck et al. 2024,
arXiv:2405.04517): 48 blocks, d_model 2048, 4 heads, vocab 50304, d_ff 0
(the mixers carry their own up/down projections, proj_factor 2).
Interpretation note: the assignment's "(GQA kv=4)" denotes the 4-head
recurrent structure; xLSTM has no KV cache — state is O(1)."""

from repro_torch.models.config import (
    BLOCK_MLSTM,
    BLOCK_SLSTM,
    ModelConfig,
)

_PATTERN = tuple(
    BLOCK_SLSTM if (i % 8 == 7) else BLOCK_MLSTM for i in range(48)
)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_head=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    ssm_expand=2,
    tie_embeddings=True,
)
