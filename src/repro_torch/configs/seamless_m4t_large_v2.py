"""seamless-m4t-large-v2 — encoder-decoder backbone (arXiv:2308.11596).
24 encoder + 24 decoder layers, d_model 1024, 16 heads, d_ff 8192,
vocab 256206.  The speech/text frontend is a STUB: `input_specs()` feeds
precomputed frame embeddings (B, S_enc, d) to the encoder."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    ffn_type="gelu",
    frontend_stub=True,
)
