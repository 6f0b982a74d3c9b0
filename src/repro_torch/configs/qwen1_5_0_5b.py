"""qwen1.5-0.5b — small dense decoder, QKV bias, MHA (kv == heads).
[hf:Qwen/Qwen1.5-0.5B]: 24L, d_model 1024, 16 heads (kv 16), d_ff 2816,
vocab 151936."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    ffn_type="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
