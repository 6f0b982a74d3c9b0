"""qwen1.5-110b — dense GQA decoder with QKV bias (Qwen1.5 family trait).
[hf:Qwen/Qwen1.5-110B]: 80L, d_model 8192, 64 heads (kv 8), d_ff 49152,
vocab 152064.  Trains with Adafactor-class optimizer states at this size."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    ffn_type="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    optimizer="adafactor",
)
