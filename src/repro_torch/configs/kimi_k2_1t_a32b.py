"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).
61L, d_model 7168, 64 heads (kv 8), 384 experts top-8, expert d_ff 2048,
vocab 163840.  Interpretation: the assignment's d_ff=2048 is the per-expert
hidden (Kimi-K2's moe_intermediate_size); all layers are MoE here (the real
model's single dense first layer is a <0.1 % param deviation).  Trains
with Adafactor-class optimizer states at this size."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    ffn_type="swiglu",
    n_experts=384,
    top_k=8,
    rope_theta=50_000.0,
    optimizer="adafactor",
)
