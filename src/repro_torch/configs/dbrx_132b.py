"""dbrx-132b — fine-grained MoE (hf:databricks/dbrx-base).
40L, d_model 6144, 48 heads (kv 8), 16 experts top-4, expert d_ff 10752,
vocab 100352."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    ffn_type="swiglu",
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    optimizer="adafactor",
)
