"""nemotron-4-15b — dense GQA decoder with squared-ReLU MLP.
[arXiv:2402.16819]: 32L, d_model 6144, 48 heads (kv 8), d_ff 24576,
vocab 256000.  Nemotron-4 uses squared-ReLU (no gating) and RoPE."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    ffn_type="relu2",
    rope_theta=10_000.0,
)
