"""zamba2-7b — hybrid Mamba2 stack with a weight-SHARED attention block
(arXiv:2411.15242).  81 Mamba2 layers (d_model 3584, state 64) with the
shared full-attention+MLP block applied every 6 layers; 32 heads (kv=32 ⇒
MHA) and d_ff 14336 for the shared block."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    mamba_headdim=64,
    shared_attn_every=6,
    ffn_type="gelu",
)
