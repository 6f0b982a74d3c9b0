"""qwen2-vl-2b — VLM decoder backbone with M-RoPE (arXiv:2409.12191).
28L, d_model 1536, 12 heads (kv 2), d_ff 8960, vocab 151936.  The dynamic-
resolution ViT frontend is a STUB: `input_specs()` provides patch embeddings
(B, P, d) + 3D (t,h,w) position ids; M-RoPE sections (16,24,24) over
d_head/2 = 64 follow the released config."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    ffn_type="swiglu",
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    vision_stub_patches=256,
)
