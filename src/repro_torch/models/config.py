"""Model & input-shape configuration (torch port; pure data, no tensors).

One `ModelConfig` covers all 10 assigned architecture families; per-arch
constructors live in `repro_torch.configs.<id>`.  `ShapeConfig` describes the
assigned input shapes (train_4k / prefill_32k / decode_32k / long_500k).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds used in layer patterns.
BLOCK_ATTN = "attn"        # attention + FFN transformer block
BLOCK_MOE = "moe"          # attention + MoE-FFN block
BLOCK_MAMBA2 = "mamba2"    # Mamba2 SSD block
BLOCK_MLSTM = "mlstm"      # xLSTM mLSTM block
BLOCK_SLSTM = "slstm"      # xLSTM sLSTM block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 → d_model // n_heads

    # --- attention ---
    qkv_bias: bool = False          # Qwen1.5-style biases on Q/K/V
    rope_theta: float = 10_000.0
    mrope: bool = False             # Qwen2-VL multimodal RoPE (3D positions)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w dims of d_head/2

    # --- ffn ---
    ffn_type: str = "swiglu"        # swiglu | gelu | relu2
    ffn_bias: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss_coef: float = 1e-2

    # --- SSM / recurrent ---
    ssm_state: int = 0              # Mamba2 state dim N
    ssm_conv: int = 4               # depthwise conv width
    ssm_expand: int = 2             # Mamba2 d_inner = expand * d_model
    ssm_chunk: int = 64             # SSD chunk length
    mlstm_chunk: int = 256          # chunkwise-mLSTM chunk length
    mamba_headdim: int = 64         # Mamba2 per-head dim P
    qkv_block: int = 4              # xLSTM block-diagonal q/k/v blocksize
    slstm_expand: int = 1           # sLSTM hidden = slstm_expand · d_model
    # Layer pattern for hybrid / xLSTM stacks.  None → uniform family block.
    # e.g. zamba2: mamba2 everywhere + a SHARED attention block every k layers.
    block_pattern: Optional[Tuple[str, ...]] = None
    shared_attn_every: int = 0      # zamba2: shared attn block period (0=off)

    # --- encoder-decoder ---
    n_encoder_layers: int = 0       # >0 → enc-dec (seamless)
    frontend_stub: bool = False     # audio/vision frontend replaced by embeds

    # --- vlm ---
    vision_stub_patches: int = 0    # #patch embeddings provided by input stub

    # --- numerics & misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    remat: str = "block"            # none | block (checkpoint each layer)
    scan_layers: bool = True        # group uniform layers into one stacked period
    optimizer: str = "adamw"        # adamw | adafactor | adam8bit
    attn_impl: str = "ref"          # ref | flash | flash_decode; kept for parity,
                                    # the port picks kernels by tensor device
    ssm_impl: str = "ref"           # ref | pallas
    bf16_cotangent: bool = False    # §Perf: cast backward activations to bf16
    hoist_rope: bool = False        # §Perf: compute RoPE tables once per step
    psum_barrier: bool = False      # §Perf: stop f32-convert hoisting above TP psums

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError("moe family needs n_experts/top_k")

    # ------------------------------------------------------------- derived
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_pattern(self) -> Tuple[str, ...]:
        if self.block_pattern is not None:
            if len(self.block_pattern) != self.n_layers:
                raise ValueError("block_pattern length != n_layers")
            return self.block_pattern
        default = {
            "dense": BLOCK_ATTN, "encdec": BLOCK_ATTN, "vlm": BLOCK_ATTN,
            "moe": BLOCK_MOE, "ssm": BLOCK_MAMBA2, "hybrid": BLOCK_MAMBA2,
        }[self.family]
        return tuple(default for _ in range(self.n_layers))

    def is_uniform(self) -> bool:
        pat = self.layer_pattern()
        return all(p == pat[0] for p in pat) and self.shared_attn_every == 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, dh = self.d_model, self.d_head
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * dh * n_q + 2 * d * dh * n_kv + dh * n_q * d
        if self.qkv_bias:
            attn += dh * (n_q + 2 * n_kv)
        def ffn_params(ff):
            mult = 3 if self.ffn_type == "swiglu" else 2
            return mult * d * ff
        total = 0
        for kind in self.layer_pattern():
            total += 2 * d  # norms
            if kind == BLOCK_ATTN:
                total += attn + ffn_params(self.d_ff)
            elif kind == BLOCK_MOE:
                total += attn + self.n_experts * ffn_params(self.d_ff) + d * self.n_experts
            elif kind == BLOCK_MAMBA2:
                d_in = self.ssm_expand * d
                h_ssm = max(1, d_in // self.mamba_headdim)
                proj_out = 2 * d_in + 2 * self.ssm_state + h_ssm
                conv_ch = d_in + 2 * self.ssm_state
                total += (d * proj_out + (self.ssm_conv + 1) * conv_ch
                          + 3 * h_ssm + d_in + d_in * d)
            elif kind == BLOCK_MLSTM:
                d_in = self.ssm_expand * d
                total += (d * 2 * d_in                     # up_proj
                          + (self.ssm_conv + 1) * d_in     # conv
                          + 3 * d_in * self.qkv_block      # block-diag q/k/v
                          + d_in * 2 * self.n_heads        # gates
                          + d_in + d_in * d)               # norm + down
            elif kind == BLOCK_SLSTM:
                d_in = self.slstm_expand * d
                p_head = d_in // self.n_heads
                ff = int(d_in * 4 / 3)
                total += (d * d_in + (self.ssm_conv + 1) * d_in
                          + 4 * d_in * d_in                # input gate weights
                          + 4 * d_in * p_head              # block-diag recurrent
                          + d_in + d_in * 2 * ff + ff * d)
        if self.shared_attn_every:
            total += attn + ffn_params(self.d_ff)  # one shared block
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + ffn_params(self.d_ff) + 2 * d)
            total += self.n_layers * (attn + d)  # cross-attention + norm
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 if cfg.shared_attn_every == 0 else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_chunk=16,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        vision_stub_patches=min(cfg.vision_stub_patches, 16),
        block_pattern=None,
        param_dtype="float32",
        compute_dtype="float32",
        name=cfg.name + "-smoke",
    )
    if cfg.block_pattern is not None:
        n = small["n_layers"]
        # Preserve the family mix on a short stack.
        kinds = list(dict.fromkeys(cfg.block_pattern))  # unique, ordered
        small["block_pattern"] = tuple(kinds[i % len(kinds)] for i in range(n))
    if cfg.mrope:
        small["mrope_sections"] = (8, 4, 4)  # sums to d_head/2 = 16
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
