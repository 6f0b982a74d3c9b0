"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
repository's root (the repository's tier-1 run collects ``tests/`` only).

Tests that need a card carry the ``chip`` marker and skip without one; a
test decides that when it runs (the `card` fixture), never at import."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Small configurations of the two families, in float32 (the port's plain
#: path and the reference agree to rounding) and bfloat16.
TINY = {
    "tiny-dense": {"name": "tiny-dense", "source": "tests", "family": "dense", "n_layers": 2,
                   "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 128,
                   "vocab_size": 256, "ffn_type": "swiglu", "tie_embeddings": True,
                   "rope_theta": 10000.0, "norm_eps": 1e-5, "param_dtype": "float32",
                   "compute_dtype": "float32", "logit_dtype": "float32", "remat": "block",
                   "optimizer": "adamw"},
    "tiny-hybrid": {"name": "tiny-hybrid", "source": "tests", "family": "hybrid", "n_layers": 5,
                    "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_head": 16, "d_ff": 128,
                    "vocab_size": 256, "ffn_type": "gelu", "tie_embeddings": False,
                    "rope_theta": 10000.0, "norm_eps": 1e-5, "ssm_state": 16, "ssm_expand": 2,
                    "ssm_conv": 4, "ssm_chunk": 16, "mamba_headdim": 16, "shared_attn_every": 2,
                    "param_dtype": "float32", "compute_dtype": "float32",
                    "logit_dtype": "float32", "remat": "block", "optimizer": "adamw"},
}
#: The port's Zamba2-shaped hybrid at zamba2-7b's widths and 39 layers, for
#: the full-size checks of the layout and the work counts (no cell runs it).
WIDE_HYBRID = {"name": "wide-hybrid", "family": "hybrid", "n_layers": 39, "d_model": 3584,
               "n_heads": 32, "n_kv_heads": 32, "d_head": 112, "d_ff": 14336, "vocab_size": 32000,
               "ffn_type": "gelu", "tie_embeddings": False, "rope_theta": 10000.0,
               "norm_eps": 1e-05, "ssm_state": 64, "ssm_expand": 2, "ssm_conv": 4,
               "ssm_chunk": 64, "mamba_headdim": 64, "shared_attn_every": 6,
               "param_dtype": "bfloat16", "compute_dtype": "bfloat16", "logit_dtype": "float32",
               "remat": "block", "optimizer": "adamw"}

TINY_TRAFFIC = {"kind": "train", "batch": 2, "seq": 64, "loss_chunk": 16, "checked_steps": 3,
                "trace_steps": 2,
                "optimizer": {"lr": 0.0003, "warmup": 1, "total_steps": 100000, "b1": 0.9,
                              "b2": 0.95, "eps": 1e-08, "weight_decay": 0.1, "grad_clip": 1.0}}


def tiny(name: str, dtype: str = "float32"):
    cfg = dict(TINY[name], param_dtype=dtype, compute_dtype=dtype)
    if dtype != "float32":
        cfg["name"] = f"{name}-{dtype}"
    return cfg


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda")


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))
