"""Plain PyTorch versions of every ported kernel, under kernel-oriented
names.  They delegate to the model layer (one source of truth) and are what
the kernels are held against."""

from __future__ import annotations

from repro_torch.models.attention import gqa_reference
from repro_torch.models.layers import rms_norm as _rms_norm_model
from repro_torch.models.ssm import ssd_chunked, ssd_reference


def flash_attention_ref(q, k, v, causal: bool = True):
    """(B,Sq,Hq,D) GQA attention, fp32 softmax (the output alone)."""
    return gqa_reference(q, k, v, causal=causal)


def decode_attention_ref(q, k_cache, v_cache, kv_len):
    """One-token decode against a (B,Sk,Hkv,D) cache with valid prefix."""
    return gqa_reference(q, k_cache, v_cache, causal=False, kv_len=kv_len)


def rms_norm_ref(x, scale, eps: float = 1e-5):
    return _rms_norm_model(x, scale, eps)


def ssm_scan_ref(x, Bm, Cm, dt, A_log, D, chunk: int = 64):
    """Chunked SSD (itself held against the sequential `ssd_reference`)."""
    return ssd_chunked(x, Bm, Cm, dt, A_log, D, chunk)


def ssm_scan_sequential_ref(x, Bm, Cm, dt, A_log, D):
    return ssd_reference(x, Bm, Cm, dt, A_log, D)
