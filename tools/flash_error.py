#!/usr/bin/env python3
"""How close the bf16 flash-attention forward's output and log-sum-exp lie
to a float64 evaluation on the same bf16 inputs.

    python3 tools/flash_error.py [ROOT]     # one CUDA device, ~20 s

ROOT is the checkout whose `repro_torch` is measured (default: this one),
so two commits can be held side by side on one card.  At zamba2-7b's
attention heads (32 over 32, d_head 112) and granite-3-2b's (32 over 8,
d_head 64), causal over 2 x 2048 positions, with q and k at unit and at
three times unit scale, prints the largest and mean |error| of the output
and its mean (bias), beside the mean |error| of rounding the float64
output to bf16 once (the least any bf16 kernel can have), and the same of
the fp32 log-sum-exp.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

# (B, S, Hq, Hkv, D, scale of q and k)
CASES = [(2, 2048, 32, 32, 112, 1.0), (2, 2048, 32, 32, 112, 3.0),
         (2, 2048, 32, 8, 64, 1.0), (2, 2048, 32, 8, 64, 3.0)]


def reference(q, k, v):
    """Causal attention and its log-sum-exp in float64, (B, S, H, D) and
    (B, Hkv, G, S)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qd = q.double().transpose(1, 2)
    kd, vd = (t.double().transpose(1, 2).repeat_interleave(Hq // Hkv, 1) for t in (k, v))
    s = qd @ kd.transpose(-1, -2) / D ** 0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1), -torch.inf)
    return (torch.softmax(s, -1) @ vd).transpose(1, 2), torch.logsumexp(s, -1).reshape(
        B, Hkv, Hq // Hkv, S)


def main():
    if not torch.cuda.is_available():
        print("flash_error: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator("cuda").manual_seed(0)
    print(f"root {ROOT}, {torch.cuda.get_device_name(0)}")
    for B, S, Hq, Hkv, D, scale in CASES:
        q, k = ((torch.randn(B, S, h, D, device="cuda", generator=gen) * scale).bfloat16()
                for h in (Hq, Hkv))
        v = torch.randn(B, S, Hkv, D, device="cuda", generator=gen).bfloat16()
        out, lse = flash_attention(q, k, v, True)
        want, want_lse = reference(q, k, v)
        err, once = out.double() - want, want.bfloat16().double() - want
        lerr = lse.double() - want_lse
        print(f"(B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, q/k scale {scale}): out |err| max "
              f"{err.abs().max():.4e} mean {err.abs().mean():.4e} bias {err.mean():.3e} "
              f"(one rounding: mean {once.abs().mean():.4e}); lse |err| max "
              f"{lerr.abs().max():.3e} mean {lerr.abs().mean():.3e} bias {lerr.mean():.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
