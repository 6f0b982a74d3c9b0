"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit).  A card set below that limit runs
slower under load: each run reports the limit beside its numbers."""

BF16_FLOPS = 989e12        # tensor cores, bf16 in, fp32 accumulate
FP32_FLOPS = 67e12         # fp32 cores, a fused multiply-add counted as two
HBM_BYTES_S = 3.35e12      # HBM3


def least_time(ops: float, nbytes: float, flops: float = BF16_FLOPS) -> float:
    """Seconds the card needs at least for ``ops`` operations at ``flops``
    and ``nbytes`` moved to or from HBM: the larger of the two."""
    return max(ops / flops, nbytes / HBM_BYTES_S)
