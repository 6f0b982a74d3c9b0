"""RMSNorm's share of its least time, forward and gradient together, in %
(`csrc/rmsnorm.cu`: `rms_norm_kernel`, `rms_norm_bwd_kernel` and the
gradient's `rms_dscale_sum_kernel`)."""

from harness.roofline import share

KERNELS = ("rms_norm_kernel", "rms_norm_bwd_kernel", "rms_dscale_sum_kernel")


def read(run):
    return share(run, "rms_norm", KERNELS)
