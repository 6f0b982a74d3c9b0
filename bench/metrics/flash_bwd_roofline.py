"""Flash attention's gradient's share of its least time, in %
(`csrc/flash_attention_bwd.cu`: the dq and dk/dv passes, bf16 and
fp32)."""

from harness.roofline import share

KERNELS = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
           "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")


def read(run):
    return share(run, "flash_bwd", KERNELS)
