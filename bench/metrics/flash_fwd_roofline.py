"""The flash-attention forward's share of its least time, in %
(`csrc/flash_attention.cu`: the bf16 `flash_fwd_wgmma_kernel`, the fp32
`flash_fwd_kernel`)."""

from harness.roofline import share

KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")


def read(run):
    return share(run, "flash_fwd", KERNELS)
