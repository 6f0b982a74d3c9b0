"""What the build reports about each kernel instance, read from the
compiler's text: registers and spills from ptxas's ``-v`` lines, and
tensor-core instructions from ``cuobjdump -sass``.  chip_smoke.py's build
line prints them and fails when a tensor-core instance holds none of its
kind (HMMA for mma.sync, HGMMA for wgmma); here the parsers run on fixed
samples of both tools' output."""

import shutil

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel_instance
from repro_torch.kernels.flash_attention import kernel_instance as flash_instance

FLASH_BF16 = ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_c45a2b1821flash_fwd_bf16_kernel"
              "ILi64ELb0EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiifi")
SSM_F32 = ("_ZN44_GLOBAL__N__b4ec31e4_11_ssm_scan_cu_d2e4a81715ssm_scan_kernelEPKfS1_S1_S1_S1"
           "_S1_PfS2_iiiiixxxxxx")

PTXAS = f"""== flash_attention.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{FLASH_BF16}' for 'sm_90a'
ptxas info    : Function properties for {FLASH_BF16}
    56 bytes stack frame, 56 bytes spill stores, 64 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 56 bytes cumulative stack size
== ssm_scan.cu
ptxas info    : Compiling entry function '{SSM_F32}' for 'sm_90a'
ptxas info    : Function properties for {SSM_F32}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 153 registers, used 1 barriers
"""

SASS = f"""
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : {FLASH_BF16}
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;
        /*0020*/              @!P0 HMMA.16816.F32.BF16 R28, R4, R22, R28 ;
        /*0030*/                   LDSM.16.M88.4 R8, [R2] ;
\t\t..........

\t\tFunction : {SSM_F32}
        /*0000*/                   FFMA R3, R4, R5, R3 ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
"""


def test_parse_ptxas_reads_registers_and_spills_per_kernel():
    got = _build.parse_ptxas(PTXAS)
    assert got == {FLASH_BF16: {"registers": 128, "spill_bytes": 120},
                   SSM_F32: {"registers": 153, "spill_bytes": 0}}
    assert _build.parse_ptxas("no ptxas lines here") == {}


def test_parse_ptxas_marks_a_kernel_whose_wgmma_ptxas_serialized():
    text = (f"ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async instructions "
            f"are serialized due to insufficient register resources for the wgmma pipeline in "
            f"the function '{FLASH_BF16}'\n" + PTXAS)
    got = _build.parse_ptxas(text)
    assert got[FLASH_BF16] == {"registers": 128, "spill_bytes": 120, "wgmma_serialized": 1}
    assert "wgmma_serialized" not in got[SSM_F32]


@pytest.mark.parametrize("opcode,flash,ssm", [("HMMA", 2, 0), ("FFMA", 0, 1), ("LDSM", 1, 0)])
def test_count_sass_counts_an_opcode_per_function(opcode, flash, ssm):
    assert _build.count_sass(SASS, opcode) == {FLASH_BF16: flash, SSM_F32: ssm}


def test_demangle_keeps_the_kernel_and_its_template_arguments():
    if shutil.which("c++filt") is None and shutil.which("cu++filt") is None:
        assert _build.demangle([FLASH_BF16]) == {FLASH_BF16: FLASH_BF16}
        return
    assert _build.demangle([FLASH_BF16, SSM_F32]) == {
        FLASH_BF16: "flash_fwd_bf16_kernel<64, false>", SSM_F32: "ssm_scan_kernel"}
    assert _build.demangle([]) == {}


DECODE_TC = ("_ZN52_GLOBAL__N__1f2e3d4c_19_decode_attention_cu_9a8b7c6d21decode_bf16_tc_kernel"
             "ILi128ELb0EEEvPK13__nv_bfloat16S3_S3_PKiPS1_PfS7_S7_iiiiifi")


def test_the_tensor_core_decode_instance_reads_under_the_name_the_wrapper_gives():
    """The tensor-core decode instance's lines, read as the build line reads
    them, under the name `kernel_instance` gives chip_smoke.py's timing."""
    ptxas = f"""== decode_attention.cu
ptxas info    : Compiling entry function '{DECODE_TC}' for 'sm_90a'
ptxas info    : Function properties for {DECODE_TC}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
"""
    sass = f"""\t\tFunction : {DECODE_TC}
        /*0000*/                   HMMA.16816.F32.BF16 R8, R12, R4, R8 ;
        /*0010*/                   MOVM.16.MT88 R4, R6 ;
        /*0020*/                   HMMA.16816.F32.BF16 R16, R12, R2, R16 ;
"""
    assert _build.parse_ptxas(ptxas) == {DECODE_TC: {"registers": 96, "spill_bytes": 0}}
    assert _build.count_sass(sass, "HMMA") == {DECODE_TC: 2}
    assert _build.count_sass(sass, "MOVM") == {DECODE_TC: 1}
    if shutil.which("c++filt") is None and shutil.which("cu++filt") is None:
        return
    assert _build.demangle([DECODE_TC]) == {DECODE_TC: kernel_instance(torch.bfloat16, 6, 128)}


FLASH_WGMMA = ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_c45a2b1822flash_fwd_wgmma_kernel"
               "ILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiiifi")


def test_the_wgmma_flash_instance_counts_hgmma_and_reads_under_the_wrappers_name():
    """wgmma shows in SASS as HGMMA (not HMMA): the build line counts both
    opcodes, each by its own name, and the bf16 flash instance reads under
    the name `kernel_instance` gives chip_smoke.py's timing rows."""
    sass = f"""\t\tFunction : {FLASH_WGMMA}
        /*0000*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0030*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR12], R88 ;
        /*0040*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\tFunction : {DECODE_TC}
        /*0000*/                   HMMA.16816.F32.BF16 R8, R12, R4, R8 ;
"""
    assert _build.count_sass(sass, "HGMMA") == {FLASH_WGMMA: 3, DECODE_TC: 0}
    assert _build.count_sass(sass, "HMMA") == {FLASH_WGMMA: 0, DECODE_TC: 1}
    assert _build.TENSOR_CORE_OPCODES == ("HMMA", "HGMMA")
    assert {flash_instance(d) for d in (8, 32, 64)} == {"flash_fwd_wgmma_kernel<64>"}
    assert {flash_instance(d) for d in (72, 96, 112, 128)} == {"flash_fwd_wgmma_kernel<128>"}
    if shutil.which("c++filt") is None and shutil.which("cu++filt") is None:
        return
    assert _build.demangle([FLASH_WGMMA]) == {FLASH_WGMMA: flash_instance(64)}
