"""utils/sass.py on the CPU: kernel labels from mangled names, the
instructions of a cuobjdump -sass listing by kernel and their tensor-core
instructions counted, and the comparison of
two builds (a kernel that gained last `false` template arguments matched
with its old form). cuobjdump itself runs only beside nvcc."""

import pytest

from flashattn_tpu_torch.utils import sass


@pytest.mark.parametrize("mangled, label", [
    ("_Z26flash_bwd_fused_mma_kernelILi128ELi0ELb0ELb0ELb0EEvPK13__nv_bfloat16S2_S2_S2_PKfS4_",
     "flash_bwd_fused_mma_kernel<128, 0, false, false, false>"),
    ("_Z22flash_bwd_fused_kernelI13__nv_bfloat16Li64ELb1EEvPKT_S3_S3_S3_PKfS5_PS1_S6_Pf",
     "flash_bwd_fused_kernel<bf16, 64, true>"),
    ("_ZN12_GLOBAL__N_122flash_bwd_fused_kernelIfLi256ELb0EEEvPKT_",
     "flash_bwd_fused_kernel<float, 256, false>"),
    ("_Z5helperv", "_Z5helperv"),
    # an anonymous namespace whose hash ends in digits that read as the
    # length of the rest: the components are read in order
    ("_ZN52_GLOBAL__N__d927b5fe_19_flash_bwd_dynoff_cu_0898312c23flash_bwd_dq_mma_kernel"
     "ILi128ELi1ELb0ELb0ELb0ELb1EEEvPK13__nv_bfloat16S3_",
     "flash_bwd_dq_mma_kernel<128, 1, false, false, false, true>"),
    ("_ZN52_GLOBAL__N__d92759ac_19_flash_bwd_dynoff_cu_0898312c23flash_bwd_dq_mma_kernel"
     "ILi64ELi2ELb0ELb1ELb0ELb1EEEvPK13__nv_bfloat16S3_",
     "flash_bwd_dq_mma_kernel<64, 2, false, true, false, true>"),
])
def test_kernel_label(mangled, label):
    assert sass.kernel_label(mangled) == label


LISTING = """
	code for sm_90a
		Function : _Z26flash_bwd_fused_mma_kernelILi128ELi0ELb0ELb0ELb0EEvPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
                                                                              /* 0x000fe20000000800 */
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;      /* 0x0000000c0804723c */
                                                                              /* 0x000fe20000041804 */
        /*0020*/              @!P0 EXIT ;                                     /* 0x000000000000894d */
		..........
		Function : _Z22flash_bwd_fused_kernelI13__nv_bfloat16Li64ELb1EEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
"""


def test_kernels_by_label():
    got = sass.kernels(LISTING)
    assert got == {
        "flash_bwd_fused_mma_kernel<128, 0, false, false, false>": [
            "LDC R1, c[0x0][0x28]", "HMMA.16816.F32.BF16 R4, R8, R12, R4", "@!P0 EXIT"],
        "flash_bwd_fused_kernel<bf16, 64, true>": ["LDC R1, c[0x0][0x28]"],
    }


def test_tensor_core_counts_equal_the_kernels_instructions():
    """The counts read without splitting the listing into lines are those
    of sass.kernels' instructions."""
    want = {label: {op: sum(ins.startswith(op + ".") for ins in instructions)
                    for op in ("HMMA", "HGMMA", "IMMA")}
            for label, instructions in sass.kernels(LISTING).items()}
    assert sass.tensor_core_counts(LISTING) == want
    assert want["flash_bwd_fused_mma_kernel<128, 0, false, false, false>"]["HMMA"] == 1


def test_compare_matches_a_kernel_that_gained_a_false_flag():
    old = {"k<128, 0>": ["FADD R1, R2, R3", "EXIT"], "k<64, 0>": ["EXIT"],
           "m<1>": ["@P0 FSEL R20, R20, R173, P1", "FMUL R21, R20, UR9"], "n<1>": ["EXIT"]}
    new = {"k<128, 0, false>": ["FADD R1, R2, R3", "EXIT"], "k<64, 0, false>": ["EXIT", "EXIT"],
           "k<128, 0, true>": ["BRA"],
           "m<1>": ["FMUL R21, R21, UR9", "@P0 FSEL R21, R20, R173, P1"], "n<1>": ["@!P2 EXIT"]}
    same, differ = sass.compare(old, new)
    assert same == ["k<128, 0>"]
    assert differ == [("k<64, 0>", 1, 2, False), ("m<1>", 2, 2, True), ("n<1>", 1, 1, True)]


def test_compare_matches_a_kernel_that_gained_two_false_flags():
    """K1's kernel of the offset read on the card gained the soft-cap's and
    dropout's flags last: its instantiations without them match the old
    kernels; a label that ends in `true` is not stripped."""
    old = {"d<64, 1, true, false, false>": ["FADD R1, R2, R3", "EXIT"]}
    new = {"d<64, 1, true, false, false, false, false>": ["FADD R1, R2, R3", "EXIT"],
           "d<64, 1, true, false, false, true, false>": ["BRA"]}
    assert sass.old_form("d<64, 1, true, false, false, true, false>", old) == \
        "d<64, 1, true, false, false, true>"
    same, differ = sass.compare(old, new)
    assert same == ["d<64, 1, true, false, false>"] and differ == []
