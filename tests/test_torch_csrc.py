"""The port's kernels are its own: no source under flashattn_tpu_torch/csrc/
includes or calls a library's kernel (cuBLAS, cuBLASLt, cuDNN, cuSPARSE,
CUTLASS's device-level GEMMs), and the build links no library, so none can
stand in for a hand-written kernel. Comments may name a library; code may
not."""

import re

import pytest

from flashattn_tpu_torch.ops import _build

SOURCES = sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh"))

# What a library kernel looks like in C++: its headers, its handles and calls.
LIBRARY_PATTERNS = [
    re.compile(r"cublas", re.IGNORECASE),  # cublas_v2.h, cublasLt.h, cublasGemmEx, ...
    re.compile(r"cudnn", re.IGNORECASE),
    re.compile(r"cusparse", re.IGNORECASE),
    re.compile(r"cutlass/gemm/device"),  # CUTLASS 2 device-level GEMMs
    re.compile(r"cutlass::gemm::device"),  # and CUTLASS 3's GemmUniversalAdapter
    re.compile(r"GemmUniversalAdapter|DeviceGemm"),
]


def strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.DOTALL)
    return re.sub(r"//[^\n]*", "", text)


def library_uses(text: str) -> list[str]:
    """Every match of a library pattern in the code (comments removed)."""
    code = strip_comments(text)
    return [m.group(0) for p in LIBRARY_PATTERNS for m in p.finditer(code)]


def test_every_kernel_library_has_its_source():
    names = {p.name for p in SOURCES}
    assert {f"{lib}.cu" for lib in _build.ENTRY_POINTS} <= names
    assert "common.cuh" in names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_kernel_source_uses_no_library_kernel(path):
    assert library_uses(path.read_text()) == []


@pytest.mark.parametrize("snippet", [
    "#include <cublas_v2.h>",
    "cublasLtMatmul(handle, desc, &alpha, a, la, b, lb, &beta, c, lc, d, ld, 0, 0, 0, s);",
    "#include <cudnn.h>",
    "#include \"cutlass/gemm/device/gemm.h\"",
    "using Gemm = cutlass::gemm::device::GemmUniversalAdapter<Kernel>;",
    "cusparseSpMM(h, opA, opB, &a, A, B, &b, C, t, alg, buf);",
])
def test_scan_finds_library_kernels(snippet):
    assert library_uses(f"// a kernel\n{snippet}\n__global__ void k() {{}}\n")
    assert not library_uses(f"// {snippet}\n/* {snippet} */\n__global__ void k() {{}}\n")


def test_build_links_no_library():
    assert not [f for f in _build.NVCC_FLAGS if f.startswith(("-l", "-L", "--library"))]
