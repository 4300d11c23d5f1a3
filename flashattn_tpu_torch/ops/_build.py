"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each kernel file compiles with nvcc into its own shared library with a plain
C interface, which ctypes loads. The build runs at first use, goes to
``build/flashattn_tpu_torch/`` beside the package, and is keyed on a hash of
the sources, so an edited kernel rebuilds and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "flashattn_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# C signatures of each library's entry points: {function: argtypes}.
ENTRY_POINTS = {
    "flash_fwd": {"flash_fwd_launch": [_P] * 10 + [_I] * 10 + [_F, _F, _P]},
    "decode": {"decode_launch": [_P] * 13 + [_I] * 15 + [_F, _F, _F, _P]},
    "quant_matmul": {"quant_matmul_launch": [_P] * 5 + [_I] * 7 + [_P],
                     "quant_matmul_a8_launch": [_P] * 6 + [_I] * 6 + [_P],
                     "quantize_rows_launch": [_P] * 3 + [_I] * 3 + [_P]},
    "flash_bwd": {"flash_bwd_dq_launch": [_P] * 13 + [_I] * 10 + [_F] * 3 + [_P],
                  "flash_bwd_dkv_launch": [_P] * 13 + [_I] * 10 + [_F] * 3 + [_P]},
    "flash_bwd_fused": {"flash_bwd_fused_launch": [_P] * 15 + [_I] * 10 + [_F] * 3 + [_P]},
}
# The library of a kernel's ALiBi instantiations has its sibling's entry points.
ENTRY_POINTS.update({f"{name}_alibi": ENTRY_POINTS[name]
                     for name in ("decode", "flash_bwd", "flash_bwd_fused")})
# So do K2's libraries of the D 256 instantiations.
ENTRY_POINTS.update({f"{name}_d256": ENTRY_POINTS["decode"]
                     for name in ("decode", "decode_alibi")})
# The dropout libraries' take the dropout's seed (a pointer to it on the
# device), threshold and scale before the stream (ops/flash_fwd.py::dropout_args).
ENTRY_POINTS.update({f"{name}_dropout": {fn: args[:-1] + [_P, _U, _F, _P]
                                         for fn, args in ENTRY_POINTS[name].items()}
                     for name in ("flash_fwd", "flash_bwd", "flash_bwd_fused")})
# The libraries of the offset read on the card take a pointer to it before the
# stream (ops/flash_fwd.py::device_offset), those with dropout too after the
# dropout's arguments.
ENTRY_POINTS.update({f"{name}_dynoff{drop}": {fn: args[:-1] + [_P, _P]
                                              for fn, args in ENTRY_POINTS[name + drop].items()}
                     for name in ("flash_fwd", "flash_bwd", "flash_bwd_fused")
                     for drop in ("", "_dropout")})

_loaded: dict[str, ctypes.CDLL] = {}
# Seconds spent compiling per library in this process (0.0 when loaded from
# an earlier build).
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build on a "
            "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a build of the same sources exists.

    The compiler's report (registers, shared memory, spills) is kept beside
    the library as <library>.log."""
    lib = library_path(name)
    if lib.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # Compile to a private name and rename: concurrent builders never load a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return lib


def build_all(names) -> None:
    """Build several libraries at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, its entry points typed."""
    if name not in _loaded:
        cdll = ctypes.CDLL(str(build(name)))
        for fn_name, argtypes in ENTRY_POINTS[name].items():
            fn = getattr(cdll, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        cdll.error_string.argtypes = [ctypes.c_int]
        cdll.error_string.restype = ctypes.c_char_p
        _loaded[name] = cdll
    return _loaded[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
