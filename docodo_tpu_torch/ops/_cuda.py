"""Build and bind the slice's CUDA kernels (csrc/locate_full.cu).

The source compiles with `nvcc` into a shared library with a plain C
interface on first use, under `build/docodo_tpu_torch/` at the root of
the checkout, keyed by a hash of the source and the flags, and loads
through ctypes. Nothing here runs at import: the CPU tests import every
module on a machine with no CUDA compiler.

Each entry point launches on PyTorch's current stream and returns
cudaGetLastError(); a launch that returns anything else raises. A
`Kernel` counts its own launches, so a run can show which kernels the
main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "locate_full.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "docodo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"locate_full_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library if it is not built yet; returns the seconds
    spent. The compiler's report (registers, shared memory, spills per
    kernel) is kept in `build_log`."""
    global build_log
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.docodo_sorted_and_locate_full.argtypes = (
        [p] * 8 + [i] * 4 + [p] * 7)
    lib.docodo_single_locate_full.argtypes = [p] * 3 + [i] * 4 + [p] * 7
    lib.docodo_union_locate_full.argtypes = [p] * 3 + [i] * 4 + [p] * 7
    for fn in (lib.docodo_sorted_and_locate_full,
               lib.docodo_single_locate_full,
               lib.docodo_union_locate_full):
        fn.restype = ctypes.c_int
    lib.docodo_cuda_error_string.argtypes = [i]
    lib.docodo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        build()
        _lib = _bind(ctypes.CDLL(str(library_path())))
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class Kernel:
    """One C entry point of the library and the count of its launches."""

    def __init__(self, symbol: str, max_lanes: int):
        self.symbol = symbol
        self.max_lanes = max_lanes
        self.launches = 0

    def __call__(self, inputs, n: int, kpad: int, hpad: int):
        """inputs: the pointer arguments in the C entry point's order,
        int32 [rows, cap] posting/page blocks and [rows] per-row scalars;
        n: the stream width a row makes. Returns (pg_c, rk_c, ct_c,
        n_pages, n_hits, hits)."""
        rows, cap = inputs[0].shape
        if not 0 < n <= self.max_lanes:
            raise ValueError(f"{self.symbol}: stream width {n} outside "
                             f"(0, {self.max_lanes}]")
        if not (0 < kpad <= n and 0 < hpad <= n):
            raise ValueError(f"{self.symbol}: kpad {kpad} / hpad {hpad} "
                             f"outside (0, {n}]")
        for k, t in enumerate(inputs):
            _check(t, f"input {k}", torch.int32,
                   (rows, cap) if t.dim() == 2 else (rows,))
        dev = inputs[0].device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        outs = (torch.empty((rows, kpad), **i32),
                torch.empty((rows, kpad), **f32),
                torch.empty((rows, kpad), **f32),
                torch.empty((rows,), **i32),
                torch.empty((rows,), **i32),
                torch.empty((rows, hpad), **i32))
        lib = library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = getattr(lib, self.symbol)(
                *[t.data_ptr() for t in inputs], rows, cap, kpad, hpad,
                *[t.data_ptr() for t in outs], stream)
        if rc != 0:
            msg = lib.docodo_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg} ({rc})")
        self.launches += 1
        return outs


SORTED_AND = Kernel("docodo_sorted_and_locate_full", 1024)
SINGLE = Kernel("docodo_single_locate_full", 128)
UNION = Kernel("docodo_union_locate_full", 1024)
KERNELS = {"sorted_and_locate_full": SORTED_AND,
           "single_locate_full": SINGLE,
           "union_locate_full": UNION}
