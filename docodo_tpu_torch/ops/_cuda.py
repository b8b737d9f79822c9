"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source compiles with `nvcc` into an object, all sources at once,
and the objects link into one shared library with a plain C interface,
on first use, under `build/docodo_tpu_torch/` at the root of the
checkout, keyed by a hash of the sources and the flags; it loads through
ctypes. Nothing here runs at import: the CPU tests import every module
on a machine with no CUDA compiler.

Each entry point launches on PyTorch's current stream and returns
cudaGetLastError(); a launch that returns anything else raises. A
`Kernel` counts its own launches, so a run can show which kernels the
main path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "locate_full.cu", CSRC / "chunked.cu",
           CSRC / "variants.cu", CSRC / "probes.cu", CSRC / "fetch.cu")
HEADERS = (CSRC / "common.cuh", CSRC / "slot_row.cuh",
           CSRC / "w1_kernel.cuh", CSRC / "tile_scan.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "docodo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()  # the first loads and bindings, from any thread
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
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"docodo_kernels_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library if it is not built yet; returns the seconds
    spent. The compiler's report (registers, shared memory, spills per
    kernel) is kept in `build_log`."""
    global build_log
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [src.name for src, p in zip(SOURCES, procs) if p.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True)
    build_log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{build_log}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be (once, whichever
    thread asks first)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                build()
                lib = ctypes.CDLL(str(library_path()))
                lib.docodo_cuda_error_string.argtypes = [ctypes.c_int]
                lib.docodo_cuda_error_string.restype = ctypes.c_char_p
                _lib = lib
    return _lib


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of dtype and shape."""
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
    """One C entry point of the library and the count of its launches,
    which threads that launch at once add to under a lock.

    `signature` spells the C arguments before the stream: "p" a device
    pointer (a tensor, or None for a null pointer), "i" an int."""

    def __init__(self, symbol: str, signature: str):
        self.symbol = symbol
        self.signature = signature
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fn = None

    def _bound(self):
        lib = library()
        with _lib_lock:
            if self._fn is None:
                fn = getattr(lib, self.symbol)
                kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
                fn.argtypes = [kinds[c] for c in self.signature] + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on `device`'s current stream; raises on a launch error."""
        if len(args) != len(self.signature):
            raise TypeError(f"{self.symbol} takes {len(self.signature)} "
                            f"arguments, got {len(args)}")
        conv = [int(a) if kind == "i" else None if a is None
                else a.data_ptr() for kind, a in zip(self.signature, args)]
        fn = self._fn or self._bound()
        # the device context costs microseconds; enter it only to change
        # the current device
        if device.index is None or device.index == torch.cuda.current_device():
            rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = library().docodo_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg} ({rc})")
        with self._count_lock:
            self.launches += 1


def full_result(kernel: Kernel, inputs, n: int, max_lanes: int, kpad: int,
                hpad: int, topk_mode: bool = False):
    """Launch one of the full-result slot kernels of locate_full.cu.
    inputs: the pointer arguments in the C entry point's order, int32
    [rows, cap] posting/page blocks and [rows] per-row scalars; n: the
    stream width a row makes. Returns (pg_c, rk_c, ct_c,
    n_pages, n_hits, hits), or with `topk_mode` (a _topk kernel: kpad is
    its topk, which may exceed n) the finished (pages, ranks, counts
    int32, n_pages, n_hits, hits)."""
    rows, cap = inputs[0].shape
    if not 0 < n <= max_lanes:
        raise ValueError(f"{kernel.symbol}: stream width {n} outside "
                         f"(0, {max_lanes}]")
    check_budgets(kernel, n, kpad, hpad, topk_mode)
    for k, t in enumerate(inputs):
        check(t, f"input {k}", torch.int32,
              (rows, cap) if t.dim() == 2 else (rows,))
    outs = full_result_outputs(rows, kpad, hpad, inputs[0].device, topk_mode)
    kernel.launch(inputs[0].device, *inputs, rows, cap, kpad, hpad, *outs)
    return outs


def check_budgets(kernel: Kernel, n: int, kpad: int, hpad: int,
                  topk_mode: bool = False) -> None:
    """A full-result kernel's run and hit widths over an n-lane stream:
    both in (0, n], but a _topk kernel pads any topk itself."""
    if not (0 < kpad and (topk_mode or kpad <= n) and 0 < hpad <= n):
        raise ValueError(f"{kernel.symbol}: kpad {kpad} / hpad {hpad} "
                         f"outside (0, {n}]")


@functools.cache
def tile_lanes() -> int:
    """Lanes of a row one block of the tiled kernels (and_keep,
    variants_keep, locate_runs) owns: a row of n lanes launches
    ceil(n / tile_lanes()) blocks."""
    return int(library().docodo_tile_lanes())


@functools.cache
def merge_passes(va: int, cap_a: int, vb: int, cap_b: int) -> int:
    """Launches docodo_merge_tagged makes for va blocks of cap_a and vb of
    cap_b: 0 for a row one block merges in shared memory, else the passes
    of its pairwise tree, which need scratch when there are two or more."""
    fn = library().docodo_merge_tagged_passes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(va, cap_a, vb, cap_b)


def tile_scratch(symbol: str, dev, rows: int, n: int, *dims) -> tuple:
    """The scratch a tiled entry point takes for `rows` rows of n lanes,
    sized by its C function `symbol` (which takes rows, n, *dims):
    (zeroed, work), int32. `zeroed` holds the look-back's status words
    and tickets; a row of one tile reads none of them, so for n <=
    tile_lanes() it is left unset, which saves the fill's launch.
    `work` holds the tile summaries, uninitialised."""
    fn = getattr(library(), symbol)
    fn.restype = None
    zeroed, work = ctypes.c_longlong(), ctypes.c_longlong()
    fn(*(ctypes.c_int(int(d)) for d in (rows, n, *dims)),
       ctypes.byref(zeroed), ctypes.byref(work))
    alloc = torch.zeros if n > tile_lanes() else torch.empty
    return (alloc(zeroed.value, dtype=torch.int32, device=dev),
            torch.empty(work.value, dtype=torch.int32, device=dev))


def full_result_outputs(rows: int, kpad: int, hpad: int, dev,
                        topk_mode: bool = False):
    """Uninitialised (pg_c, rk_c, ct_c, n_pages, n_hits, hits); the
    counts are f32, or int32 with `topk_mode`."""
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty((rows, kpad), **i32),
            torch.empty((rows, kpad), **f32),
            torch.empty((rows, kpad), **(i32 if topk_mode else f32)),
            torch.empty((rows,), **i32),
            torch.empty((rows,), **i32),
            torch.empty((rows, hpad), **i32))


_FULL = "pppppppp" + "iiii" + "pppppp"
_W1 = "ppp" + "iiii" + "pppppp"
SORTED_AND = Kernel("docodo_sorted_and_locate_full", _FULL)
SINGLE = Kernel("docodo_single_locate_full", _W1)
UNION = Kernel("docodo_union_locate_full", _W1)
MERGE_AND_LOCATE = Kernel("docodo_merge_and_locate_topk", _FULL)
MERGE_TAGGED = Kernel("docodo_merge_tagged", "pppppp" + "iiiii" + "pppp")
AND_KEEP = Kernel("docodo_and_keep", "ppppp" + "ii" + "ppppp" + "pp")
LOCATE_RUNS = Kernel("docodo_locate_runs",
                     "ppp" + "i" + "iiii" + "ii" + "pppppp" + "pp")
VARIANTS_AND = Kernel("docodo_variants_and_locate_full",
                      "ppppppppp" + "iiiiii" + "pppppp")
UNION_MERGE = Kernel("docodo_union_merge_locate_full",
                     "ppp" + "iiiii" + "pppppp")
VARIANTS_KEEP = Kernel("docodo_variants_keep",
                       "pppppp" + "ii" + "ppppp" + "pp")
AND_LOCATE_TOPK = Kernel("docodo_and_locate_topk",
                         "ppppppppp" + "iiii" + "ppp")
SINGLE_LOCATE_TOPK = Kernel("docodo_single_locate_topk",
                            "pppp" + "iiii" + "ppp")
SORTED_AND_TOPK = Kernel("docodo_sorted_and_locate_full_topk", _FULL)
VARIANTS_AND_TOPK = Kernel("docodo_variants_and_locate_full_topk",
                           VARIANTS_AND.signature)
UNION_TOPK = Kernel("docodo_union_locate_full_topk", UNION_MERGE.signature)
SINGLE_TOPK = Kernel("docodo_single_locate_full_topk", _W1)
MERGE_AND_LOCATE_STREAMS = Kernel("docodo_merge_and_locate",
                                  "pppppppp" + "ii" + "pppp")
PROBE_LOCATE = Kernel("docodo_probe_locate", "ppppp" + "iiiii" + "pppppp")
ROW_GATHER = Kernel("docodo_row_gather", "pp" + "iiii" + "p")
FETCH = Kernel("docodo_fetch_postings", "pppp" + "iiiii" + "ppp")
KERNELS = {"sorted_and_locate_full": SORTED_AND,
           "single_locate_full": SINGLE,
           "union_locate_full": UNION,
           "merge_and_locate_topk": MERGE_AND_LOCATE,
           "merge_tagged": MERGE_TAGGED,
           "and_keep": AND_KEEP,
           "locate_runs": LOCATE_RUNS,
           "variants_and_locate_full": VARIANTS_AND,
           "union_merge_locate_full": UNION_MERGE,
           "variants_keep": VARIANTS_KEEP,
           "and_locate_topk": AND_LOCATE_TOPK,
           "single_locate_topk": SINGLE_LOCATE_TOPK,
           "sorted_and_locate_full_topk": SORTED_AND_TOPK,
           "variants_and_locate_full_topk": VARIANTS_AND_TOPK,
           "union_locate_full_topk": UNION_TOPK,
           "single_locate_full_topk": SINGLE_TOPK,
           "merge_and_locate": MERGE_AND_LOCATE_STREAMS,
           "probe_locate": PROBE_LOCATE,
           "row_gather": ROW_GATHER,
           "fetch_postings": FETCH}
