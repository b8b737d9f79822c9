"""Build and bind the port's native host library (docodo_native.cpp).

The source compiles with `g++ -O3 -march=native -std=c++17 -shared
-fPIC` on first use into `build/docodo_tpu_torch/` at the root of the
checkout, under a name keyed by a hash of the source and the flags, and
loads through ctypes. Each process compiles to a file of its own and
replaces the target atomically, so processes that build at once (test
workers) never load a half-written library. A failed compile raises:
there is no fallback, and no environment variable turns the library
off (the pure-Python tokenizer is chosen by the caller, with
`native=False`). Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "docodo_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "docodo_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"docodo_native_{h.hexdigest()[:16]}.so"


def build() -> None:
    """Compile the library unless it is built; raises if g++ fails."""
    out = library_path()
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o",
                               str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.docodo_interner_new.restype = c.c_void_p
    lib.docodo_interner_new.argtypes = []
    lib.docodo_interner_free.restype = None
    lib.docodo_interner_free.argtypes = [c.c_void_p]
    lib.docodo_interner_count.restype = c.c_int64
    lib.docodo_interner_count.argtypes = [c.c_void_p]
    lib.docodo_interner_export_range.restype = c.c_int64
    lib.docodo_interner_export_range.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64, c.c_void_p, c.c_void_p]
    lib.docodo_interner_get.restype = c.c_int32
    lib.docodo_interner_get.argtypes = [c.c_void_p, c.c_int64, c.c_void_p,
                                        c.c_int32]
    lib.docodo_tokenize_intern_packed.restype = c.c_int64
    lib.docodo_tokenize_intern_packed.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p,
        c.c_int32, c.c_int32, c.c_void_p, c.c_int64]
    lib.docodo_stem_en.restype = c.c_int64
    lib.docodo_stem_en.argtypes = [c.c_char_p, c.c_int64, c.c_char_p]
    lib.docodo_tokenize_intern.restype = c.c_int64
    lib.docodo_tokenize_intern.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p,
        c.c_int32, c.c_int32, c.c_void_p, c.c_void_p, c.c_int64]
    lib.docodo_stem_en_bulk.restype = c.c_int64
    lib.docodo_stem_en_bulk.argtypes = [
        c.c_char_p, c.c_void_p, c.c_int64, c.c_char_p, c.c_void_p]
    lib.docodo_stem_ru_bulk.restype = c.c_int64
    lib.docodo_stem_ru_bulk.argtypes = [
        c.c_char_p, c.c_void_p, c.c_int64, c.c_char_p, c.c_void_p]
    lib.docodo_varint_encode.restype = c.c_int64
    lib.docodo_varint_encode.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
    lib.docodo_varint_encode_blocks.restype = c.c_int64
    lib.docodo_varint_encode_blocks.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p, c.c_void_p]
    lib.docodo_varint_decode.restype = c.c_int64
    lib.docodo_varint_decode.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
    lib.docodo_varint_decode_spans.restype = c.c_int64
    lib.docodo_varint_decode_spans.argtypes = [
        c.c_char_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_void_p,
        c.c_void_p]
    lib.docodo_parse_records_from.restype = c.c_int64
    lib.docodo_parse_records_from.argtypes = [
        c.c_char_p, c.c_int64, c.c_int64, c.c_int64, c.c_void_p, c.c_void_p,
        c.c_void_p, c.c_void_p, c.c_void_p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if need be (once, whichever
    thread asks first)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                build()
                _lib = _bind(ctypes.CDLL(str(library_path())))
    return _lib
