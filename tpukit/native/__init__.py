# -*- coding: utf-8 -*-
"""Native runtime: C++ entropy coders + bit packers loaded via ctypes.

The reference delegates every compression kernel to *external* native
binaries over process+file boundaries (reference tools/codecs/*_wrap.py).
tpukit keeps the compute-heavy modeling stages on the accelerator and
runs only the inherently serial, bit-exact stages (variable-length
bitstream packing, sequential context-adaptive coding) in-process in C++,
compiled on first use and called through ctypes with zero-copy numpy
buffers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

_SRC_DIR = Path(__file__).parent / "src"
_BUILD_DIR = Path(__file__).parent / "build"
_LOCK = threading.Lock()
_LIB = None

_CXX_SOURCES = sorted(_SRC_DIR.glob("*.cpp"))
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
             "-fno-math-errno", "-ffp-contract=off", "-Wall"]


def _source_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(_SRC_DIR.glob("*.[ch]pp")) + sorted(_SRC_DIR.glob("*.h")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_CXXFLAGS).encode())
    return h.hexdigest()[:16]


def build_library(force: bool = False) -> Path:
    """Compile tpukit/native/src/*.cpp into a cached shared library."""
    _BUILD_DIR.mkdir(exist_ok=True)
    digest = _source_digest()
    lib_path = _BUILD_DIR / f"tpukit_native_{digest}.so"
    if lib_path.exists() and not force:
        return lib_path
    sources = [str(p) for p in sorted(_SRC_DIR.glob("*.cpp"))]
    if not sources:
        raise RuntimeError("No native sources found")
    cmd = ["g++", *_CXXFLAGS, "-o", str(lib_path) + ".tmp", *sources]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stderr}")
    os.replace(str(lib_path) + ".tmp", lib_path)
    # prune stale builds
    for old in _BUILD_DIR.glob("tpukit_native_*.so"):
        if old != lib_path:
            try:
                old.unlink()
            except OSError:
                pass
    return lib_path


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library. Thread-safe, cached."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(str(build_library()))
            _declare(_LIB)
        return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    import ctypes as ct
    u8p = ct.POINTER(ct.c_uint8)
    u16p = ct.POINTER(ct.c_uint16)
    u32p = ct.POINTER(ct.c_uint32)
    i32p = ct.POINTER(ct.c_int32)
    i64p = ct.POINTER(ct.c_int64)
    f64p = ct.POINTER(ct.c_double)
    f32p = ct.POINTER(ct.c_float)
    i64 = ct.c_longlong
    i32 = ct.c_int

    for name, restype, argtypes in [
        ("ck121_encode", i64, [u16p, i64, i32, i32, i32, i32, u8p, i64]),
        ("ck121_encode_seg", i64, [u16p, i64, i32, i32, i32, i32, i32, u8p, i64]),
        ("ck121_quant_encode", i64, [f32p, f32p, ct.c_float, i32p, i64,
                                     i32, i32, i32, i32, u8p, i64, u32p]),
        ("ck121_splice", None, [u8p, i64, u8p, i64]),
        ("ck121_decode", i64, [u8p, i64, i32, i32, i32, i32, u16p, i64]),
        ("ck121_decode_seg", i64, [u8p, i64, i64, i32, i32, i32, i32,
                                   u16p, i64]),
        ("bitpack_concat", i64, [u32p, u8p, i64, i64, u8p, i64]),
        ("jls_encode", i64, [u16p, i32, i32, i32, i32, u8p, i64]),
        ("jls_decode", i64, [u8p, i64, u16p, i32, i32, ct.POINTER(i32), ct.POINTER(i32)]),
        ("bpc_encode", i64, [u32p, i64, u8p, i64, i64]),
        ("bpc_encode_quant", i64, [ct.POINTER(ct.c_float),
                                   ct.POINTER(ct.c_float), ct.c_float,
                                   u32p, i64, u8p, i64, i64, u32p]),
        ("bpc_decode", i64, [u8p, i64, u32p, i64]),
        ("wrle_size_bits", i64, [i32p, i64, ct.POINTER(i64), i32]),
        ("wrle_encode", i64, [i32p, i64, ct.POINTER(i64), i32, u8p, i64]),
        ("wrle_decode", i64, [u8p, i64, ct.POINTER(i64), i32, i32p, i64]),
        ("ck123_code", i64, [u32p, i64, i32, i32, u8p, i64]),
        ("ck123_decode", i64, [u8p, i64, i32, i32, u32p, i64]),
        ("tpukit_bpe122_encode", i64, [i32p, i64, i64, i64, i32, i32,
                                       i32, i32, u8p, i64]),
        ("tpukit_bpe122_decode", i64, [u8p, i64, i64, i32p]),
        ("tpukit_bpe122_decode_trace", i64, [u8p, i64, i64, i32p, i32p,
                                             i64]),
        ("j2k_t1_sig_plan", i64, [i32p, i32, i32, i32p]),
        ("j2k_pkt1_hdr_size", i64, [i32, i32p, i32p, i32p, i64p, i64p]),
        ("j2k_sr2d_97", i64, [f64p, i64, i64, i32, i32]),
        ("j2k_sr2d_53", i64, [i64p, i64, i64, i32, i32]),
        ("j2k_fd2d_97", i64, [f64p, i64, i64, i32, i32]),
        ("j2k_fd2d_53", i64, [i64p, i64, i64, i32, i32]),
        ("j2k_band_recon", i64, [i32p, i32p, ct.POINTER(ct.c_int8),
                                 ct.POINTER(ct.c_int8), i32p, i32p, i64,
                                 ct.c_double, i32, ct.c_void_p]),
        ("j2k_dequant_mid", i64, [i32p, i32p, i64, ct.c_double, f64p]),
        ("ck123std_encode", i64, [u16p, i32, i32, i32, i32, i32, i32,
                                  i32, i32, i32, i32, u8p, i64]),
        ("ck123std_info", i64, [u8p, i64, i32p]),
        ("ck123std_decode", i64, [u8p, i64, u16p, i64]),
    ]:
        try:
            fn = getattr(lib, name)
        except AttributeError:
            continue
        fn.restype = restype
        fn.argtypes = argtypes
