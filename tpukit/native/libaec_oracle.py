# -*- coding: utf-8 -*-
"""ctypes binding to the system libaec — *oracle only*.

The reference's CCSDS-121 path shells out to the ``aec`` CLI built on libaec
(reference tools/codecs/ccsds121/ccsds121_wrap.py:129-136, README.md:86).
tpukit's own encoder/decoder (tpukit/native/src/ccsds121.cpp + the device
path in tpukit/codecs/ccsds121.py) is validated byte-for-byte against this
binding in tests and raced against it in benchmarks. It is NOT used on the
production encode/decode path.

CLI-equivalent defaults for ``aec -n {nbit} in out``
(libaec utils/aec.c): block_size=8, rsi=2, flags=AEC_DATA_PREPROCESS,
LSB-first byte order, unsigned samples.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

AEC_DATA_SIGNED = 1
AEC_DATA_3BYTE = 2
AEC_DATA_MSB = 4
AEC_DATA_PREPROCESS = 8
AEC_RESTRICTED = 16
AEC_PAD_RSI = 32
AEC_NOT_ENFORCE = 64

AEC_OK = 0

_DEFAULT_BLOCK_SIZE = 8
_DEFAULT_RSI = 2
_DEFAULT_FLAGS = AEC_DATA_PREPROCESS


class _AecStream(ctypes.Structure):
    _fields_ = [
        ("next_in", ctypes.c_void_p),
        ("avail_in", ctypes.c_size_t),
        ("total_in", ctypes.c_size_t),
        ("next_out", ctypes.c_void_p),
        ("avail_out", ctypes.c_size_t),
        ("total_out", ctypes.c_size_t),
        ("bits_per_sample", ctypes.c_uint),
        ("block_size", ctypes.c_uint),
        ("rsi", ctypes.c_uint),
        ("flags", ctypes.c_uint),
        ("state", ctypes.c_void_p),
    ]


_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for cand in ("libaec.so.0", "libaec.so", ctypes.util.find_library("aec"),
                 "libsz.so.2"):
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
            lib.aec_buffer_encode.restype = ctypes.c_int
            lib.aec_buffer_encode.argtypes = [ctypes.POINTER(_AecStream)]
            lib.aec_buffer_decode.restype = ctypes.c_int
            lib.aec_buffer_decode.argtypes = [ctypes.POINTER(_AecStream)]
            _lib = lib
            return lib
        except OSError:
            continue
    return None


def available() -> bool:
    return _load() is not None


def _to_bytes(samples: np.ndarray, bits: int) -> bytes:
    if bits <= 8:
        return np.ascontiguousarray(samples.astype(np.uint8)).tobytes()
    return np.ascontiguousarray(samples.astype("<u2")).tobytes()


def encode(samples: np.ndarray, bits: int = 16,
           block_size: int = _DEFAULT_BLOCK_SIZE, rsi: int = _DEFAULT_RSI,
           flags: int = _DEFAULT_FLAGS) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("libaec not available")
    raw = _to_bytes(np.asarray(samples).ravel(), bits)
    out = ctypes.create_string_buffer(len(raw) * 2 + 1024)
    strm = _AecStream()
    inbuf = ctypes.create_string_buffer(raw, len(raw))
    strm.next_in = ctypes.cast(inbuf, ctypes.c_void_p)
    strm.avail_in = len(raw)
    strm.next_out = ctypes.cast(out, ctypes.c_void_p)
    strm.avail_out = len(out)
    strm.bits_per_sample = bits
    strm.block_size = block_size
    strm.rsi = rsi
    strm.flags = flags
    rc = lib.aec_buffer_encode(ctypes.byref(strm))
    if rc != AEC_OK:
        raise RuntimeError(f"aec_buffer_encode failed rc={rc}")
    return out.raw[:strm.total_out]


def decode(bitstream: bytes, n_samples: int, bits: int = 16,
           block_size: int = _DEFAULT_BLOCK_SIZE, rsi: int = _DEFAULT_RSI,
           flags: int = _DEFAULT_FLAGS) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("libaec not available")
    bps = 1 if bits <= 8 else 2
    out = ctypes.create_string_buffer(n_samples * bps)
    strm = _AecStream()
    inbuf = ctypes.create_string_buffer(bitstream, len(bitstream))
    strm.next_in = ctypes.cast(inbuf, ctypes.c_void_p)
    strm.avail_in = len(bitstream)
    strm.next_out = ctypes.cast(out, ctypes.c_void_p)
    strm.avail_out = len(out)
    strm.bits_per_sample = bits
    strm.block_size = block_size
    strm.rsi = rsi
    strm.flags = flags
    rc = lib.aec_buffer_decode(ctypes.byref(strm))
    if rc != AEC_OK:
        raise RuntimeError(f"aec_buffer_decode failed rc={rc}")
    dt = np.uint8 if bps == 1 else np.dtype("<u2")
    return np.frombuffer(out.raw[:n_samples * bps], dtype=dt).copy()
