# -*- coding: utf-8 -*-
"""Codec API: the uniform contract every tpukit codec implements.

This is the in-process redesign of the reference's L2 wrapper contract —
CLI + JSON-on-stdout per codec (reference tools/codecs/j2k/j2k_wrap.py:10-11,
consumed at tools/run_codec.py:497-501, :546). Instead of argv and files,
codecs here are objects operating on in-memory ``(bands, H, W)`` cubes;
``CodecResult.to_meta()`` reproduces the exact JSON field names so the CSV
layer and any external consumer of the wrapper protocol see the same keys
(codec, encoder, bitstream_bytes, t_comp_s, t_dec_s, mem_*_peak_{mb,bytes},
plus codec-specific extras).
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# Background lane for device work that overlaps host work (j2k's
# quality->size ladder pricing runs while the host builds its tier-1
# plans). Each task gets its own daemon thread: submissions are bounded
# (one pricing per tile), and a daemon thread never holds up interpreter
# exit.


class _DaemonLane:
    @staticmethod
    def submit(fn, *args, **kwargs):
        import threading
        from concurrent.futures import Future

        fut: Future = Future()

        def run():
            if not fut.set_running_or_notify_cancel():
                return
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # delivered via fut.result()
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True,
                         name="tpukit-device-lane").start()
        return fut


_DEVICE_LANE = _DaemonLane()


def device_lane() -> _DaemonLane:
    return _DEVICE_LANE


@dataclass(frozen=True)
class RateSpec:
    """Rate-control request, mirroring the runner's --rate-key surface
    (reference run_codec.py:378-380: none | cr | bpp | nearlossless_eps |
    quality; plus explicit lossless)."""
    key: Optional[str] = None      # None == lossless anchor ("norate")
    value: Optional[float] = None
    lossless: bool = False

    @staticmethod
    def none() -> "RateSpec":
        return RateSpec(None, None, False)

    @staticmethod
    def of(key: Optional[str], value) -> "RateSpec":
        if key in (None, "none"):
            return RateSpec.none()
        return RateSpec(key, float(value), key == "lossless")


@dataclass
class CodecResult:
    codec: str
    encoder: str
    bitstream_bytes: int
    # (B, H, W) reconstructed cube. run() paths return a numpy array;
    # batched sweep paths (J2KCodec.sweep_qualities) return a DEVICE array
    # so downstream device metrics cost no host round-trip — call
    # np.asarray(recon) when host bytes are needed.
    recon: "np.ndarray | object"
    t_comp_s: float
    t_dec_s: float
    bitstreams: Optional[Dict[str, bytes]] = None  # name -> stream (kept on request)
    mem_comp_peak_bytes: Optional[int] = None
    mem_dec_peak_bytes: Optional[int] = None
    extras: Dict[str, object] = field(default_factory=dict)

    def to_meta(self) -> Dict[str, object]:
        """The wrapper-JSON dict (reference j2k_wrap.py:119-130 field set)."""
        def mib(x):
            return None if not x else round(x / (1024 * 1024), 2)
        meta = {
            "codec": self.codec,
            "encoder": self.encoder,
            "bitstream_bytes": int(self.bitstream_bytes),
            "t_comp_s": float(self.t_comp_s),
            "t_dec_s": float(self.t_dec_s),
            "mem_comp_peak_mb": mib(self.mem_comp_peak_bytes),
            "mem_dec_peak_mb": mib(self.mem_dec_peak_bytes),
            "mem_comp_peak_bytes": self.mem_comp_peak_bytes,
            "mem_dec_peak_bytes": self.mem_dec_peak_bytes,
        }
        meta.update(self.extras)
        return meta


class Codec(ABC):
    """A tpukit codec: encode+decode an in-memory cube under a RateSpec."""

    name: str = "codec"
    encoder_desc: str = ""
    supports_lossy: bool = False

    @abstractmethod
    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        """Encode + decode; return result with recon and exact stream size."""

    def sweep_rates(self, cube: np.ndarray, dtype_name: str, specs,
                    keep_bitstream: bool = False, **opts) -> List[CodecResult]:
        """Run a whole rate ladder on one cube; returns one CodecResult per
        RateSpec, in order. Transform codecs override this to amortize the
        device transform across the ladder (the reference re-runs the full
        codec per rate point, run_codec.py:472-495); the default is the
        plain per-point loop."""
        return [self.run(cube, dtype_name, s, keep_bitstream=keep_bitstream,
                         **opts) for s in specs]

    def timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0


def int16_to_codec_domain(band: np.ndarray) -> np.ndarray:
    """int16 -> uint16 via +32768, the mapping the reference applies before
    handing int16 planes to 16-bit unsigned codecs (jpegls_wrap.py:199)."""
    return (band.astype(np.int32) + 32768).astype(np.uint16)


def codec_domain_to_int16(band_u16: np.ndarray) -> np.ndarray:
    """Inverse of int16_to_codec_domain (jpegls_wrap.py:247-249)."""
    return np.clip(band_u16.astype(np.int32) - 32768, -32768, 32767).astype(np.int16)


def device_work(cube: np.ndarray, opts: dict, multiple: int = 1,
                target: str = "int32"):
    """Shared HBM-resident work-cube adoption for device codecs.

    Returns a (B, Hp, Wp) DEVICE array in ``target`` dtype, edge-padded so
    H and W are multiples of ``multiple``. When the sweep runner handed
    down its metric upload (``opts['device_cube']``) with matching shape
    AND a usable dtype, the conversion happens on device (int16 sources
    ride a bitcast to uint16 when that is the target — the reference's
    uint16 bit-view semantics); otherwise the cube is converted on host
    and uploaded once. Centralized so every codec applies identical
    adoption rules (shape + dtype guards, pad mode)."""
    import jax
    import jax.numpy as jnp

    B, H, W = cube.shape
    ph, pw = (-H) % multiple, (-W) % multiple
    dev = opts.get("device_cube")
    if dev is not None and tuple(dev.shape) == (B, H, W):
        src = np.dtype(str(dev.dtype))
        if target == "uint16":
            if src == np.int16:
                work = jax.lax.bitcast_convert_type(dev, jnp.uint16)
            elif src == np.uint16:
                work = dev
            elif src.kind in "ui":
                work = dev.astype(jnp.uint16)
            else:
                work = None     # lossy float source: fall back to host
        else:
            work = dev.astype(target) if src.kind in "uif" else None
        if work is not None:
            if ph or pw:
                work = jnp.pad(work, ((0, 0), (0, ph), (0, pw)),
                               mode="edge")
            return work
    host = cube.view(np.uint16) if (target == "uint16"
                                    and cube.dtype == np.int16) \
        else cube.astype(target)
    if ph or pw:
        host = np.pad(host, ((0, 0), (0, ph), (0, pw)), mode="edge")
    return jnp.asarray(np.ascontiguousarray(host))


def per_band_bpp(rate: "RateSpec", bands: int, bits_per_sample: float):
    """CCSDS-122-style per-band rate request -> (target_bpp_band,
    lossless_requested): --bpp is taken per band; --cr converts via
    bits·B/CR spread over B bands; no/insufficient rate == effectively
    lossless (reference ccsds122_wrap.py:97-107). Shared by the native
    codec and the external-binary band wrapper so the semantics can't
    drift."""
    if rate.key == "bpp" and rate.value is not None:
        target = float(rate.value)
    elif rate.key == "cr" and rate.value is not None:
        target = (bits_per_sample * bands / max(float(rate.value), 1e-6)) \
            / bands
    else:
        target = bits_per_sample
    return target, target >= bits_per_sample - 1e-9


def trailing_zero_shift(cube: "np.ndarray") -> int:
    """Common trailing-zero LSBs across all samples (uint bit view).

    The benchmark's baselines are bit-packed — Case A 12-in-16 carries 4
    exactly-zero LSBs, Case B 14-in-16 carries 2 — and a lossless coder
    pays ~k bits/sample for them. tpukit-format codecs (J2K reversible,
    CCSDS-122 effective-lossless, CCSDS-123) code (x >> k) and shift back
    on decode: exactly invertible because the dropped bits are zero by
    construction, and a pure function of the input so every size model and
    coder derives the same k. Byte-parity codecs (CCSDS-121 vs libaec,
    JPEG-LS vs CharLS) deliberately do NOT shift — the reference engines
    pay for those bits and parity wins."""
    u = cube.view(np.uint16) if cube.dtype.itemsize == 2 else \
        cube.view(np.uint8) if cube.dtype.itemsize == 1 else cube
    acc = int(np.bitwise_or.reduce(u, axis=None))
    if acc == 0:
        return 0
    return min((acc & -acc).bit_length() - 1, 8)
