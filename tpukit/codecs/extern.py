# -*- coding: utf-8 -*-
"""External-binary codec: drive a user-supplied native encoder/decoder
through command TEMPLATES, below the wrapper CLI.

This is the reference's L0↔L2 seam — `--enc-cmd/--dec-cmd` templates with
``{in}/{out}/{w}/{h}/{bands}/{mode}/{dtype}/{bpp}/{nbit}`` placeholders
that let users rebind any codec binary (reference
tools/codecs/ccsds121/ccsds121_wrap.py:117-118 & :190-194,
ccsds122_wrap.py:59-62 & :164-165, ccsds123_wrap.py:106-112 & :240-249;
SURVEY §5.6). tpukit's native codecs make the binaries unnecessary, but
the seam stays so reference binaries can be run side-by-side for parity
testing:

  * ``structure="tile"``: the CCSDS-121/123 shape — a ``tile``² grid,
    each tile dumped as a RAW interleaved cube (bip/bil/bsq), optional
    reversible diff1 spectral preprocessing (121 only), optional
    all-NoData tile skipping (123's ``--crop-nodata``,
    ccsds123_wrap.py:191-229);
  * ``structure="band"``: the CCSDS-122 shape — band-by-band RAW planes
    with a per-band ``{bpp}`` rate target (cr→per-band-bpp conversion and
    the effective-lossless semantics live in the wrapper, see
    cli/wrappers.py).

Each subprocess is measured with :func:`tpukit.sweep.proc.run_and_measure`
(deterministic env pinning + process-tree peak — the reference's L1 layer,
proc_metrics.py:8-113).
"""

from __future__ import annotations

import shlex
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpukit.codecs.base import Codec, CodecResult, RateSpec
from tpukit.io import raw as rawio
from tpukit.kernels.diff1 import diff1_forward_np, diff1_inverse_np
from tpukit.sweep.proc import run_and_measure


def template_to_list(cmd_tpl) -> List[str]:
    """Accept a template as a string (shlex-split) or token list
    (reference ccsds122_wrap.py:26-32)."""
    if isinstance(cmd_tpl, (list, tuple)):
        return [str(t) for t in cmd_tpl]
    if isinstance(cmd_tpl, str):
        return shlex.split(cmd_tpl)
    raise TypeError("enc-cmd/dec-cmd must be str or list")


def drop_rate_flag(tokens: Sequence[str]) -> List[str]:
    """Remove ``-r <value>`` pairs from a template — effective-lossless
    runs must not pass a rate flag (reference ccsds122_wrap.py:35-47)."""
    out: List[str] = []
    i = 0
    while i < len(tokens):
        if tokens[i] == "-r" and i + 1 < len(tokens):
            i += 2
            continue
        out.append(tokens[i])
        i += 1
    return out


class ExternalCodec(Codec):
    """Tile- or band-structured external codec driven by cmd templates.

    Tile structure (CCSDS-121/123 shape) is LOSSLESS-ONLY, like the
    reference wrappers it mirrors (their CLIs accept no rate flags); a
    rate request raises rather than being silently ignored. Band
    structure (CCSDS-122 shape) honors per-band bpp/cr via {bpp}."""

    def __init__(self, enc_cmd, dec_cmd, *, structure: str = "tile",
                 tile: int = 512, interleave: str = "bip",
                 preproc: str = "none", nbit: int = 16,
                 crop_nodata: bool = False, bit_ext: str = "bin",
                 name: str = "external", use_uss: bool = False):
        if structure not in ("tile", "band"):
            raise ValueError(f"structure must be tile|band, got {structure}")
        self.enc_tpl = template_to_list(enc_cmd)
        self.dec_tpl = template_to_list(dec_cmd)
        self.structure = structure
        self.tile = int(tile)
        self.interleave = interleave
        self.preproc = preproc
        self.nbit = int(nbit)
        self.crop_nodata = bool(crop_nodata)
        self.bit_ext = bit_ext
        self.name = name
        self.use_uss = use_uss
        self.supports_lossy = structure == "band"
        self.encoder_desc = " ".join(self.enc_tpl)

    # mirrors ccsds123_wrap.py:279-283 (recon keeps the dataset mask)
    @property
    def mask_passthrough(self) -> bool:
        return self.structure == "tile" and self.crop_nodata

    def _run(self, cmd: List[str]):
        elapsed, peak, _so, stderr, rc = run_and_measure(
            cmd, poll_interval=0.01, use_uss=self.use_uss)
        if rc != 0:
            raise RuntimeError(f"External codec failed ({rc}): "
                               f"{' '.join(cmd)}\n{stderr}")
        return elapsed, (peak or 0)

    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        if self.structure == "band":
            return self._run_bands(cube, dtype_name, rate, keep_bitstream)
        if rate.key not in (None, "none"):
            raise ValueError(
                f"{self.name}: tile-structured external codecs are "
                f"lossless-only (reference ccsds121/123 wrappers accept no "
                f"rate flags); got --{rate.key}")
        return self._run_tiles(cube, dtype_name, rate, keep_bitstream,
                               nodata=opts.get("nodata"),
                               dataset_mask=opts.get("dataset_mask"))

    # ---- CCSDS-121/123 shape: tile grid of RAW interleaved cubes --------
    def _run_tiles(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
                   keep_bitstream: bool, nodata=None,
                   dataset_mask=None) -> CodecResult:
        B, H, W = cube.shape
        recon = np.empty_like(cube)
        t_enc = t_dec = 0.0
        peak_e = peak_d = 0
        sum_bytes = 0
        skipped = 0
        streams: Dict[str, bytes] = {}
        use_diff1 = self.preproc == "diff1"

        with tempfile.TemporaryDirectory(prefix="tpukit_ext_") as td:
            tdp = Path(td)
            for y0 in range(0, H, self.tile):
                for x0 in range(0, W, self.tile):
                    th = min(self.tile, H - y0)
                    tw = min(self.tile, W - x0)
                    t = cube[:, y0:y0 + th, x0:x0 + tw]
                    # all-NoData fast path (ccsds123_wrap.py:191-229)
                    if self.crop_nodata and self._tile_all_nodata(
                            t, nodata, dataset_mask, y0, x0, th, tw):
                        recon[:, y0:y0 + th, x0:x0 + tw] = t
                        skipped += 1
                        continue
                    pre = diff1_forward_np(t) if use_diff1 else t
                    raw_in = tdp / f"t_x{x0:05d}_y{y0:05d}.raw"
                    raw_out = tdp / f"t_x{x0:05d}_y{y0:05d}_dec.raw"
                    bitf = tdp / f"t_x{x0:05d}_y{y0:05d}.{self.bit_ext}"
                    rawio.write_raw(pre, self.interleave, raw_in, dtype_name)
                    mp = {"in": str(raw_in), "out": str(bitf),
                          "nbit": self.nbit, "w": tw, "h": th, "bands": B,
                          "mode": self.interleave, "dtype": dtype_name}
                    dt, pk = self._run([tok.format(**mp)
                                        for tok in self.enc_tpl])
                    t_enc += dt
                    peak_e = max(peak_e, pk)
                    sum_bytes += bitf.stat().st_size
                    mpd = dict(mp, **{"in": str(bitf), "out": str(raw_out)})
                    dt, pk = self._run([tok.format(**mpd)
                                        for tok in self.dec_tpl])
                    t_dec += dt
                    peak_d = max(peak_d, pk)
                    rec = rawio.read_raw(raw_out, self.interleave,
                                         dtype_name, B, th, tw)
                    if use_diff1:
                        rec = diff1_inverse_np(rec)
                    recon[:, y0:y0 + th, x0:x0 + tw] = rec
                    if keep_bitstream:
                        streams[bitf.name] = bitf.read_bytes()

        extras = {"tile": self.tile, "interleave": self.interleave,
                  "preproc": self.preproc}
        if self.crop_nodata:
            extras["skipped_nodata_tiles"] = skipped
        return CodecResult(
            codec=self.name, encoder=self.encoder_desc,
            bitstream_bytes=sum_bytes, recon=recon,
            t_comp_s=t_enc, t_dec_s=t_dec,
            bitstreams=streams if keep_bitstream else None,
            mem_comp_peak_bytes=peak_e or None,
            mem_dec_peak_bytes=peak_d or None, extras=extras)

    @staticmethod
    def _tile_all_nodata(t, nodata, dataset_mask, y0, x0, th, tw) -> bool:
        """True iff every sample of the tile is NoData / masked-out
        (reference ccsds123_wrap.py:191-206: dataset mask first, nodata
        DN fallback)."""
        if dataset_mask is not None:
            m = np.asarray(dataset_mask)[y0:y0 + th, x0:x0 + tw]
            return not bool((m > 0).any())
        if nodata is None or not np.isfinite(nodata):
            return False
        return bool((t == t.dtype.type(nodata)).all())

    # ---- CCSDS-122 shape: band-by-band RAW planes ------------------------
    def _run_bands(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
                   keep_bitstream: bool) -> CodecResult:
        from tpukit.codecs.base import per_band_bpp

        B, H, W = cube.shape
        # same dtype surface as the reference's band wrapper: unsigned
        # planes only (ccsds122_wrap.py docstring "(uint16/uint8)") — an
        # int16 cube viewed as uint16 would lossy-code across the 0/65535
        # wrap, so reject instead of corrupting
        if dtype_name not in ("uint16", "uint8"):
            raise ValueError(
                f"{self.name}: band-structured external codecs take "
                f"uint16/uint8 planes (got {dtype_name}); convert signed "
                f"data first (reference ccsds122_wrap.py input contract)")
        bits = 16.0 if dtype_name == "uint16" else 8.0
        # cr -> per-band bpp conversion shared with the native codec
        bpp_band, lossless_req = per_band_bpp(rate, B, bits)
        enc_tpl = (drop_rate_flag(self.enc_tpl) if lossless_req
                   else self.enc_tpl)

        recon = np.empty_like(cube)
        t_enc = t_dec = 0.0
        peak_e = peak_d = 0
        sum_bytes = 0
        streams: Dict[str, bytes] = {}
        with tempfile.TemporaryDirectory(prefix="tpukit_ext_") as td:
            tdp = Path(td)
            for i in range(1, B + 1):
                raw_in = tdp / f"b{i:02d}.raw"
                raw_out = tdp / f"b{i:02d}_dec.raw"
                bitf = tdp / f"b{i:02d}.bit"
                band = cube[i - 1]
                band.astype("<u2" if bits == 16 else "u1",
                            copy=False).tofile(raw_in)
                mp = {"in": str(raw_in), "out": str(bitf), "w": W, "h": H,
                      "bpp": float(bpp_band)}
                dt, pk = self._run([tok.format(**mp) for tok in enc_tpl])
                t_enc += dt
                peak_e = max(peak_e, pk)
                sum_bytes += bitf.stat().st_size
                mpd = dict(mp, **{"in": str(bitf), "out": str(raw_out)})
                dt, pk = self._run([tok.format(**mpd)
                                    for tok in self.dec_tpl])
                t_dec += dt
                peak_d = max(peak_d, pk)
                recon[i - 1] = np.fromfile(
                    raw_out, dtype=("<u2" if bits == 16 else "u1")
                ).reshape(H, W).astype(cube.dtype)
                if keep_bitstream:
                    streams[bitf.name] = bitf.read_bytes()

        return CodecResult(
            codec=self.name, encoder=self.encoder_desc,
            bitstream_bytes=sum_bytes, recon=recon,
            t_comp_s=t_enc, t_dec_s=t_dec,
            bitstreams=streams if keep_bitstream else None,
            mem_comp_peak_bytes=peak_e or None,
            mem_dec_peak_bytes=peak_d or None,
            extras={"bpp_req_band": bpp_band,
                    "lossless_requested": bool(lossless_req)})
