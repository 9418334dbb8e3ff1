# -*- coding: utf-8 -*-
"""Codec wrapper CLIs — the reference's L2 contract, in-process.

Each wrapper takes ``--in <tif> --out <recon.tif> --keep-bitstream <dir>``
plus rate flags and prints exactly one JSON object as the last stdout line
(the contract stated at reference tools/codecs/j2k/j2k_wrap.py:10-11 and
consumed by the runner at tools/run_codec.py:497-501). This keeps any
automation written against the reference's wrappers working against
tpukit's in-framework codecs — no external binaries, no RAW temp files.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from tpukit.codecs.base import RateSpec
from tpukit.codecs.registry import create
from tpukit.io import tiff
from tpukit.sweep.proc import MemorySampler


def _common(ap: argparse.ArgumentParser):
    ap.add_argument("--in", dest="inp", required=True, help="Input multiband GeoTIFF")
    ap.add_argument("--out", dest="out", required=True, help="Output reconstructed GeoTIFF")
    ap.add_argument("--keep-bitstream", default=None, help="Folder to keep bitstreams")
    g = ap.add_mutually_exclusive_group(required=False)
    g.add_argument("--cr", type=float)
    g.add_argument("--bpp", type=float)
    g.add_argument("--quality", type=float)
    g.add_argument("--nearlossless_eps", type=int)
    g.add_argument("--lossless", action="store_true")
    # reference-compat no-ops: the reference wrappers run external codec
    # binaries, optionally under WSL with Windows temp bases
    # (ccsds121_wrap.py:120-121, ccsds123_wrap.py:110-112, :121); tpukit
    # codes in-framework, so scripts passing these must not crash
    ap.add_argument("--run-in-wsl", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tmp-base", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wsl-enc", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wsl-dec", default=None, help=argparse.SUPPRESS)


def _rate_from_args(args) -> RateSpec:
    if getattr(args, "lossless", False):
        return RateSpec(None, None, True)
    for key in ("cr", "bpp", "quality", "nearlossless_eps"):
        v = getattr(args, key, None)
        if v is not None:
            return RateSpec.of(key, v)
    return RateSpec.none()


def run_wrapper(codec_name: str, argv=None, codec_opts_fn=None,
                extra_args_fn=None, sparse_flag: bool = False,
                codec_factory=None, pre_check_fn=None):
    ap = argparse.ArgumentParser(description=f"tpukit {codec_name} wrapper")
    _common(ap)
    if extra_args_fn:
        extra_args_fn(ap)
    args = ap.parse_args(argv)

    opts = codec_opts_fn(args) if codec_opts_fn else {}
    codec = codec_factory(args, opts) if codec_factory else None
    if codec is None:
        codec = create(codec_name, **opts)
    rate = _rate_from_args(args)
    keep = args.keep_bitstream is not None

    with tiff.open(args.inp) as ds:
        cube = ds.read()
        if pre_check_fn:
            pre_check_fn(args, cube)
        dtype_name = ds.dtypes[0]
        meta = {"nodata": ds.nodata, "geo": ds.geo,
                "descriptions": ds.descriptions,
                "dataset_mask": ds.dataset_mask()}

    with MemorySampler() as ms:
        result = codec.run(cube, dtype_name, rate, keep_bitstream=keep,
                           nodata=meta["nodata"],
                           dataset_mask=meta["dataset_mask"])
    if result.mem_comp_peak_bytes is None:
        result.mem_comp_peak_bytes = ms.phase_peak_bytes("comp")
        result.mem_dec_peak_bytes = ms.phase_peak_bytes("dec")

    tiff.write_geotiff(
        Path(args.out), result.recon, nodata=meta["nodata"],
        geo=meta["geo"], descriptions=meta["descriptions"],
        # validity-mask passthrough (reference ccsds123_wrap.py:279-283)
        mask=(meta["dataset_mask"]
              if getattr(codec, "mask_passthrough", False) else None),
        # GDAL SPARSE_OK equivalent (reference ccsds123_wrap.py:175-177)
        sparse_ok=bool(sparse_flag and getattr(args, "sparse_output",
                                               False)))
    if keep and result.bitstreams:
        bit_dir = Path(args.keep_bitstream)
        bit_dir.mkdir(parents=True, exist_ok=True)
        for name, data in result.bitstreams.items():
            (bit_dir / name).write_bytes(data)

    print(json.dumps(result.to_meta()))  # last line: JSON protocol
    return 0


# -- per-codec entry points --------------------------------------------------

def _add_tpl_args(ap, enc_help: str, dec_help: str):
    """--enc-cmd/--dec-cmd templates: the external-binary rebinding seam
    (reference ccsds121_wrap.py:117-118, ccsds122_wrap.py:59-62,
    ccsds123_wrap.py:106-109). Omitted => tpukit's native codec."""
    ap.add_argument("--enc-cmd", default=None, help=enc_help)
    ap.add_argument("--dec-cmd", default=None, help=dec_help)


def _require_both_tpls(a):
    if (a.enc_cmd is None) != (a.dec_cmd is None):
        raise SystemExit("--enc-cmd and --dec-cmd must be given together")
    return a.enc_cmd is not None


def ccsds121_main(argv=None):
    def extra(ap):
        ap.add_argument("--tile", type=int, default=512)
        ap.add_argument("--interleave", choices=["bip", "bil", "bsq"], default="bip")
        ap.add_argument("--preproc", choices=["none", "diff1"], default="diff1")
        ap.add_argument("--nbit", type=int, default=16)
        ap.add_argument("--validate-14bit", dest="validate_14bit",
                        action="store_true",
                        help="warn if DN exceed the 14-bit effective range "
                             "(reference ccsds121_wrap.py:151-158)")
        _add_tpl_args(ap, 'e.g. "aec -n {nbit} {in} {out}"',
                      'e.g. "aec -d -n {nbit} {in} {out}"')

    def opts(a):
        return dict(tile=a.tile, interleave=a.interleave, preproc=a.preproc,
                    nbit=a.nbit)

    def factory(a, o):
        if not _require_both_tpls(a):
            return None
        from tpukit.codecs.extern import ExternalCodec
        return ExternalCodec(a.enc_cmd, a.dec_cmd, structure="tile",
                             tile=a.tile, interleave=a.interleave,
                             preproc=a.preproc, nbit=a.nbit,
                             bit_ext="aec", name="ccsds121_ext")

    def pre_check(a, cube):
        # sample-window 14-bit range warning (ccsds121_wrap.py:151-158)
        if not a.validate_14bit:
            return
        s = cube[:, :1024, :1024]
        if np.issubdtype(s.dtype, np.signedinteger):
            ok = (s >= -8192).all() and (s <= 8191).all()
            kind = "signed"
        else:
            ok = (s >= 0).all() and (s <= 16383).all()
            kind = "unsigned"
        if not ok:
            print(f"[WARN] Values exceed {kind} 14-bit range",
                  file=sys.stderr)

    return run_wrapper("ccsds121", argv, opts, extra, codec_factory=factory,
                       pre_check_fn=pre_check)


def jpegls_main(argv=None):
    def extra(ap):
        ap.add_argument("--preproc", choices=["none", "diff1"], default="none")

    def opts(a):
        return dict(preproc=a.preproc)
    return run_wrapper("jpegls", argv, opts, extra)


def png_main(argv=None):
    def extra(ap):
        ap.add_argument("--zlevel", type=int, default=6)
        ap.add_argument("--writer", choices=("tpukit", "compat"),
                        default="tpukit",
                        help="'compat' writes via the reference's "
                             "imageio/Pillow chain for byte-identical "
                             "baseline sizes (png_wrap.py:76-116)")

    def opts(a):
        return dict(zlevel=a.zlevel, writer=a.writer)
    return run_wrapper("png", argv, opts, extra)


def j2k_main(argv=None):
    def extra(ap):
        ap.add_argument("--tilex", type=int, default=None,
                        help="independent-tile width (TILEXSIZE, "
                             "j2k_wrap.py:81)")
        ap.add_argument("--tiley", type=int, default=None,
                        help="independent-tile height (TILEYSIZE)")
        ap.add_argument("--rate-fit", dest="rate_fit", action="store_true",
                        help="hit bpp/cr targets via device bisection over "
                             "the exact coder size model")
        ap.add_argument("--entropy", choices=("ebcot", "device"),
                        default="ebcot",
                        help="'ebcot' (default) emits standard ISO 15444-1 "
                             "codestreams; 'device' is the transfer-free "
                             "fast mode (proprietary bitstream)")

    def opts(a):
        return dict(tilex=a.tilex, tiley=a.tiley, rate_fit=a.rate_fit,
                    entropy=a.entropy)
    return run_wrapper("j2k", argv, opts, extra)


def ccsds122_main(argv=None):
    def extra(ap):
        ap.add_argument("--entropy", choices=("bpe", "embedded"),
                        default="bpe",
                        help="'bpe' (default) emits CCSDS 122.0-B "
                             "segment-structured streams; 'embedded' "
                             "keeps the device-resident tpukit format")
        _add_tpl_args(ap,
                      'e.g. "bpe -e {in} -o {out} -r {bpp} -w {w} -h {h}"',
                      'e.g. "bpe -d {in} -o {out} -w {w} -h {h}"')

    def opts(a):
        return dict(entropy=a.entropy)

    def factory(a, o):
        if not _require_both_tpls(a):
            return None
        from tpukit.codecs.extern import ExternalCodec
        return ExternalCodec(a.enc_cmd, a.dec_cmd, structure="band",
                             name="ccsds122_ext", use_uss=True)
    return run_wrapper("ccsds122", argv, opts, extra, codec_factory=factory)


def ccsds123_main(argv=None):
    def extra(ap):
        ap.add_argument("--tile", type=int, default=512)
        ap.add_argument("--interleave", choices=["bip", "bil", "bsq"], default="bsq")
        ap.add_argument("--crop-nodata", dest="crop_nodata",
                        action="store_true",
                        help="skip coding of 100%% NoData tiles "
                             "(reference ccsds123_wrap.py:191-229)")
        ap.add_argument("--sparse-output", dest="sparse_output",
                        action="store_true",
                        help="write the recon GeoTIFF with sparse blocks "
                             "(GDAL SPARSE_OK equivalent)")
        ap.add_argument("--predictor", choices=("ls", "standard"),
                        default="ls",
                        help="'standard' emits CCSDS 123.0-B conformant "
                             "streams (sample-adaptive predictor + GPO2); "
                             "'ls' (default) keeps the device-first "
                             "transmitted-weights design")
        _add_tpl_args(ap,
                      'e.g. "enc123 -i {in} -o {out} -w {w} -h {h} '
                      '-b {bands} --mode {mode} --dtype {dtype}"',
                      'e.g. "dec123 -i {in} -o {out} -w {w} -h {h} '
                      '-b {bands} --mode {mode} --dtype {dtype}"')

    def opts(a):
        return dict(tile=a.tile, interleave=a.interleave,
                    crop_nodata=a.crop_nodata, predictor=a.predictor)

    def factory(a, o):
        if not _require_both_tpls(a):
            return None
        from tpukit.codecs.extern import ExternalCodec
        return ExternalCodec(a.enc_cmd, a.dec_cmd, structure="tile",
                             tile=a.tile, interleave=a.interleave,
                             preproc="none", crop_nodata=a.crop_nodata,
                             bit_ext="bin", name="ccsds123_ext")
    return run_wrapper("ccsds123", argv, opts, extra, sparse_flag=True,
                       codec_factory=factory)
