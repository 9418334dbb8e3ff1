# -*- coding: utf-8 -*-
"""tpukit command-line interface.

``python -m tpukit <command> ...`` exposes every tool of the reference
pipeline (reference README.md:98-157 command surface):

  run-codec        sweep runner (tools/run_codec.py surface)
  make-baseline-a  Case A preparation (tools/make_baseline_A.py)
  make-baseline-b  Case B preparation (tools/make_baseline_B.py)
  quicklooks       RGB + ERR8 maps (tools/quicklooks.py)
  rd-curve         RD figures (tools/rd_curve.py)
  overlay-means    overlays/Pareto/iso bars (tools/overlay_means.py)
  fig-caseb        LC-vs-HC bars (tools/fig_caseB.py)
  tile-complexity  complexity analytics (tools/utils/tile_complexity.py)
  codec-*          the six wrapper CLIs (tools/codecs/*_wrap.py contract)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def run_codec_main(argv=None):
    """Sweep runner CLI mirroring reference tools/run_codec.py:374-399."""
    ap = argparse.ArgumentParser(
        description="tpukit codec runner: sweep codecs and collect metrics per tile")
    ap.add_argument("--indices", required=True)
    ap.add_argument("--codec", required=True,
                    help="codec name (ccsds121|jpegls|png|j2k|ccsds122|ccsds123"
                         " or reference labels like ccsds121_ext)")
    ap.add_argument("--compressor-cmd", nargs="+", default=None,
                    help="external wrapper command (reference L2 contract); "
                         "when set, --codec is only the CSV label and unknown "
                         "args after -- pass through to the wrapper")
    ap.add_argument("--rate-key", default="none",
                    choices=["none", "cr", "bpp", "nearlossless_eps", "quality"])
    ap.add_argument("--rates", nargs="+", default=None)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--keep-bitstream", action="store_true")
    ap.add_argument("--case", default=None)
    ap.add_argument("--asset", default=None)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--caseA-link-mbps", type=float, default=1.0)
    ap.add_argument("--caseA-eff", type=float, default=0.80)
    ap.add_argument("--caseB-link-mbps", type=float, default=None)
    ap.add_argument("--caseB-eff", type=float, default=None)
    ap.add_argument("--ql-err-global", type=int, default=255)
    ap.add_argument("--ql-err-zoom", type=int, default=None)
    ap.add_argument("--ql-rgb", action="store_true")
    ap.add_argument("--no-artifacts", action="store_true",
                    help="skip recon.tif/quicklooks on disk (fast in-memory mode)")
    ap.add_argument("--single-csv", default=None,
                    help="path to the per-run CSV (default "
                         "<outdir>/metrics.csv; metrics_mean.csv is "
                         "written next to it — reference run_codec.py:402)")
    ap.add_argument("--csv-decimal", choices=[",", "."], default=",")
    # codec options pass through
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--interleave", default=None)
    ap.add_argument("--preproc", default=None)
    ap.add_argument("--nbit", type=int, default=None)
    ap.add_argument("--zlevel", type=int, default=None)
    ap.add_argument("--png-writer", dest="png_writer",
                    choices=("tpukit", "compat"), default=None,
                    help="png: 'compat' writes via the reference's "
                         "imageio/Pillow chain for byte-identical baseline "
                         "sizes (png_wrap.py:76-116)")
    ap.add_argument("--crop-nodata", dest="crop_nodata", action="store_true",
                    help="ccsds123: skip coding of 100%% NoData tiles")
    ap.add_argument("--predictor", choices=("ls", "standard"), default=None,
                    help="ccsds123: 'standard' emits CCSDS 123.0-B "
                         "conformant streams (sample-adaptive predictor + "
                         "GPO2, Blue Book header); 'ls' (default) keeps "
                         "the device-first transmitted-weights design")
    ap.add_argument("--pred-bands", dest="pred_bands", type=int,
                    default=None, metavar="P",
                    help="ccsds123 standard: previous bands used by the "
                         "predictor (0..15, default 3 — the CNES "
                         "binaries' P knob, ccsds123_wrap.py:129-153)")
    ap.add_argument("--pred-mode", dest="pred_mode",
                    choices=("full", "reduced"), default=None,
                    help="ccsds123 standard: full (directional + central) "
                         "or reduced (central-only) prediction mode")
    ap.add_argument("--local-sums", dest="local_sums",
                    choices=("neighbor", "column"), default=None,
                    help="ccsds123 standard: neighbor- or column-oriented "
                         "local sums (colsum enables the wide-row "
                         "pipelined form)")
    ap.add_argument("--tilex", type=int, default=None,
                    help="j2k: independent-tile width (TILEXSIZE)")
    ap.add_argument("--tiley", type=int, default=None,
                    help="j2k: independent-tile height (TILEYSIZE)")
    ap.add_argument("--rate-fit", dest="rate_fit", action="store_true",
                    help="j2k: hit bpp/cr targets by device bisection over "
                         "the exact coder size model instead of the "
                         "heuristic quality tables")
    ap.add_argument("--entropy",
                    choices=("ebcot", "device", "bpe", "embedded",
                             "sample", "block"), default=None,
                    help="entropy backend, per codec: j2k 'ebcot' "
                         "(default, ISO 15444-1) | 'device' (transfer-"
                         "free fast mode); ccsds122 'bpe' (default, "
                         "122-structured segments) | 'embedded' (device "
                         "embedded coder); ccsds123 standard mode "
                         "'sample' (default, sample-adaptive GPO2) | "
                         "'block' (§5.4.2 block-adaptive = CCSDS-121 "
                         "over the residual sequence)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a jax.profiler trace of the sweep into DIR "
                         "(view with TensorBoard / xprof; the device analog "
                         "of the reference's wall-clock/psutil "
                         "instrumentation, SURVEY §5.1)")
    ap.add_argument("--mesh", metavar="DP[,SP]", default=None,
                    help="shard the (rates x reps) metric ladder over a "
                         "device mesh: DP-way over lanes, SP-way over the "
                         "band axis; needs DP*SP devices of the default "
                         "device's platform")
    ap.add_argument("--stream-rows", type=int, default=None,
                    help="scene streaming: process each item in N-row "
                         "strips with bounded host memory (strip-exact "
                         "codecs only; aligned up to the codec tile grid). "
                         "Items over 1 GiB stream automatically.")
    ap.add_argument("--dedupe-reps", action="store_true",
                    help="opt-in rep deduplication: reps of an identical "
                         "(tile, rate) point reuse the first rep's "
                         "streams/recon/timings and share one metric lane "
                         "(deterministic codecs; faster, but per-rep time "
                         "IQRs become structurally zero). Default is the "
                         "reference's semantics: every rep re-executes the "
                         "codec points and its own metrics "
                         "(run_codec.py:472-475).")
    args, _extra = ap.parse_known_args(argv)

    from tpukit.codecs.registry import create
    from tpukit.io.manifest import load_indices
    from tpukit.metrics.link import link_for_case
    from tpukit.sweep.runner import SweepConfig, run_sweep

    if args.compressor_cmd:
        from tpukit.codecs.shell import ShellCodec
        extra = [x for x in _extra if x != "--"]
        codec = ShellCodec(args.compressor_cmd, extra)
    else:
        copts = {}
        for k in ("tile", "interleave", "preproc", "nbit", "zlevel",
                  "tilex", "tiley", "entropy", "predictor", "pred_bands",
                  "pred_mode", "local_sums"):
            v = getattr(args, k)
            if v is not None:
                copts[k] = v
        if args.crop_nodata:
            copts["crop_nodata"] = True
        if args.png_writer is not None:
            copts["writer"] = args.png_writer
        if args.rate_fit:
            copts["rate_fit"] = True
        codec = create(args.codec, **copts)

    case_name, _, _ = load_indices(Path(args.indices))
    if args.case:
        case_name = args.case
    ck = str(case_name).lower()
    if ck in ("caseb", "b"):
        link_mbps, link_eff = args.caseB_link_mbps, args.caseB_eff
    else:
        link_mbps, link_eff = args.caseA_link_mbps, args.caseA_eff

    cfg = SweepConfig(
        indices=Path(args.indices), codec=codec, codec_label=args.codec,
        outdir=Path(args.outdir), rate_key=args.rate_key, rates=args.rates,
        reps=args.reps, keep_bitstream=args.keep_bitstream,
        write_artifacts=not args.no_artifacts,
        quicklooks=not args.no_artifacts,
        ql_rgb=args.ql_rgb, ql_err_global=args.ql_err_global,
        ql_err_zoom=args.ql_err_zoom, case=args.case, asset=args.asset,
        link_mbps=link_mbps, link_eff=link_eff, csv_decimal=args.csv_decimal,
        single_csv=(Path(args.single_csv) if args.single_csv else None),
        mesh=args.mesh, stream_rows=args.stream_rows,
        dedupe_reps=args.dedupe_reps)
    if args.profile:
        import jax
        with jax.profiler.trace(str(args.profile)):
            run_sweep(cfg)
    else:
        run_sweep(cfg)
    return 0


def make_baseline_a_main(argv=None):
    ap = argparse.ArgumentParser(description="Case A baseline preparation")
    ap.add_argument("--bands", nargs=4, required=True,
                    metavar=("B02", "B03", "B04", "B08"))
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--scene", default="2000x10000")
    ap.add_argument("--tile", default="1024x1024")
    ap.add_argument("--hc", default="300,688")
    ap.add_argument("--lc", default="488,7012")
    ap.add_argument("--no-quicklooks", action="store_true")
    args = ap.parse_args(argv)
    from tpukit.pipelines.baseline_a import CaseAConfig, run
    sw, sh = (int(v) for v in args.scene.split("x"))
    tw, th = (int(v) for v in args.tile.split("x"))
    cfg = CaseAConfig(
        band_paths=[Path(p) for p in args.bands], outdir=Path(args.outdir),
        scene_w=sw, scene_h=sh, tile_w=tw, tile_h=th,
        hc_off=tuple(int(v) for v in args.hc.split(",")),
        lc_off=tuple(int(v) for v in args.lc.split(",")),
        quicklooks=not args.no_quicklooks)
    out = run(cfg)
    print(json.dumps({k: str(v) for k, v in out.items() if k != "items"}))
    return 0


def make_baseline_b_main(argv=None):
    ap = argparse.ArgumentParser(description="Case B baseline preparation")
    ap.add_argument("--input-raw", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--dt", required=True)
    ap.add_argument("--target-bands", type=int, default=180)
    ap.add_argument("--tile-size", type=int, default=512)
    ap.add_argument("--lc", default="580,5620")
    ap.add_argument("--hc", default="2000,1536")
    ap.add_argument("--stretch", default="1,99")
    ap.add_argument("--gamma", type=float, default=0.9)
    ap.add_argument("--wb", default="whitepatch", choices=["none", "whitepatch", "gray"])
    ap.add_argument("--rgb-nm", default="665.0,560.0,490.0")
    ap.add_argument("--false-nm", default="842.0,665.0,560.0")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--err-mode", default="mean",
                    choices=["max", "mean", "rms", "p95", "count3"])
    ap.add_argument("--err-scale", default="fixed", choices=["fixed", "auto"])
    args = ap.parse_args(argv)
    from tpukit.pipelines.baseline_b import CaseBConfig, run
    cfg = CaseBConfig(
        input_raw=Path(args.input_raw), output=Path(args.output), dt=args.dt,
        target_bands=args.target_bands, tile_size=args.tile_size,
        lc=tuple(int(v) for v in args.lc.split(",")),
        hc=tuple(int(v) for v in args.hc.split(",")),
        stretch=tuple(float(v) for v in args.stretch.split(",")),
        gamma=args.gamma, wb=args.wb,
        rgb_nm=tuple(float(v) for v in args.rgb_nm.split(",")),
        false_nm=tuple(float(v) for v in args.false_nm.split(",")),
        k=args.k, err_mode=args.err_mode, err_scale=args.err_scale)
    out = run(cfg)
    print(json.dumps({k: str(v) for k, v in out.items()
                      if k not in ("items", "used_bits")}))
    return 0


def quicklooks_main(argv=None):
    ap = argparse.ArgumentParser(description="RGB quicklook and 8-bit error maps")
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--out")
    ap.add_argument("--error-against")
    ap.add_argument("--err-out-base")
    ap.add_argument("--err-max-global", type=int, default=255)
    ap.add_argument("--err-max-zoom", type=int, default=None)
    ap.add_argument("--rgb-order", nargs=3, type=int, default=[3, 2, 1])
    ap.add_argument("--rgb-pct", nargs=2, type=float, default=(2, 98))
    args = ap.parse_args(argv)
    from tpukit.viz import quicklooks as ql
    p = Path(args.baseline)
    if args.out:
        params = ql.stretch_params_from_baseline(p, rgb_order=args.rgb_order,
                                                 pct=tuple(args.rgb_pct))
        ql.write_rgb_8bit(p, Path(args.out), params, rgb_order=args.rgb_order)
    if args.error_against:
        out_base = Path(args.err_out_base) if args.err_out_base else p.with_suffix("")
        ql.write_error_max8(p, args.error_against, out_base,
                            err_max_global=args.err_max_global,
                            err_max_zoom=args.err_max_zoom,
                            pct=tuple(args.rgb_pct))
    return 0


def rd_curve_main(argv=None):
    ap = argparse.ArgumentParser(description="RD curves from metrics_mean.csv")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--case", default=None)
    ap.add_argument("--asset", default=None)
    ap.add_argument("--tile", default=None)
    ap.add_argument("--codec", default=None)
    ap.add_argument("--anchor-q", type=float, default=None)
    ap.add_argument("--anchor-bpp", type=float, default=None)
    ap.add_argument("--anchor-error", type=float, default=None)
    ap.add_argument("--out-prefix", default="fig/rd")
    ap.add_argument("--ymetric", choices=["psnr", "ssim"], default="psnr")
    ap.add_argument("--interp", action="store_true")
    ap.add_argument("--interp-points", type=int, default=200)
    args = ap.parse_args(argv)
    from tpukit.viz import figures
    df = figures.read_csv_smart(args.csv)
    for col, val in (("case", args.case), ("asset", args.asset),
                     ("codec", args.codec)):
        if val is not None and col in df.columns:
            df = df[df[col] == val]
    if df.empty:
        raise SystemExit("No rows match the provided filters.")
    anchors = {}
    if args.anchor_q is not None:
        anchors["q"] = f"quality={args.anchor_q}"
    if args.anchor_bpp is not None:
        anchors["bpp"] = f"bpp={args.anchor_bpp}"
    if args.anchor_error is not None:
        anchors["near"] = f"near={args.anchor_error}"
    tiles = [args.tile] if args.tile else None
    figures.plot_rd(df, args.out_prefix, tiles=tiles, ymetric=args.ymetric,
                    codec=args.codec, anchors=anchors, interp=args.interp,
                    interp_points=args.interp_points)
    return 0


def overlay_means_main(argv=None):
    ap = argparse.ArgumentParser(description="Overlay RD + Pareto + ISO bars")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--inputs", nargs="*", default=None)
    ap.add_argument("--glob", default=None)
    ap.add_argument("--dedup", action="store_true")
    ap.add_argument("--save-merged", default=None)
    ap.add_argument("--case", default=None)
    ap.add_argument("--asset", default=None)
    ap.add_argument("--tiles", default="HC,LC")
    ap.add_argument("--ymetric", choices=["psnr", "ssim"], default="psnr")
    ap.add_argument("--out-prefix", default="fig/overlay")
    ap.add_argument("--codecs", nargs="*", default=None)
    ap.add_argument("--anchors", default=None)
    ap.add_argument("--interp", action="store_true")
    ap.add_argument("--interp-points", type=int, default=200)
    ap.add_argument("--iso-quality-psnr", type=float, default=65.0)
    ap.add_argument("--iso-rate-cr", default="2,5,7")
    args = ap.parse_args(argv)
    from tpukit.viz import figures
    paths = []
    if args.csv:
        paths.append(Path(args.csv))
    if args.inputs:
        paths += [Path(x) for x in args.inputs]
    if args.glob:
        paths += sorted(Path(".").glob(args.glob))
    df = figures.load_and_merge(paths, dedup=args.dedup)
    if args.save_merged:
        Path(args.save_merged).parent.mkdir(parents=True, exist_ok=True)
        df.to_csv(args.save_merged, sep=";", index=False, decimal=",")
    for col, val in (("case", args.case), ("asset", args.asset)):
        if val is not None and col in df.columns:
            df = df[df[col] == val]
    if args.codecs:
        df = df[df["codec"].isin(args.codecs)]
    if df.empty:
        raise SystemExit("No rows after filters.")
    anchors = json.loads(args.anchors) if args.anchors else {}
    tiles = [t.strip() for t in args.tiles.split(",") if t.strip()]
    figures.overlay_rd(df, args.out_prefix, tiles=tiles, ymetric=args.ymetric,
                       anchors=anchors, interp=args.interp,
                       interp_points=args.interp_points)
    for t in tiles:
        figures.pareto_plots(df, args.out_prefix, tile=t, ymetric=args.ymetric,
                             anchors=anchors)
    try:
        cr_list = [float(x) for x in str(args.iso_rate_cr).replace(";", ",").split(",") if x.strip()]
    except ValueError:
        cr_list = [2, 5, 7]
    for t in tiles:
        figures.iso_rate_psnr_bars(df, args.out_prefix, tile=t, cr_list=cr_list)
    return 0


def fig_caseb_main(argv=None):
    ap = argparse.ArgumentParser(description="LC vs HC bar charts from CSVs")
    ap.add_argument("csv_paths", nargs="+")
    ap.add_argument("--max-codecs", type=int, default=3)
    ap.add_argument("--mem", choices=["enc", "dec"], default="enc")
    ap.add_argument("--outdir", default=".")
    args = ap.parse_args(argv)
    from tpukit.viz import figures
    df = figures.load_and_merge([Path(p) for p in args.csv_paths])
    figures.caseb_bars(df, args.outdir, max_codecs=args.max_codecs, mem=args.mem)
    return 0


def tile_complexity_main(argv=None):
    ap = argparse.ArgumentParser(description="Tile complexity metrics")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--hf-cut", type=float, default=0.30)
    ap.add_argument("--radial-bins", type=int, default=256)
    ap.add_argument("--alpha-min", type=float, default=0.02)
    ap.add_argument("--alpha-max", type=float, default=0.45)
    ap.add_argument("--delent-bins", type=int, default=256)
    ap.add_argument("--delent-clip", type=float, default=99.0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    from tpukit.analysis.complexity import compute_all
    for p in args.paths:
        m = compute_all(p, hf_cut=args.hf_cut, nbins_radial=args.radial_bins,
                        alpha_fit_min=args.alpha_min, alpha_fit_max=args.alpha_max,
                        delent_bins=args.delent_bins,
                        delent_clip_pct=args.delent_clip)
        if args.json:
            print(json.dumps(m))
        else:
            print(f'{Path(m["path"]).name}: '
                  f'grad_mean={m["grad_mean"]:.3f}, '
                  f'hf_ratio={m["hf_ratio"]:.4f}, '
                  f'MDF={m["mdf"]:.4f}, MNF={m["mnf"]:.4f}, '
                  f'alpha={m["alpha"]:.3f}, '
                  f'ps_med={m["ps_median"]:.3e}, ps_mean={m["ps_mean"]:.3e}, '
                  f'delentropy_bits={m["delentropy_bits"]:.3f}')
    return 0


def doctor_main(argv=None):
    """Deployment health check: backend/devices, native build, compile
    cache, kernel map-count headroom, codec smoke round-trips. Exits
    nonzero if any REQUIRED check fails (accelerator presence is
    reported, not required: the CPU backend runs every path, for tests)."""
    ap = argparse.ArgumentParser(
        description="tpukit environment and install health check")
    ap.add_argument("--smoke", action="store_true",
                    help="also run tiny encode/decode round-trips through "
                         "all six codecs (seconds)")
    args = ap.parse_args(argv)
    import os
    failures = []

    def row(name, ok, detail, required=True):
        mark = "ok " if ok else ("FAIL" if required else "warn")
        print(f"[{mark}] {name}: {detail}")
        if required and not ok:
            failures.append(name)

    import platform
    print(f"tpukit doctor — python {platform.python_version()} "
          f"on {platform.machine()}")
    try:
        import jax
        backend = jax.default_backend()
        devs = jax.devices()
        row("jax backend", True, f"{backend}, {len(devs)} device(s): "
            f"{[str(d) for d in devs[:4]]}")
        row("accelerator", backend not in ("cpu",),
            "accelerator attached" if backend != "cpu"
            else "CPU only (fine for tests; device numbers need a GPU)",
            required=False)
    except Exception as e:
        row("jax backend", False, f"import/init failed: {e}")

    try:
        from tpukit import native
        path = native.build_library()
        lib = native.load()
        row("native library", True, f"{path.name} "
            f"({len([s for s in dir(lib) if not s.startswith('_')])} syms)")
    except Exception as e:
        row("native library", False, f"build/load failed: {e}")

    from tpukit.hostinfo import compile_cache_dir
    cache = compile_cache_dir()
    n = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    row("compile cache", True, f"{cache} ({n} entries)", required=False)

    try:
        with open("/proc/sys/vm/max_map_count") as f:
            mmc = int(f.read())
        row("vm.max_map_count", mmc >= 131072,
            f"{mmc}" + ("" if mmc >= 131072 else
                        " — JIT-heavy runs (full test suite) may exhaust "
                        "maps; raise to >=262144 (docs/SCALING.md)"),
            required=False)
    except OSError:
        pass

    if args.smoke:
        import numpy as np
        from tpukit.codecs.base import RateSpec
        from tpukit.codecs.registry import create
        rng = np.random.default_rng(0)
        cube = ((rng.integers(0, 4096, (2, 64, 64)).astype(np.uint16))
                << 4)
        for name in ("ccsds121", "jpegls", "png", "j2k", "ccsds122",
                     "ccsds123"):
            try:
                res = create(name).run(cube, "uint16", RateSpec.none(),
                                       keep_bitstream=True)
                exact = bool(np.array_equal(np.asarray(res.recon), cube))
                row(f"codec {name}", exact,
                    f"lossless round-trip, {res.bitstream_bytes} B")
            except Exception as e:
                row(f"codec {name}", False, f"{type(e).__name__}: {e}")

    if failures:
        print(f"doctor: {len(failures)} required check(s) failed: "
              f"{failures}", file=sys.stderr)
        return 1
    print("doctor: all required checks passed")
    return 0


COMMANDS = {
    "run-codec": run_codec_main,
    "make-baseline-a": make_baseline_a_main,
    "make-baseline-b": make_baseline_b_main,
    "quicklooks": quicklooks_main,
    "rd-curve": rd_curve_main,
    "overlay-means": overlay_means_main,
    "fig-caseb": fig_caseb_main,
    "tile-complexity": tile_complexity_main,
    "doctor": doctor_main,
}


def _init_jax_compile_cache():
    """Persist XLA compiles across CLI invocations (every `python -m
    tpukit` run is a fresh process): JAX_COMPILATION_CACHE_DIR when set,
    else <checkout>/.jax_cache. Otherwise a cache dir already configured
    by the embedding process is left alone."""
    import os

    import jax
    from tpukit.hostinfo import configure_jax_compile_cache, \
        ensure_cpu_platform
    ensure_cpu_platform()
    if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or not jax.config.jax_compilation_cache_dir):
        configure_jax_compile_cache()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    _init_jax_compile_cache()
    from tpukit.cli import wrappers
    codec_cmds = {
        "codec-ccsds121": wrappers.ccsds121_main,
        "codec-jpegls": wrappers.jpegls_main,
        "codec-png": wrappers.png_main,
        "codec-j2k": wrappers.j2k_main,
        "codec-ccsds122": wrappers.ccsds122_main,
        "codec-ccsds123": wrappers.ccsds123_main,
    }
    all_cmds = {**COMMANDS, **codec_cmds}
    if not argv or argv[0] in ("-h", "--help"):
        print("tpukit commands:")
        for name in sorted(all_cmds):
            print(f"  {name}")
        return 0
    cmd = argv[0]
    if cmd not in all_cmds:
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 2
    return all_cmds[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
