#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""On-card smoke run: the run-codec sweep end to end on one NVIDIA GPU.

    python chip_smoke.py            # one card: phases a-d below
    python chip_smoke.py --four     # four cards: the --mesh path only

Everything runs in this one process (a second JAX process could not get
the card's memory). Any failed check exits non-zero; the last line of a
passing run is one JSON object naming the device.

  a. device: the default JAX backend must be the GPU; prints the device
     kind and count and ``nvidia-smi``'s name and power limit, and builds
     the native library from tpukit/native/src.
  b. Case B anchor: `run-codec --codec ccsds121` on one synthetic
     180x512x512 int16 14-in-16 tile (reference README.md:114-129). The
     stream must equal the host C++ coder's (and libaec's, where present),
     the device size model must equal the stream length, the run must be
     lossless, the device encode plan must have been used, and the CSV
     must carry the device memory peak.
  c. Case A ladder: `run-codec --codec j2k` over the 14-point quality
     ladder on two synthetic 1024x1024x4 uint16 12-in-16 tiles (reference
     README.md:98-112), against the same run on the CPU platform: equal
     bytes and max|err|, PSNR/SSIM within 1e-5 relative, and one lossy
     lane against the float64 numpy metric oracle.
  d. device-resident codecs: the checks of tests/test_gpu_smoke.py at
     real width (one Case A tile, a 180x128x128 Case B tile).

--four runs the Case B anchor and the Case A ladder with --mesh 4 and
--mesh 2,2 against --mesh 1 on four cards: the CSVs must be identical
(timing and memory columns aside). --trace DIR also records a
jax.profiler trace of each one-card phase under DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
RATES = "1 2 4 6 8 10 15 20 25 30 35 40 60 100".split()
CASEB_ARGS = ["--codec", "ccsds121", "--rate-key", "none", "--reps", "1",
              "--preproc", "none", "--nbit", "16", "--interleave", "bip",
              "--tile", "512"]
CASEA_ARGS = ["--codec", "j2k", "--rate-key", "quality", "--rates", *RATES,
              "--reps", "1"]
# columns that are measurements of the run, not results of the codec
RUN_COLS = ("t_", "mem_", "hbm_")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """`name, power.limit` of the visible cards, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


@contextmanager
def phase(name: str, card: str):
    t0 = time.perf_counter()
    yield
    log(f"[phase] {name}: {time.perf_counter() - t0:.3f} s on "
        f"{card.splitlines()[0]}")


def traced(trace_dir, name):
    """A jax.profiler trace of the enclosed work into trace_dir/name."""
    if trace_dir is None:
        return nullcontext()
    import jax
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    opts.host_tracer_level = 1
    return jax.profiler.trace(str(Path(trace_dir) / name),
                              profiler_options=opts)


def write_tile_index(work: Path, case: str, asset: str, tiles: dict) -> Path:
    from tpukit.io import tiff, write_manifest
    items = []
    for tid, cube in tiles.items():
        p = work / f"{case}_{tid}.tif"
        tiff.write_geotiff(p, cube, blockxsize=512, blockysize=512)
        items.append({"tile_id": tid, "path": p})
    idx = work / f"index_{case}_{asset}.json"
    write_manifest(idx, case, asset, items)
    return idx


def run_rows(idx: Path, args, outdir: Path):
    from tpukit.cli.main import run_codec_main
    from tpukit.sweep.csvio import read_metrics_rows
    run_codec_main(["--indices", str(idx), *args, "--outdir", str(outdir)])
    return read_metrics_rows(outdir / "metrics.csv")


def codec_columns(row: dict) -> dict:
    return {k: v for k, v in row.items() if not k.startswith(RUN_COLS)}


def phase_caseb(work: Path, cube: np.ndarray, trace_dir=None) -> dict:
    """Case B anchor through run-codec on the default device (the GPU)."""
    import jax
    from tpukit.codecs import ccsds121 as dev121
    from tpukit.native import ccsds121_host as ck
    from tpukit.native import libaec_oracle as ae

    idx = write_tile_index(work, "caseB", "tile_512", {"T01": cube})
    seen = {"plans": [], "parallel": [], "serial": 0}
    orig = (dev121.encode_plan, ck.encode_parallel, ck.encode)

    def encode_plan(x, *a, **kw):
        plan = orig[0](x, *a, **kw)
        seen["plans"].append((sorted({d.platform for d in x.devices()})
                              if hasattr(x, "devices") else ["host"],
                              plan))
        return plan

    def encode_parallel(flat, plan, *a, **kw):
        bs = orig[1](flat, plan, *a, **kw)
        seen["parallel"].append((plan["total_bits"], len(bs)))
        return bs

    def encode(*a, **kw):
        seen["serial"] += 1
        return orig[2](*a, **kw)

    dev121.encode_plan, ck.encode_parallel, ck.encode = (
        encode_plan, encode_parallel, encode)
    try:
        with traced(trace_dir, "caseB"):
            rows = run_rows(idx, CASEB_ARGS + ["--keep-bitstream"],
                            work / "caseB")
    finally:
        dev121.encode_plan, ck.encode_parallel, ck.encode = orig

    assert len(rows) == 1, rows
    row = rows[0]
    assert row["lossless"] == "1", row["lossless"]
    assert seen["serial"] == 0, "the serial host coder ran"
    assert len(seen["plans"]) == 1 and seen["plans"][0][1] is not None, \
        "no device encode plan"
    assert seen["plans"][0][0] == [jax.devices()[0].platform], \
        seen["plans"][0][0]
    assert len(seen["parallel"]) == 1, seen["parallel"]
    total_bits, n_bytes = seen["parallel"][0]
    bs = (work / "caseB" / "T01" / "norate" / "rep_01" / "bit"
          / "t_x00000_y00000.aec").read_bytes()
    assert len(bs) == n_bytes == (total_bits + 7) // 8 \
        == int(row["bitstream_bytes"]), (len(bs), n_bytes, total_bits)
    flat = np.ascontiguousarray(
        np.moveaxis(cube.view(np.uint16), 0, -1)).ravel()
    assert ck.encode(flat, 16) == bs, "stream differs from the host coder"
    oracle = "host C++ coder"
    if ae.available():
        assert ae.encode(flat, 16) == bs, "stream differs from libaec"
        oracle += " and libaec"
    hbm = row.get("hbm_peak_bytes") or ""
    assert hbm and int(hbm) > 0, f"hbm_peak_bytes not populated: {hbm!r}"
    return {"bytes": len(bs), "oracle": oracle, "hbm_peak_bytes": int(hbm)}


def phase_casea(work: Path, tiles: dict, trace_dir=None) -> dict:
    """Case A 14-point ladder on the GPU against the CPU platform."""
    import jax
    sys.path.insert(0, str(REPO / "tests"))
    from reference_impl import compute_metrics_oracle
    from tpukit.io import tiff
    from tpukit.io.bitdepth import effective_data_range
    from tpukit.sweep.csvio import parse_number

    idx = write_tile_index(work, "caseA", "tile_1024", tiles)
    args = CASEA_ARGS + ["--keep-bitstream"]
    t0 = time.perf_counter()
    with traced(trace_dir, "caseA"):
        rows_dev = run_rows(idx, args, work / "caseA_dev")
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        rows_cpu = run_rows(idx, args, work / "caseA_cpu")
    t_cpu = time.perf_counter() - t0

    assert len(rows_dev) == len(rows_cpu) == len(tiles) * len(RATES)
    for rd, rc in zip(rows_dev, rows_cpu):
        a, b = codec_columns(rd), codec_columns(rc)
        assert a.keys() == b.keys()
        for k in a:
            if k.startswith(("psnr", "ssim")):
                assert math.isclose(parse_number(a[k]), parse_number(b[k]),
                                    rel_tol=1e-5), (rd["tile_id"], k)
            else:
                assert a[k] == b[k], (rd["tile_id"], rd["rate_value"], k,
                                      a[k], b[k])

    # one lossy lane against the float64 oracle
    row = next(r for r in rows_dev
               if r["tile_id"] == "HC" and r["rate_value"] == "20")
    ref = tiles["HC"]
    with tiff.open(work / "caseA_dev" / "HC" / "quality_20" / "rep_01"
                   / "recon.tif") as ds:
        recon = ds.read()
    exp = compute_metrics_oracle(ref, recon,
                                 effective_data_range(ref, "uint16"))
    assert exp["lossless"] == 0
    for k in ("psnr_band_avg", "ssim_band_avg", "psnr_global",
              "ssim_global"):
        assert math.isclose(parse_number(row[k]), exp[k], rel_tol=1e-5), k
    assert int(row["max_abs_err"]) == exp["max_abs_err"]
    return {"rows": len(rows_dev), "t_gpu_s": t_dev, "t_cpu_s": t_cpu,
            "hc_q20_psnr_global": exp["psnr_global"]}


def phase_codecs(work: Path, tile_a: np.ndarray, tile_b: np.ndarray,
                 card: str, trace_dir=None) -> None:
    """tests/test_gpu_smoke.py's checks at real width."""
    import jax
    sys.path.insert(0, str(REPO / "tests"))
    import test_gpu_smoke as smoke

    dev = jax.devices()[0]
    cubes = {"A": tile_a, "B": tile_b}
    checks = [(name, lambda c=c, w=w: c(dev, cubes[w]))
              for name, c, w in smoke.CHECKS]
    checks.append(("mesh_metric_ladder",
                   lambda: smoke.check_mesh_metric_ladder(
                       dev, tile_a, work)))
    for name, fn in checks:
        with warnings.catch_warnings(record=True) as caught, \
                traced(trace_dir, f"codecs_{name}"), \
                phase(f"d/{name}", card):
            warnings.simplefilter("always")
            fn()
        for w in caught:
            log(f"  [warning] {name}: {w.category.__name__}: {w.message}")


def phase_four(work: Path, cube_b: np.ndarray, tiles_a: dict,
               card: str) -> None:
    """--mesh 4 and --mesh 2,2 against --mesh 1: identical CSVs."""
    import jax
    from tpukit.sweep.runner import _build_mesh

    for mesh in ("4", "2,2"):
        devs = list(_build_mesh(mesh).devices.flat)
        assert len(devs) == 4 and {d.platform for d in devs} == \
            {devs[0].platform} == {jax.devices()[0].platform}, devs
    cases = (
        ("caseB", write_tile_index(work, "caseB", "tile_512",
                                   {"T01": cube_b}), CASEB_ARGS),
        ("caseA", write_tile_index(work, "caseA", "tile_1024", tiles_a),
         CASEA_ARGS),
    )
    for case, idx, args in cases:
        rows = {}
        for mesh in ("1", "4", "2,2"):
            with phase(f"four/{case} --mesh {mesh}", card):
                rows[mesh] = run_rows(
                    idx, args + ["--mesh", mesh],
                    work / f"{case}_mesh{mesh.replace(',', 'x')}")
        base = [codec_columns(r) for r in rows["1"]]
        for mesh in ("4", "2,2"):
            got = [codec_columns(r) for r in rows[mesh]]
            assert got == base, f"{case}: --mesh {mesh} CSV differs"
        log(f"[four] {case}: --mesh 4 and --mesh 2,2 CSVs equal --mesh 1 "
            f"({len(base)} rows)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run-codec end to end on NVIDIA GPUs")
    ap.add_argument("--four", action="store_true",
                    help="run only the --mesh path, on four cards")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="record a jax.profiler trace of each one-card "
                         "phase under DIR")
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args(argv)

    if not __debug__:
        print("chip_smoke: its checks are asserts; run it without -O",
              file=sys.stderr)
        return 1
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX's default backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees "
              f"{len(jax.devices())}", file=sys.stderr)
        return 1

    sys.path.insert(0, str(REPO))
    from bench import make_casea_tiles, make_caseb_cube
    from tpukit import native
    from tpukit.hostinfo import configure_jax_compile_cache

    configure_jax_compile_cache()
    card = card_line()
    dev0 = jax.devices()[0]
    log(f"device: {dev0.device_kind} x{len(jax.devices())} "
        f"({dev0.platform})")
    log(f"card: {card}")
    with phase("a/native build", card):
        log(f"native library: {native.build_library().name}")
        native.load()

    rng = np.random.default_rng(args.seed)
    cube_b = make_caseb_cube(rng)
    tiles_a = make_casea_tiles(rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        if args.four:
            phase_four(work, cube_b, tiles_a, card)
        else:
            with phase("b/caseB anchor 180x512x512 ccsds121", card):
                info = phase_caseb(work, cube_b, args.trace)
            log(f"[caseB] {info['bytes']} B, byte-equal to the "
                f"{info['oracle']}; device plan used; hbm_peak_bytes "
                f"{info['hbm_peak_bytes']}")
            with phase("c/caseA ladder 2x1024x1024x4 j2k 14 rates "
                       "(gpu + cpu)", card):
                info = phase_casea(work, tiles_a, args.trace)
            log(f"[caseA] {info['rows']} rows equal to the CPU platform's; "
                f"gpu run {info['t_gpu_s']:.3f} s, cpu run "
                f"{info['t_cpu_s']:.3f} s; HC q20 matches the float64 "
                f"oracle (PSNR {info['hc_q20_psnr_global']:.4f} dB)")
            with phase("d/device codecs at real width", card):
                phase_codecs(work, tiles_a["HC"], cube_b[:, :128, :128],
                             card, args.trace)
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
