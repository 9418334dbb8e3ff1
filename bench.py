#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""tpukit benchmark: the CANONICAL CLI commands, end to end.

Measures exactly what a user runs (BASELINE.md north-star: full Case A
14-rate J2K sweep + Case B CCSDS-121 lossless anchor < 60 s wall on one
accelerator):

  * case A — `python -m tpukit run-codec --codec j2k --rate-key quality
    --rates 1 2 4 6 8 10 15 20 25 30 35 40 60 100 --reps 3
    --keep-bitstream` on the two canonical 1024²×4-band 12-in-16 tiles
    (HC, LC), artifacts + quicklooks on (reference README.md:98-112)
  * case B — `python -m tpukit run-codec --codec ccsds121 --rate-key none
    --reps 3 --preproc none --nbit 16 --interleave bip --tile 512` on a
    512²×180-band 14-in-16 tile (reference README.md:114-129)

REP SEMANTICS: the headline measures HONEST reps — the runner's default,
matching the reference's workload definition (run_codec.py:472-475):
every rep re-executes its codec rate points and its own metric lanes, so
per-rep timings are independent measurements (J2K's tier-1 analysis and
priced targets amortize across reps, the sweep-wide convention; t_dec_s
is one real stream decode per (tile, rate), j2k_wrap.py:102-105). The
opt-in `--dedupe-reps` wall is measured once afterwards and reported
separately, clearly labeled, in the detail.

Both run in-process through the same `run_codec_main` entry the CLI uses.
Three iterations per command into fresh outdirs; min is reported (the
first iteration absorbs XLA compiles — persisted in the compile cache
across runs; the min over the two warm iterations resists host noise).
A per-tile codec/device/artifacts phase breakdown of the best warm
iteration rides in the detail (TPUKIT_PHASE_JSON hook).

The bench needs a GPU: on any other default backend it exits non-zero
before measuring anything.

`vs_baseline` keeps round-1's definition for continuity: the Case B anchor
flow (encode + decode + verify + full metrics) against the
reference-equivalent implementation (libaec + float64 numpy metrics), and
byte parity with libaec is asserted.

Prints ONE JSON line; a failed scene row or gate exits non-zero after it.
"""

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_caseb_cube(rng, bands=180, size=512):
    """Synthetic EnMAP-like cube: shared spatial texture × smooth spectral
    gains + noise, truncated to 14-in-16 (int16)."""
    base = rng.normal(0, 1, (size, size))
    k = np.ones(9) / 9.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    spatial = (500 + 6000 * base)
    gains = 0.6 + 0.8 * np.abs(np.sin(np.linspace(0.3, 5.8, bands)))[:, None, None]
    cube = spatial[None] * gains + rng.normal(0, 12, (bands, size, size))
    cube = np.clip(cube, -8192, 8191).astype(np.int16)
    return ((cube.view(np.uint16) >> 2) << 2).view(np.int16)


def make_casea_tiles(rng):
    """Two canonical Case A tiles (HC, LC): 1024²×4 uint16, 12-in-16."""
    gy, gx = np.mgrid[0:1024, 0:1024]
    base = ((800 + 2.5 * gy + 1.5 * gx).astype(np.int32)) % 4096
    tiles = {}
    for tid, amp in (("HC", 400), ("LC", 40)):
        t = np.clip(base[None] + rng.integers(-amp, amp, (4, 1024, 1024)),
                    0, 4095).astype(np.uint16) << 4
        tiles[tid] = t.astype(np.uint16)
    return tiles


def reference_metrics_numpy(ref, tst, rng_peak):
    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    from reference_impl import compute_metrics_oracle, sam_sid_lmse_oracle
    m = compute_metrics_oracle(ref, tst, rng_peak)
    m.update(sam_sid_lmse_oracle(ref, tst))
    return m


def main():
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; the default JAX backend "
                         f"is {jax.default_backend()!r}")
    from tpukit.hostinfo import configure_jax_compile_cache
    configure_jax_compile_cache()
    import jax.numpy as jnp
    from tpukit.cli.main import run_codec_main
    from tpukit.codecs import ccsds121 as ck_dev
    from tpukit.io import tiff, write_manifest
    from tpukit.io.bitdepth import effective_data_range
    from tpukit.metrics.quality import assemble_quality, quality_stats
    from tpukit.metrics.spectral import spectral_stats
    from tpukit.native import ccsds121_host as ck
    from tpukit.native import libaec_oracle as ae

    dev0 = jax.devices()[0]
    device = {"platform": dev0.platform, "kind": dev0.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")
    rng = np.random.default_rng(2026)
    work = Path(tempfile.mkdtemp(prefix="tpukit_bench_"))

    # ---- inputs (not timed) ----
    bands, size = 180, 512
    cubeB = make_caseb_cube(rng, bands, size)
    pB = work / "caseB_tile.tif"
    tiff.write_geotiff(pB, cubeB, blockxsize=512, blockysize=512)
    idxB = work / "index_caseB.json"
    write_manifest(idxB, "caseB", "tile_512",
                   [{"tile_id": "T01", "path": pB}])

    tilesA = make_casea_tiles(rng)
    itemsA = []
    for tid, t in tilesA.items():
        p = work / f"caseA_tile_{tid}_12in16.tif"
        tiff.write_geotiff(p, t, blockxsize=512, blockysize=512)
        itemsA.append({"tile_id": tid, "path": p})
    idxA = work / "index_caseA.json"
    write_manifest(idxA, "caseA", "tile_1024", itemsA)
    log(f"inputs ready under {work}")

    # ---- canonical commands (timed, min of 2 fresh runs) ----
    rates = "1 2 4 6 8 10 15 20 25 30 35 40 60 100".split()

    def run_caseA(outdir):
        run_codec_main([
            "--indices", str(idxA), "--codec", "j2k",
            "--rate-key", "quality", "--rates", *rates,
            "--reps", "3", "--outdir", str(outdir), "--keep-bitstream"])

    def run_caseB(outdir):
        run_codec_main([
            "--indices", str(idxB), "--codec", "ccsds121",
            "--rate-key", "none", "--reps", "3", "--outdir", str(outdir),
            "--preproc", "none", "--nbit", "16", "--interleave", "bip",
            "--tile", "512"])

    tA, tB = [], []
    phases = {"caseA": [], "caseB": []}
    # iteration 0 absorbs the XLA compiles and compile-cache loads; two
    # further warm iterations resist host-side noise via the min
    for it in range(3):
        for name, fn, acc in (("caseA", run_caseA, tA),
                              ("caseB", run_caseB, tB)):
            outdir = work / f"runs_{name}_{it}"
            pj = work / f"phase_{name}_{it}.jsonl"
            os.environ["TPUKIT_PHASE_JSON"] = str(pj)
            t0 = time.perf_counter()
            fn(outdir)
            dt = time.perf_counter() - t0
            os.environ.pop("TPUKIT_PHASE_JSON", None)
            acc.append(dt)
            ph = {"codec_s": 0.0, "device_s": 0.0, "artifacts_s": 0.0}
            try:
                for line in pj.read_text().splitlines():
                    row = json.loads(line)
                    for k in ph:
                        ph[k] += row.get(k, 0.0)
                ph = {k: round(v, 2) for k, v in ph.items()}
            except OSError:
                ph = None
            phases[name].append(ph)
            log(f"[{name} iter {it}] {dt:.1f}s  phases {ph}")
            if it < 2:
                shutil.rmtree(outdir, ignore_errors=True)
    t_caseA, t_caseB = min(tA), min(tB)
    med = lambda v: float(np.median(v))
    t_total = t_caseA + t_caseB
    t_total_median = med(tA) + med(tB)
    log(f"canonical wall (honest reps): caseA {t_caseA:.1f}s + caseB "
        f"{t_caseB:.1f}s = {t_total:.1f}s min / {t_total_median:.1f}s "
        f"median (north-star < 60s; iters A={['%.1f' % t for t in tA]} "
        f"B={['%.1f' % t for t in tB]})")
    # phase breakdown of the best warm iteration per case (for SCALING)
    phase_best = {name: phases[name][1 + int(np.argmin(vals[1:]))]
                  for name, vals in (("caseA", tA), ("caseB", tB))}

    # the opt-in deduped-reps wall, measured warm and clearly labeled —
    # NOT the headline (it executes ~1 rep of codec+metric work)
    tded = {}
    for name, base_args in (("caseA", [
            "--indices", str(idxA), "--codec", "j2k",
            "--rate-key", "quality", "--rates", *rates,
            "--reps", "3", "--keep-bitstream"]), ("caseB", [
            "--indices", str(idxB), "--codec", "ccsds121",
            "--rate-key", "none", "--reps", "3",
            "--preproc", "none", "--nbit", "16", "--interleave", "bip",
            "--tile", "512"])):
        outdir = work / f"runs_{name}_dedupe"
        t0 = time.perf_counter()
        run_codec_main(base_args + ["--outdir", str(outdir),
                                    "--dedupe-reps"])
        tded[name] = time.perf_counter() - t0
        shutil.rmtree(outdir, ignore_errors=True)
    t_dedupe = tded["caseA"] + tded["caseB"]
    log(f"deduped-reps wall (opt-in, ~1 rep of codec+metric work): "
        f"{t_dedupe:.1f}s")
    # regression gate: the warm sum must beat the north-star LOUDLY (min
    # over the two warm iterations — iteration 0 additionally absorbs the
    # compiles). Asserted at the very END of main so
    # the JSON measurement line always lands first — a degraded host must
    # fail loud WITH its numbers on record, not instead of them.
    warm_sum = min(tA[1:]) + min(tB[1:])
    if warm_sum >= 60:
        log(f"REGRESSION: warm canonical sum {warm_sum:.1f}s >= 60s "
            f"(iters A={tA} B={tB})")

    # ---- round-1 continuity: Case B anchor flow vs reference-equivalent ----
    n = cubeB.size
    flat = np.ascontiguousarray(
        np.moveaxis(cubeB.view(np.uint16), 0, -1)).ravel()
    # same chunking as the canonical sweep's device plan (CCSDS121Codec
    # plan_chunk): the anchor flow then reuses the chunk-stats programs the
    # sweep already compiled, instead of compiling a second pair of shapes
    # in the same process
    CHUNK = 1 << 22
    xj = jnp.asarray(flat)
    cj = jnp.asarray(cubeB.view(np.uint16))
    vj = jnp.ones((size, size), bool)

    t0 = time.perf_counter()
    _ = ck_dev.encode_plan(xj, chunk=CHUNK)
    q = quality_stats(cj.astype(jnp.int32), cj.astype(jnp.int32), vj)
    s = spectral_stats(cj.astype(jnp.int32), cj.astype(jnp.int32), vj)
    jax.block_until_ready((q, s))
    log(f"anchor warmup: {time.perf_counter()-t0:.1f}s")

    from concurrent.futures import ThreadPoolExecutor
    t_dev = []
    bs = b""
    for _ in range(3):
        t0 = time.perf_counter()
        # pipeline: the device computes the exact-size plan and the metric
        # reductions WHILE the host C++ encoder runs (ctypes releases the
        # GIL, so the plan's table fetch proceeds in the worker thread)
        with ThreadPoolExecutor(1) as tp:
            fplan = tp.submit(ck_dev.encode_plan, xj, chunk=CHUNK)
            qs = quality_stats(cj.astype(jnp.int32), cj.astype(jnp.int32),
                               vj)
            ss = spectral_stats(cj.astype(jnp.int32), cj.astype(jnp.int32),
                                vj)
            if (os.cpu_count() or 1) > 1:
                plan = fplan.result()
                bs = ck.encode_parallel(flat, plan)
            else:
                bs = ck.encode(flat, 16)
                plan = fplan.result()
        size_model = (plan["total_bits"] + 7) // 8
        if (os.cpu_count() or 1) > 1:
            dec = ck.decode_parallel(bs, plan)
        else:
            dec = ck.decode(bs, flat.size, 16)
        assert np.array_equal(dec, flat), "lossless verify failed"
        jax.block_until_ready((qs, ss))
        t_dev.append(time.perf_counter() - t0)
    t_anchor = min(t_dev)
    assert size_model == len(bs), "device size model mismatch"
    met = assemble_quality({k: np.asarray(v) for k, v in qs.items()},
                           effective_data_range(cubeB, "int16"))
    assert met["lossless"] == 1
    log(f"anchor flow: {t_anchor:.2f}s  (runs {['%.2f' % t for t in t_dev]})"
        f"  stream {len(bs)/1e6:.1f} MB")

    if ae.available():
        t_ref = []
        for _ in range(3):
            t0 = time.perf_counter()
            bs_ref = ae.encode(flat, 16)
            dec_ref = ae.decode(bs_ref, flat.size, 16)
            assert np.array_equal(dec_ref, flat)
            _ = reference_metrics_numpy(cubeB, cubeB, 8191)
            t_ref.append(time.perf_counter() - t0)
        t_reference = min(t_ref)
        assert bs_ref == bs, "tpukit bitstream differs from libaec"
        log(f"reference-equivalent anchor flow: {t_reference:.2f}s")
    else:
        t_reference = float("nan")

    # ---- scene-scale configuration (reference runs/scene/index_caseA.json
    # geometry: the 2000x10000 x4-band 12-in-16 Case A scene; synthetic
    # content, like everything here). ccsds121 streams in 512-row strips
    # with bounded host memory (the reference wrapper windows scenes into
    # 512^2 tiles, ccsds121_wrap.py:170-219); j2k runs the whole-scene
    # device fast path (transfer-free DWT ladder; the ebcot tier-1 path
    # is per-tile host work and is benched by the canonical tiles).
    from tpukit.sweep.proc import MemorySampler, rss_bytes
    scene = {}
    sc_h, sc_w, sc_b = 2000, 10000, 4
    gy, gx = np.mgrid[0:sc_h, 0:sc_w]
    sbase = ((700 + 1.1 * gy + 0.7 * gx).astype(np.int32)) % 4096
    scube = np.clip(sbase[None] + rng.integers(-300, 300,
                                               (sc_b, sc_h, sc_w)),
                    0, 4095).astype(np.uint16) << 4
    ps = work / "caseA_scene_12in16.tif"
    tiff.write_geotiff(ps, scube, blockxsize=512, blockysize=512)
    n_scene = scube.size
    scene_mb = scube.nbytes / (1 << 20)
    idxS = work / "index_scene.json"
    write_manifest(idxS, "caseA", "scene",
                   [{"tile_id": "sceneA", "path": ps}])
    del scube, sbase, gy, gx

    for name, args in (
            ("ccsds121_stream512", [
                "--indices", str(idxS), "--codec", "ccsds121",
                "--rate-key", "none", "--reps", "1", "--preproc", "none",
                "--nbit", "16", "--interleave", "bip", "--tile", "512",
                "--stream-rows", "512"]),
            # scene J2K is TILED (the reference's own scene JP2s use
            # TILEXSIZE/TILEYSIZE, j2k_wrap.py:81): every 1024² tile
            # rides the same compiled device program. A whole-scene
            # single-tile device ladder is rejected by the compiler at
            # this size (the exact size-model program unrolls per
            # subband segment — measured 80 MB of MLIR at 2000x10000).
            ("j2k_device_tiled1024", [
                "--indices", str(idxS), "--codec", "j2k",
                "--entropy", "device", "--rate-key", "quality",
                "--rates", "40", "--reps", "1",
                "--tilex", "1024", "--tiley", "1024",
                "--no-artifacts"])):
        outdir = work / f"runs_scene_{name}"
        rss0 = rss_bytes()
        t0 = time.perf_counter()
        with MemorySampler() as ms:
            run_codec_main(args + ["--outdir", str(outdir)])
        dt = time.perf_counter() - t0
        delta_mb = (max(ms.peak_bytes or 0, rss0) - rss0) / (1 << 20)
        scene[name] = {
            "wall_s": round(dt, 2),
            "Msamples_per_s": round(n_scene / dt / 1e6, 1),
            "rss_delta_mb": round(delta_mb, 1),
            "scene_mb": round(scene_mb, 1),
        }
        log(f"[scene {name}] {dt:.1f}s "
            f"{n_scene / dt / 1e6:.1f} Ms/s rss_delta {delta_mb:.0f} MB")
        shutil.rmtree(outdir, ignore_errors=True)
    # bounded-memory check for the streamed run: the strip pipeline must
    # hold strips, not the scene (cube 160 MB + recon + f32 metric temps
    # would need >600 MB unstreamed). A violation lands IN the record and
    # fails the bench after the JSON line (same policy as the warm-sum
    # gate).
    scene_rss_ok = scene["ccsds121_stream512"]["rss_delta_mb"] < 500
    shutil.rmtree(work, ignore_errors=True)
    speedup = (t_reference / t_anchor) if np.isfinite(t_reference) else None
    print(json.dumps({
        "metric": "canonical_sweeps_wall_s",
        "value": round(t_total, 2),
        "unit": "s (caseA j2k 14pt x2 tiles x3 HONEST reps + caseB "
                "ccsds121 anchor x3 HONEST reps, canonical run-codec "
                "CLI, artifacts on)",
        "vs_baseline": round(speedup, 2) if speedup else None,
        "detail": {
            "device": device,
            "north_star_s": 60,
            "north_star_met": bool(t_total < 60),
            "rep_semantics": "honest (every rep re-executes codec "
                             "points + its own metric lanes; reference "
                             "run_codec.py:472-475 workload)",
            "t_dedupe_reps_wall_s": round(t_dedupe, 2),
            "phase_breakdown_warm": phase_best,
            "t_caseA_canonical_s": round(t_caseA, 2),
            "t_caseB_canonical_s": round(t_caseB, 2),
            "t_total_median_s": round(t_total_median, 2),
            "iters_caseA_s": [round(t, 2) for t in tA],
            "iters_caseB_s": [round(t, 2) for t in tB],
            "iter0_sum_s": round(tA[0] + tB[0], 2),
            "t_anchor_flow_s": round(t_anchor, 3),
            "t_reference_anchor_flow_s": (round(t_reference, 3)
                                          if np.isfinite(t_reference)
                                          else None),
            "anchor_Msamples_per_s": round(n / t_anchor / 1e6, 2),
            "bitstream_bytes": len(bs),
            "cr_vs_raw16": round(cubeB.nbytes / len(bs), 3),
            "lossless": 1,
            "bitstream_equals_libaec": bool(ae.available()),
            "warm_sum_s": round(warm_sum, 2),
            "scene": scene,
        },
    }))
    # loud gates AFTER the measurement line (see warm_sum comment above)
    assert warm_sum < 60, (
        f"REGRESSION: warm canonical sum {warm_sum:.1f}s >= 60s "
        f"(iters A={tA} B={tB})")
    assert scene_rss_ok, (
        f"REGRESSION: streamed scene RSS delta not bounded: "
        f"{scene.get('ccsds121_stream512')}")


if __name__ == "__main__":
    main()
