# -*- coding: utf-8 -*-
"""Scene-scale strip streaming: StripWriter round-trips, streamed-vs-whole
sweep equality, and bounded host memory on a 2000x10000 synthetic scene
(the reference streams scenes in windowed passes, make_baseline_B.py:324-419;
its wrappers window into 512^2 tiles, ccsds121_wrap.py:170-219)."""

import math

import numpy as np
import pytest

from tpukit.codecs.registry import create
from tpukit.io import tiff, write_manifest
from tpukit.sweep.runner import SweepConfig, run_sweep


@pytest.fixture
def rng():
    return np.random.default_rng(7)


# ---------------------------------------------------------------------------
# StripWriter
# ---------------------------------------------------------------------------

def test_strip_writer_roundtrip(tmp_path, rng):
    B, H, W = 3, 1100, 230
    cube = rng.integers(0, 60000, (B, H, W)).astype(np.uint16)
    mask = rng.random((H, W)) > 0.3
    p = tmp_path / "s.tif"
    with tiff.StripWriter(p, count=B, height=H, width=W, dtype=np.uint16,
                          rows_per_strip=128, nodata=5, with_mask=True,
                          descriptions=("x", "y", "z")) as sw:
        for y0 in range(0, H, 256):
            rows = min(256, H - y0)
            sw.write(y0, cube[:, y0:y0 + rows])
            sw.write_mask(y0, mask[y0:y0 + rows])
    with tiff.open(p) as ds:
        assert (ds.read() == cube).all()
        assert ds.nodata == 5
        assert ds.descriptions == ("x", "y", "z")
        assert ((ds.dataset_mask() > 0) == mask).all()
        win = tiff.Window(col_off=13, row_off=129, width=100, height=300)
        assert (ds.read(window=win) == cube[:, 129:429, 13:113]).all()
        assert ((ds.dataset_mask(window=win) > 0) == mask[129:429, 13:113]).all()


def test_strip_writer_rejects_misaligned(tmp_path):
    sw = tiff.StripWriter(tmp_path / "m.tif", count=1, height=100, width=8,
                          dtype=np.uint8, rows_per_strip=32)
    with pytest.raises(ValueError):
        sw.write(10, np.zeros((1, 32, 8), np.uint8))
    sw.write(0, np.zeros((1, 64, 8), np.uint8))
    with pytest.raises(ValueError):
        sw.write(64, np.zeros((1, 48, 8), np.uint8))  # beyond H
    sw.write(64, np.zeros((1, 36, 8), np.uint8))      # short last strip ok
    sw.close()
    with tiff.open(tmp_path / "m.tif") as ds:
        assert ds.read().shape == (1, 100, 8)


def test_windowed_read_of_deflate_tiles(tmp_path, rng):
    cube = rng.integers(0, 4000, (2, 300, 400)).astype(np.uint16)
    p = tmp_path / "d.tif"
    tiff.write_geotiff(p, cube, compress="DEFLATE", blockxsize=64,
                       blockysize=64, nodata=1)
    with tiff.open(p) as ds:
        win = tiff.Window(col_off=33, row_off=65, width=222, height=100)
        assert (ds.read(window=win) == cube[:, 65:165, 33:255]).all()


# ---------------------------------------------------------------------------
# streamed sweep == whole-cube sweep
# ---------------------------------------------------------------------------

_METRIC_KEYS = ("psnr_global", "ssim_global", "psnr_band_avg",
                "ssim_band_avg", "max_abs_err", "lossless", "bpp", "cr",
                "bitstream_bytes")


def _assert_rows_match(rows_a, rows_b, spectral=False):
    assert len(rows_a) == len(rows_b)
    for ra, rb in zip(rows_a, rows_b):
        for k in _METRIC_KEYS:
            va, vb = ra.get(k), rb.get(k)
            if isinstance(va, float) and math.isinf(va):
                assert math.isinf(vb)
            elif isinstance(va, float):
                assert vb == pytest.approx(va, rel=1e-5, abs=1e-7), k
            else:
                assert va == vb, k
        for i in (1, 2):
            pa, pb = ra.get(f"psnr_b{i}"), rb.get(f"psnr_b{i}")
            if pa is not None and math.isfinite(pa):
                assert pb == pytest.approx(pa, rel=1e-5)
        if spectral:
            for k in ("sam_deg", "sid", "lmse"):
                va, vb = ra.get(k), rb.get(k)
                if va is not None and math.isfinite(va):
                    assert vb == pytest.approx(va, rel=1e-4, abs=1e-9), k


def _make_scene(tmp_path, rng, name, B=4, H=1280, W=320, dtype=np.uint16,
                nodata=0, mask=True):
    gy = np.arange(H, dtype=np.int32)[:, None]
    base = (200 + 3 * gy + rng.integers(0, 900, (B, H, W))).astype(np.int32)
    if dtype == np.uint16:
        cube = np.clip(base, 0, 4095).astype(np.uint16) << 4
    else:
        cube = ((np.clip(base - 500, -8192, 8191).astype(np.int16)
                 .view(np.uint16) >> 2) << 2).view(np.int16)
    if nodata is not None:
        cube[:, :64] = nodata          # an all-NoData stripe
        cube[:, 400:432, :100] = nodata
    p = tmp_path / f"{name}.tif"
    tiff.write_geotiff(p, cube, nodata=nodata)
    item = {"tile_id": name, "path": p}
    if mask:
        mv = np.ones((H, W), np.uint8)
        mv[:80] = 0
        mv[:, :16] = 0
        mp = tmp_path / f"{name}_mask.tif"
        tiff.write_geotiff(mp, mv, nodata=0)
        item["mask"] = mp
    return cube, item


def _cfg(idx, outdir, codec, **kw):
    kw.setdefault("reps", 1)
    return SweepConfig(indices=idx, codec=codec, codec_label=codec.name,
                       outdir=outdir, rate_key="none",
                       quicklooks=False, **kw)


def test_streamed_equals_whole_ccsds121(tmp_path, rng):
    cube, item = _make_scene(tmp_path, rng, "SC")
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseA", "scene", [item])

    r_whole = run_sweep(_cfg(idx, tmp_path / "whole",
                             create("ccsds121", tile=256, preproc="diff1"),
                             keep_bitstream=True))
    r_strm = run_sweep(_cfg(idx, tmp_path / "strm",
                            create("ccsds121", tile=256, preproc="diff1"),
                            keep_bitstream=True, stream_rows=512))
    _assert_rows_match(r_whole["rows"], r_strm["rows"])
    # identical recon artifacts and identical total bitstream bytes
    rw = tiff.open(tmp_path / "whole/SC/norate/rep_01/recon.tif").read()
    rs = tiff.open(tmp_path / "strm/SC/norate/rep_01/recon.tif").read()
    assert (rw == rs).all() and (rs == cube).all()
    bw = sorted((tmp_path / "whole/SC/norate/rep_01/bit").rglob("*"))
    bs = sorted((tmp_path / "strm/SC/norate/rep_01/bit").rglob("*"))
    assert sum(p.stat().st_size for p in bw) == \
        sum(p.stat().st_size for p in bs)


def test_streamed_caseb_spectral_and_resume(tmp_path, rng):
    """Case B semantics under streaming: SAM/SID/LMSE accumulate across
    strips (with Sobel halos) identically to the whole-cube pass — exercised
    through RESUMED noisy recons so the spectral metrics are non-trivial."""
    cube, item = _make_scene(tmp_path, rng, "SB", B=6, H=1024, W=256,
                             dtype=np.int16, nodata=None)
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseB", "scene", [item])

    # pre-seed both outdirs with the SAME noisy recon (resume path)
    noisy = (cube.astype(np.int32)
             + rng.integers(-12, 12, cube.shape)).astype(np.int16)
    for out in ("whole", "strm"):
        d = tmp_path / out / "SB" / "norate" / "rep_01"
        d.mkdir(parents=True)
        tiff.write_geotiff(d / "recon.tif", noisy)

    codec = lambda: create("ccsds121", tile=256, preproc="none",
                           interleave="bsq")
    r_whole = run_sweep(_cfg(idx, tmp_path / "whole", codec()))
    r_strm = run_sweep(_cfg(idx, tmp_path / "strm", codec(),
                            stream_rows=256))
    _assert_rows_match(r_whole["rows"], r_strm["rows"], spectral=True)
    row = r_strm["rows"][0]
    assert row["lossless"] == 0 and row["max_abs_err"] > 0
    assert math.isfinite(row["sam_deg"]) and row["sam_deg"] > 0
    assert math.isfinite(row["lmse"]) and row["lmse"] > 0


def test_streamed_reps_and_mean_csv(tmp_path, rng):
    cube, item = _make_scene(tmp_path, rng, "SR", B=2, H=768, W=128,
                             mask=False)
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseA", "scene", [item])
    res = run_sweep(_cfg(idx, tmp_path / "out",
                         create("ccsds121", tile=256), stream_rows=256,
                         reps=2))
    assert len(res["rows"]) == 2
    assert res["mean_csv"] is not None
    for r in res["rows"]:
        assert r["lossless"] == 1
        assert np.isinf(r["psnr_global"])


def test_streamed_ccsds123_nodata_mask_passthrough(tmp_path, rng):
    cube, item = _make_scene(tmp_path, rng, "S3", B=3, H=768, W=128,
                             dtype=np.int16, nodata=-32768, mask=False)
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseB", "scene", [item])
    res = run_sweep(_cfg(idx, tmp_path / "out",
                         create("ccsds123", tile=128, crop_nodata=True),
                         stream_rows=256))
    row = res["rows"][0]
    assert row["lossless"] == 1
    # recon mask passthrough (ccsds123_wrap.py:279-283) survives streaming
    with tiff.open(tmp_path / "out/S3/norate/rep_01/recon.tif") as ds:
        assert (ds.read() == cube).all()
        m = ds.dataset_mask()
        assert (m[:64] == 0).all()      # the all-NoData stripe
        assert (m[500:] > 0).all()


def test_bounded_rss_scene_sweep(tmp_path, rng):
    """VERDICT item 10 'done' criterion: a 2000x10000 scene sweep with
    bounded RSS. The whole-cube path would need >= cube + recon + f32
    metric temporaries (>= 950 MB); streaming must stay well under."""
    import gc
    from tpukit.sweep.proc import rss_bytes

    B, H, W = 4, 2000, 10000
    gy = np.arange(H, dtype=np.uint16)[:, None]
    cube = np.empty((B, H, W), np.uint16)
    for b in range(B):    # build band-by-band to keep the fixture cheap
        cube[b] = ((gy * 3 + b * 97) % 4096) << 4
        cube[b, :, ::7] ^= 16 << 4
    p = tmp_path / "scene.tif"
    tiff.write_geotiff(p, cube, nodata=0, compress="DEFLATE", zlevel=1)
    del cube
    gc.collect()
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseA", "scene",
                   [{"tile_id": "SCENE", "path": p}])

    gc.collect()
    rss0 = rss_bytes()
    peak = rss0

    import threading
    stop = threading.Event()

    def poll():
        nonlocal peak
        while not stop.is_set():
            peak = max(peak, rss_bytes())
            stop.wait(0.02)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        res = run_sweep(_cfg(idx, tmp_path / "out",
                             create("ccsds121", tile=250),
                             stream_rows=250, write_artifacts=False))
    finally:
        stop.set()
        th.join(timeout=5)
    row = res["rows"][0]
    assert row["lossless"] == 1
    assert row["bitstream_bytes"] > 0
    delta_mb = (peak - rss0) / (1 << 20)
    # cube alone is 160 MB; whole-cube sweep needs >= 950 MB of deltas.
    assert delta_mb < 450, f"RSS delta {delta_mb:.0f} MB — not bounded"


def test_streamed_partial_resume_no_reencode(tmp_path, rng):
    """Partial resume: a rep whose recon exists must NOT be re-encoded or
    have fresh strip bitstreams written into its reused run_dir; reps that
    are missing still run and produce correct rows."""
    cube, item = _make_scene(tmp_path, rng, "PR", B=2, H=768, W=128,
                             mask=False)
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseA", "scene", [item])
    codec = lambda: create("ccsds121", tile=256)

    # full run with 1 rep seeds rep_01 (artifacts + bitstreams)
    run_sweep(_cfg(idx, tmp_path / "out", codec(), stream_rows=256,
                   keep_bitstream=True))
    d1 = tmp_path / "out" / "PR" / "norate" / "rep_01"
    bits_before = sorted((p.name, p.stat().st_mtime_ns)
                         for p in (d1 / "bit").rglob("*"))
    mtime_before = (d1 / "recon.tif").stat().st_mtime_ns

    # resume with 2 reps: rep_01 reused untouched (names AND mtimes —
    # byte-identical rewrites must not happen either), rep_02 fresh
    res = run_sweep(_cfg(idx, tmp_path / "out", codec(), stream_rows=256,
                         keep_bitstream=True, reps=2))
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in (d1 / "bit").rglob("*")) == bits_before
    assert (d1 / "recon.tif").stat().st_mtime_ns == mtime_before
    rows = res["rows"]
    assert len(rows) == 2
    assert rows[0]["t_wrap_s"] == 0.0          # reused rep: zeroed timing
    assert rows[1]["t_wrap_s"] > 0.0           # fresh rep actually ran
    for r in rows:
        assert r["lossless"] == 1
        assert r["bitstream_bytes"] == rows[0]["bitstream_bytes"]
    d2 = tmp_path / "out" / "PR" / "norate" / "rep_02"
    with tiff.open(d2 / "recon.tif") as ds2:
        np.testing.assert_array_equal(ds2.read(), cube)


def test_streamed_quicklooks_match_batched(tmp_path, rng):
    """Streamed items produce the run_codec.py:511-520 quicklook artifacts:
    ERR8 maps byte-identical to the batched path (integer compares + the
    same fixed-cap LUT and writer), RGB8 within the stretch-pass deviation
    (exact-histogram percentiles interpolate in float64 where the batched
    path uses np.percentile on float32) — VERDICT round-2 missing #5."""
    cube, item = _make_scene(tmp_path, rng, "QL")
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseA", "scene", [item])

    def cfg(outdir, **kw):
        return SweepConfig(
            indices=idx, codec=create("ccsds121", tile=256),
            codec_label="ccsds121", outdir=outdir, rate_key="none",
            reps=2, quicklooks=True, ql_rgb=True, ql_err_global=255,
            ql_err_zoom=15, **kw)

    run_sweep(cfg(tmp_path / "whole"))
    run_sweep(cfg(tmp_path / "strm", stream_rows=512))

    wdir = tmp_path / "whole/QL/norate"
    sdir = tmp_path / "strm/QL/norate"
    for rep in ("rep_01", "rep_02"):
        for cap in (255, 15):
            name = f"{rep}/recon_ERR8_0_{cap}.tif"
            wb = (wdir / name).read_bytes()
            sb = (sdir / name).read_bytes()
            assert wb == sb, name
        for name in ("baseline_RGB8.tif", "recon_RGB8.tif"):
            a = tiff.open(wdir / rep / name).read()
            b = tiff.open(sdir / rep / name).read()
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1, (name, int(d.max()))


def test_streamed_mesh_equals_single_device(tmp_path, rng):
    """--mesh + --stream-rows (round-3 VERDICT #6): streamed scenes shard
    their metric lanes round-robin over the mesh devices (identical
    single-lane programs — the batched runner's determinism scheme) and
    forward the mesh into the codec ctx, instead of warn-and-fallback.
    CSV metric columns, recon/quicklook artifacts and bitstreams are all
    BYTE-IDENTICAL vs the single-device streamed run."""
    cube, item = _make_scene(tmp_path, rng, "MS", B=5, H=1024, W=192,
                             dtype=np.int16, nodata=-9999)
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseB", "scene", [item])

    rows = {}
    for name, mesh in (("single", None), ("mesh", "4"), ("mesh2", "2")):
        codec = create("ccsds121", tile=256, preproc="diff1")
        r = run_sweep(SweepConfig(
            indices=idx, codec=codec, codec_label=codec.name,
            outdir=tmp_path / name, rate_key="none",
            keep_bitstream=True, stream_rows=256, reps=2,
            quicklooks=True, ql_rgb=True, mesh=mesh))
        rows[name] = r["rows"]

    # metric/rate columns EXACTLY equal (same programs, different
    # placement); timing and memory columns legitimately differ
    skip = {"t_comp_s", "t_dec_s", "t_wrap_s", "t_link_tile_s",
            "t_e2e_tile_s", "mem_comp_peak_mb", "mem_dec_peak_mb",
            "mem_comp_peak_bytes", "mem_dec_peak_bytes"}
    for other in ("mesh", "mesh2"):
        assert len(rows["single"]) == len(rows[other])
        for ra, rb in zip(rows["single"], rows[other]):
            assert set(ra) == set(rb)
            for k in ra:
                if k not in skip:
                    assert ra[k] == rb[k], (other, k, ra[k], rb[k])

    # every artifact and bitstream byte-identical
    sdir = tmp_path / "single"
    for other in ("mesh", "mesh2"):
        mdir = tmp_path / other
        sfiles = sorted(q.relative_to(sdir) for q in sdir.rglob("*")
                        if q.is_file() and q.suffix != ".csv")
        mfiles = sorted(q.relative_to(mdir) for q in mdir.rglob("*")
                        if q.is_file() and q.suffix != ".csv")
        assert sfiles == mfiles and sfiles
        assert any("ERR8" in str(f) for f in sfiles)
        assert any("bit" in f.parts for f in sfiles)   # kept bitstreams
        for f in sfiles:
            assert (sdir / f).read_bytes() == (mdir / f).read_bytes(), \
                (other, f)


def test_streamed_honest_reps_metric_lanes(tmp_path, rng):
    """Honest (default) rep semantics in the streaming path: each fresh
    rep re-runs the codec (fresh per-rep t_comp_s) AND accumulates its
    own metric lane during its own pass; metric values agree across reps
    (deterministic codec), and --dedupe-reps reproduces the shared-lane
    behavior with identical deterministic outputs."""
    cube, item = _make_scene(tmp_path, rng, "HR", B=2, H=768, W=128,
                             mask=False)
    idx = tmp_path / "idx.json"
    write_manifest(idx, "caseA", "scene", [item])

    cfg_h = _cfg(idx, tmp_path / "honest", create("ccsds121", tile=256),
                 stream_rows=256, reps=3)
    rows_h = run_sweep(cfg_h)["rows"]
    assert len(rows_h) == 3
    tcomp = [r["t_comp_s"] for r in rows_h]
    assert len(set(tcomp)) > 1, f"re-reported per-rep walls: {tcomp}"
    assert len({r["bitstream_bytes"] for r in rows_h}) == 1
    assert len({r["psnr_global"] for r in rows_h}) == 1
    assert len({r["max_abs_err"] for r in rows_h}) == 1

    cfg_d = _cfg(idx, tmp_path / "dedupe", create("ccsds121", tile=256),
                 stream_rows=256, reps=3)
    cfg_d.dedupe_reps = True
    rows_d = run_sweep(cfg_d)["rows"]
    for rh, rd in zip(rows_h, rows_d):
        assert rh["bitstream_bytes"] == rd["bitstream_bytes"]
        assert rh["psnr_global"] == rd["psnr_global"]
        assert rh["sam_deg"] == rd["sam_deg"] or (
            np.isnan(rh["sam_deg"]) and np.isnan(rd["sam_deg"]))
