# -*- coding: utf-8 -*-
"""End-to-end sweep: synthetic Case B-like tiles -> CCSDS-121 lossless ->
metrics.csv + metrics_mean.csv with the reference schema."""

import csv
import json
import math

import numpy as np
import pytest

from tpukit.codecs.registry import create
from tpukit.io import tiff, write_manifest
from tpukit.sweep.runner import SweepConfig, run_sweep
from tpukit.sweep import csvio


@pytest.fixture
def caseb_setup(tmp_path, rng):
    tiles = {}
    items = []
    for tid in ("LC", "HC"):
        amp = 6 if tid == "LC" else 60
        base = rng.integers(200, 1800, (32, 32)).astype(np.int32)
        cube = (base[None] + rng.integers(-amp, amp, (12, 32, 32))).astype(np.int16)
        cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)
        p = tmp_path / f"caseB_tile_{tid}.tif"
        tiff.write_geotiff(p, cube)
        mask = np.ones((32, 32), np.uint8)
        mask[:4, :] = 0
        mp = tmp_path / f"caseB_tile_{tid}_mask.tif"
        tiff.write_geotiff(mp, mask, nodata=0)
        tiles[tid] = cube
        items.append({"tile_id": tid, "path": p, "mask": mp})
    idx = tmp_path / "index_caseB.json"
    write_manifest(idx, "caseB", "tile_512", items)
    return idx, tiles


def test_sweep_ccsds121_lossless(tmp_path, caseb_setup):
    idx, tiles = caseb_setup
    cfg = SweepConfig(
        indices=idx,
        codec=create("ccsds121", tile=32, interleave="bip", preproc="none"),
        codec_label="ccsds121_ext",
        outdir=tmp_path / "runs",
        rate_key="none",
        reps=2,
        keep_bitstream=True,
        ql_rgb=True,
    )
    res = run_sweep(cfg)
    rows = res["rows"]
    assert len(rows) == 4  # 2 tiles x 2 reps
    for row in rows:
        assert row["lossless"] == 1
        assert row["max_abs_err"] == 0
        assert row["cr"] > 1.0
        assert row["bpp"] < 16.0
        assert np.isinf(row["psnr_global"])
        assert np.isfinite(row["sam_deg"])  # Case B extras computed
        assert row["t_e2e_tile_s"] > row["t_link_tile_s"] > 0

    # artifacts
    assert (tmp_path / "runs" / "LC" / "norate" / "rep_01" / "recon.tif").exists()
    bit = list((tmp_path / "runs" / "LC" / "norate" / "rep_01" / "bit").glob("*.aec"))
    assert bit, "bitstreams kept on disk"
    # recon roundtrip from disk
    with tiff.open(tmp_path / "runs" / "HC" / "norate" / "rep_01" / "recon.tif") as ds:
        np.testing.assert_array_equal(ds.read(), tiles["HC"])
    # quicklooks written
    ql = list((tmp_path / "runs" / "LC" / "norate" / "rep_01").glob("recon_ERR8_0_*.tif"))
    assert ql

    # CSV schema
    mcsv = res["metrics_csv"]
    with mcsv.open() as f:
        r = csv.reader(f, delimiter=";")
        header = next(r)
        first = next(r)
    assert header[:8] == ["case", "asset", "codec", "encoder", "nearlossless_eps",
                          "rate_key", "rate_value", "tile_id"]
    assert "psnr_b12" in header and "psnr_b13" not in header
    assert "inf" in first  # lossless psnr literal

    # mean CSV + lossless_all override
    mean = res["mean_csv"]
    df = csvio.read_csv_smart(mean)
    assert set(df["tile_id"]) == {"LC", "HC"}
    assert (df["lossless_all"] == 1).all()
    assert (df["n_reps"] == 2).all()
    assert (df["ssim_global_rep"] == 1.0).all()

    # resume: second run reuses recon (no re-encode -> t_wrap 0)
    res2 = run_sweep(cfg)
    assert all(r["t_wrap_s"] == 0.0 for r in res2["rows"])
    for r1, r2 in zip(res["rows"], res2["rows"]):
        assert r1["bitstream_bytes"] == r2["bitstream_bytes"]


def test_sweep_matches_reference_bitstream_sizes(tmp_path, caseb_setup):
    """bitstream_bytes in the CSV equals summed libaec output (the number
    the reference wrapper reports at ccsds121_wrap.py:228)."""
    from tpukit.native import libaec_oracle as ae
    if not ae.available():
        pytest.skip("libaec oracle absent")
    idx, tiles = caseb_setup
    cfg = SweepConfig(
        indices=idx,
        codec=create("ccsds121", tile=32, interleave="bip", preproc="none"),
        codec_label="ccsds121_ext",
        outdir=tmp_path / "runs2",
        reps=1, quicklooks=False, write_artifacts=False,
    )
    rows = run_sweep(cfg)["rows"]
    for row in rows:
        cube = tiles[row["tile_id"]]
        flat = np.moveaxis(cube.view(np.uint16), 0, -1).ravel()
        expected = len(ae.encode(flat, 16))
        assert row["bitstream_bytes"] == expected


def test_err8_lut_matches_host_formula(rng):
    """The device error-map LUT reproduces error_max8_from_arrays'
    fixed-cap uint8 scaling bit-exactly for every integer error value."""
    from tpukit.viz.quicklooks import err8_lut, error_max8_from_arrays
    a = rng.integers(0, 65535, (3, 17, 23)).astype(np.uint16)
    b = rng.integers(0, 65535, (3, 17, 23)).astype(np.uint16)
    valid = rng.random((17, 23)) > 0.2
    err = np.max(np.abs(a.astype(np.int32) - b.astype(np.int32)), axis=0)
    err = np.where(valid, err, 0)
    for cap in (1, 100, 255, 4095, 65535):
        e8_host, cap_used = error_max8_from_arrays(a, b, valid, cap)
        assert cap_used == cap
        lut = err8_lut(cap)
        np.testing.assert_array_equal(lut[np.clip(err, 0, 65535)], e8_host)


def test_sweep_rep_artifacts_are_shared_replicas(tmp_path, caseb_setup):
    """Reps of a deterministic codec carry identical artifact content
    (rep_02+ are hardlink replicas of rep_01's render)."""
    idx, tiles = caseb_setup
    cfg = SweepConfig(
        indices=idx,
        codec=create("ccsds121", tile=32, interleave="bip", preproc="none"),
        codec_label="ccsds121_ext",
        outdir=tmp_path / "runs3",
        rate_key="none",
        reps=3,
        keep_bitstream=True,
    )
    run_sweep(cfg)
    d1 = tmp_path / "runs3" / "LC" / "norate" / "rep_01"
    d3 = tmp_path / "runs3" / "LC" / "norate" / "rep_03"
    files1 = sorted(p.relative_to(d1) for p in d1.rglob("*") if p.is_file())
    files3 = sorted(p.relative_to(d3) for p in d3.rglob("*") if p.is_file())
    assert files1 == files3 and files1
    for rel in files1:
        assert (d1 / rel).read_bytes() == (d3 / rel).read_bytes()
    # the replica recon is a valid reconstruction
    with tiff.open(d3 / "recon.tif") as ds:
        np.testing.assert_array_equal(ds.read(), tiles["LC"])


def _casea_like_setup(tmp_path, rng):
    gy, gx = np.mgrid[0:64, 0:64]
    base = ((80 + 3 * gy + 2 * gx).astype(np.int32)) % 4096
    cube = np.clip(base[None] + rng.integers(-200, 200, (4, 64, 64)),
                   0, 4095).astype(np.uint16) << 4
    p = tmp_path / "caseA_tile.tif"
    tiff.write_geotiff(p, cube)
    idx = tmp_path / "index_caseA.json"
    write_manifest(idx, "caseA", "tile_64",
                   [{"tile_id": "T1", "path": p}])
    return idx, cube


def test_honest_reps_reexecute_per_rep(tmp_path, rng):
    """Default rep semantics (reference run_codec.py:472-475): every rep
    re-executes the codec points, so per-rep t_dec_s values are fresh
    wall measurements (never the bit-identical re-reported floats the
    dedupe path produces), metrics agree across reps, and the artifact
    files are still byte-identical hardlink replicas."""
    idx, cube = _casea_like_setup(tmp_path, rng)

    def run_mode(outdir, dedupe):
        cfg = SweepConfig(
            indices=idx, codec=create("j2k", entropy="ebcot"),
            codec_label="j2k_gdal", outdir=outdir,
            rate_key="quality", rates=[10, 40], reps=3,
            keep_bitstream=True, dedupe_reps=dedupe)
        return run_sweep(cfg)["rows"]

    rows = run_mode(tmp_path / "honest", False)
    by_rate = {}
    for r in rows:
        by_rate.setdefault(r["rate_value"], []).append(r)
    for rate, rr in by_rate.items():
        assert len(rr) == 3
        tcomp = [r["t_comp_s"] for r in rr]
        # three independent truncation spans never collide exactly
        assert len(set(tcomp)) > 1, f"rate {rate}: re-reported {tcomp}"
        # t_dec_s is the point's ONE real stream decode (reference
        # j2k_wrap.py:102-105 semantics, measured once per (tile, rate))
        # — identical across reps by design
        assert len({r["t_dec_s"] for r in rr}) == 1
        # deterministic content: metrics and sizes identical across reps
        assert len({r["bitstream_bytes"] for r in rr}) == 1
        assert len({r["psnr_global"] for r in rr}) == 1
        assert len({r["ssim_global"] for r in rr}) == 1
    # artifact replicas still share content
    d1 = tmp_path / "honest" / "T1" / "quality_10" / "rep_01"
    d3 = tmp_path / "honest" / "T1" / "quality_10" / "rep_03"
    for rel in sorted(p.relative_to(d1) for p in d1.rglob("*")
                      if p.is_file()):
        assert (d1 / rel).read_bytes() == (d3 / rel).read_bytes()

    # opt-in dedupe: reps re-report the first measured times exactly
    rows_d = run_mode(tmp_path / "dedupe", True)
    by_rate_d = {}
    for r in rows_d:
        by_rate_d.setdefault(r["rate_value"], []).append(r)
    for rate, rr in by_rate_d.items():
        assert len({r["t_dec_s"] for r in rr}) == 1
        assert len({r["t_comp_s"] for r in rr}) == 1
        assert len({r["bitstream_bytes"] for r in rr}) == 1
    # both modes agree on every deterministic output
    for rh, rd in zip(rows, rows_d):
        assert rh["bitstream_bytes"] == rd["bitstream_bytes"]
        assert rh["psnr_global"] == rd["psnr_global"]


def test_failed_item_keeps_finished_tiles_artifacts(tmp_path, rng):
    """Fail-fast on a broken item (reference run_codec.py:494-495), but a
    tile whose codec work already completed keeps its artifacts: the
    deferred finish stage is flushed best-effort before the raise."""
    cube = rng.integers(100, 4000, (3, 32, 32)).astype(np.uint16)
    p1 = tmp_path / "ok.tif"
    tiff.write_geotiff(p1, cube)
    p2 = tmp_path / "broken.tif"
    p2.write_bytes(b"II*\x00garbage")       # unreadable TIFF
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseA", "tile", [
        {"tile_id": "OK", "path": p1},
        {"tile_id": "BAD", "path": p2},
    ])
    cfg = SweepConfig(
        indices=idx, codec=create("ccsds121", tile=32, interleave="bip",
                                  preproc="none"),
        codec_label="ccsds121", outdir=tmp_path / "runs", rate_key="none")
    with pytest.raises(Exception):
        run_sweep(cfg)
    d = tmp_path / "runs" / "OK" / "norate" / "rep_01"
    assert (d / "recon.tif").exists()
    with tiff.open(d / "recon.tif") as ds:
        np.testing.assert_array_equal(ds.read(), cube)


def test_float_rate_values_survive_normalization(tmp_path, caseb_setup):
    """API callers pass real floats (the CLI passes strings): a fractional
    bpp must NOT be truncated to int (rate_value drives the codec and the
    run-dir slug)."""
    from tpukit.sweep.runner import _normalize_rates
    assert _normalize_rates("bpp", [0.75]) == [0.75]
    assert _normalize_rates("bpp", [2.0]) == [2]      # slug parity w/ CLI
    assert _normalize_rates("bpp", ["0.75"]) == [0.75]
    assert _normalize_rates("quality", [60]) == [60]

    idx, tiles = caseb_setup
    cfg = SweepConfig(
        indices=idx, codec=create("ccsds122"),
        codec_label="ccsds122_ext", outdir=tmp_path / "runs_frac",
        rate_key="bpp", rates=[0.75], reps=1, quicklooks=False,
        write_artifacts=False,
    )
    rows = run_sweep(cfg)["rows"]
    assert all(row["rate_value"] == 0.75 for row in rows)
    B, H, W = next(iter(tiles.values())).shape
    for row in rows:
        assert row["bitstream_bytes"] <= int(0.75 * H * W / 8) * B + B


def test_resume_ignores_corrupt_recon(tmp_path, caseb_setup):
    """An interrupted writer's leftover recon.tif (headerless/IFD-less)
    must be re-encoded, not trusted (and not crash the sweep)."""
    idx, tiles = caseb_setup
    outdir = tmp_path / "runs_corrupt"
    cfg = SweepConfig(
        indices=idx,
        codec=create("ccsds121", tile=32, interleave="bip", preproc="none"),
        codec_label="ccsds121_ext", outdir=outdir,
        reps=1, quicklooks=False, write_artifacts=True,
        keep_bitstream=True,
    )
    rows1 = run_sweep(cfg)["rows"]
    # corrupt one recon in place (simulates a kill mid-write of an older,
    # non-atomic writer)
    victim = next(outdir.rglob("recon.tif"))
    victim.write_bytes(b"II*\x00garbage")
    rows2 = run_sweep(cfg)["rows"]
    assert len(rows2) == len(rows1)
    for a, b in zip(rows1, rows2):
        assert a["bitstream_bytes"] == b["bitstream_bytes"]
        assert b["lossless"] == 1
    # the corrupt file was replaced by a valid re-encode
    from tpukit.io import tiff
    with tiff.open(victim) as ds:
        assert ds.read().shape[0] == 12


def test_single_csv_override(tmp_path, caseb_setup):
    """--single-csv redirects metrics.csv; metrics_mean.csv lands next to
    it (reference run_codec.py:402, :635)."""
    idx, _ = caseb_setup
    target = tmp_path / "elsewhere" / "my_metrics.csv"
    cfg = SweepConfig(
        indices=idx,
        codec=create("ccsds121", tile=32, interleave="bip", preproc="none"),
        codec_label="ccsds121_ext",
        outdir=tmp_path / "runs_sc",
        rate_key="none",
        reps=2,
        write_artifacts=False,
        quicklooks=False,
        single_csv=target,
    )
    res = run_sweep(cfg)
    assert res["metrics_csv"] == target.resolve()
    assert target.exists()
    assert (target.parent / "metrics_mean.csv").exists()
    assert not (tmp_path / "runs_sc" / "metrics.csv").exists()


def test_hbm_columns_present(tmp_path, caseb_setup, monkeypatch):
    """Device-memory observability: hbm_peak_mb/bytes columns ride at the
    end of metrics.csv (empty when the backend exposes no stats, filled
    from device.memory_stats() when it does — here stubbed, since the
    test suite pins the CPU backend)."""
    from tpukit.sweep import runner as runner_mod

    monkeypatch.setattr(runner_mod, "hbm_peak_bytes",
                        lambda: 123 * (1 << 20))
    idx, tiles = caseb_setup
    cfg = SweepConfig(
        indices=idx,
        codec=create("ccsds121", tile=32, interleave="bip", preproc="none"),
        codec_label="ccsds121_ext", outdir=tmp_path / "hbm",
        rate_key="none", reps=1, quicklooks=False)
    res = run_sweep(cfg)
    with res["metrics_csv"].open() as f:
        r = csv.reader(f, delimiter=";")
        header = next(r)
        first = next(r)
    # last base columns, before the per-band expansion
    assert header[len(csvio.BASE_COLS) - 2:len(csvio.BASE_COLS)] == \
        ["hbm_peak_mb", "hbm_peak_bytes"]
    row = dict(zip(header, first))
    assert row["hbm_peak_mb"] == "123"
    assert row["hbm_peak_bytes"] == str(123 * (1 << 20))
    for v in res["rows"]:
        assert v["hbm_peak_bytes"] == 123 * (1 << 20)


@pytest.mark.parametrize("codec_name,copts,rk,rates", [
    ("ccsds121", dict(tile=32, interleave="bip", preproc="none"), "none",
     None),
    ("jpegls", dict(), "none", None),
    ("png", dict(zlevel=1), "none", None),
    ("j2k", dict(entropy="device"), "quality", [40]),
    ("ccsds122", dict(), "bpp", [2.0]),
    ("ccsds123", dict(predictor="ls", tile=32), "none", None),
])
def test_honest_reps_all_codecs(tmp_path, rng, codec_name, copts, rk,
                                rates):
    """The honest-rep invariant for EVERY codec family: reps re-execute
    (per-rep t_comp_s are fresh wall measurements, never bit-identical
    re-reported floats) while deterministic outputs agree exactly across
    reps. Guards against a point-level rep cache sneaking into any codec
    (the round-4 finding, fixed in round 5)."""
    base = rng.integers(200, 1800, (24, 24)).astype(np.int32)
    cube = (base[None] + rng.integers(-40, 40, (4, 24, 24))) \
        .astype(np.int16)
    cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)
    p = tmp_path / "t.tif"
    tiff.write_geotiff(p, cube)
    idx = tmp_path / "i.json"
    write_manifest(idx, "caseB", "tile", [{"tile_id": "T", "path": p}])
    cfg = SweepConfig(
        indices=idx, codec=create(codec_name, **copts),
        codec_label=codec_name, outdir=tmp_path / "o",
        rate_key=rk, rates=rates, reps=2,
        quicklooks=False, write_artifacts=False)
    rows = run_sweep(cfg)["rows"]
    assert len(rows) == 2
    a, b = rows
    assert a["bitstream_bytes"] == b["bitstream_bytes"]
    assert a["psnr_global"] == b["psnr_global"]
    assert a["max_abs_err"] == b["max_abs_err"]
    # fresh per-rep codec walls: two independent perf_counter spans
    assert a["t_comp_s"] != b["t_comp_s"], (codec_name, a["t_comp_s"])


def test_metrics_csv_stdlib_reader_round_trip(tmp_path):
    """read_metrics_rows/parse_number (pandas-free) invert the writer's
    decimal-comma formatting, including inf and empty cells."""
    from tpukit.sweep.csvio import (parse_number, read_metrics_rows,
                                    write_metrics_csv)

    rows = [{"case": "caseA", "codec": "j2k", "tile_id": "HC",
             "rate_value": 20, "bitstream_bytes": 12345,
             "psnr_global": 51.123456, "ssim_global": 0.999871,
             "max_abs_err": 7, "lossless": 0},
            {"case": "caseA", "codec": "j2k", "tile_id": "LC",
             "rate_value": 100, "bitstream_bytes": 999,
             "psnr_global": float("inf"), "ssim_global": 1.0,
             "max_abs_err": 0, "lossless": 1}]
    p = write_metrics_csv(tmp_path / "metrics.csv", rows)
    got = read_metrics_rows(p)
    assert [r["tile_id"] for r in got] == ["HC", "LC"]
    assert got[0]["bitstream_bytes"] == "12345"
    assert parse_number(got[0]["psnr_global"]) == 51.123456
    assert parse_number(got[1]["psnr_global"]) == float("inf")
    assert math.isnan(parse_number(got[0]["sam_deg"]))
