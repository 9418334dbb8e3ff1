# -*- coding: utf-8 -*-
"""Multi-chip sharding on the virtual 8-device CPU mesh + graft entries."""

import numpy as np
import jax
import pytest


def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_dryrun_multichip_2():
    import __graft_entry__ as ge
    ge.dryrun_multichip(2)


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    sizes = np.asarray(out["bitstream_bytes"])
    assert sizes.shape == (2,)
    assert (sizes > 0).all()
    me = np.asarray(out["quality"]["maxerr"])
    assert (me <= 3).all() and (me > 0).any()


def test_sharded_matches_single_device(rng):
    """Sharded execution must produce identical sizes/metrics to vmap on one
    device (collectives change layout, not math)."""
    from tpukit.parallel.mesh import make_mesh, run_sharded_batch, analysis_step_fn
    import jax.numpy as jnp
    T, B, H, W = 4, 4, 32, 32
    tiles = rng.integers(0, 4096, (T, B, H, W)).astype(np.uint16)
    recons = (tiles + rng.integers(0, 3, tiles.shape).astype(np.uint16))
    valid = rng.random((T, H, W)) > 0.2

    mesh = make_mesh(jax.devices("cpu")[:4], dp=2, sp=2)
    sharded = run_sharded_batch(tiles, recons, valid, mesh)
    single = jax.jit(analysis_step_fn)(jnp.asarray(tiles), jnp.asarray(recons),
                                       jnp.asarray(valid))
    np.testing.assert_array_equal(sharded["bitstream_bytes"],
                                  np.asarray(single["bitstream_bytes"]))
    np.testing.assert_array_equal(sharded["quality"]["maxerr"],
                                  np.asarray(single["quality"]["maxerr"]))
    np.testing.assert_allclose(sharded["quality"]["sse"],
                               np.asarray(single["quality"]["sse"]), rtol=1e-6)


def test_device_size_matches_cpp_through_step(rng):
    """End-to-end: the sharded step's size equals the real encoder output."""
    from tpukit.parallel.mesh import run_sharded_batch, make_mesh
    from tpukit.native import ccsds121_host as ck
    T, B, H, W = 2, 4, 32, 32
    tiles = rng.integers(0, 2048, (T, B, H, W)).astype(np.uint16)
    out = run_sharded_batch(tiles, tiles, np.ones((T, H, W), bool),
                            make_mesh(jax.devices("cpu")[:2], dp=2, sp=1))
    for t in range(T):
        flat = np.moveaxis(tiles[t], 0, -1).ravel()
        assert out["bitstream_bytes"][t] == len(ck.encode(flat, 16))


def test_sharded_metric_ladder_matches_single(rng):
    """The mesh-sharded quality+spectral ladder equals the single-device
    ladder for two codec families' reconstructions (SURVEY §2.3 item 3)."""
    import jax.numpy as jnp
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.registry import create
    from tpukit.metrics.quality import quality_stats_ladder
    from tpukit.metrics.spectral import spectral_stats_ladder
    from tpukit.parallel.mesh import (make_mesh, place_ladder_inputs,
                                      sharded_metric_ladder)

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (4, 32, 32)),
                   0, 4095).astype(np.uint16)
    recons = []
    for res in create("j2k", entropy="device").sweep_rates(
            cube, "uint16", [RateSpec.of("quality", q) for q in (15, 60)]):
        recons.append(np.asarray(res.recon))
    for res in create("ccsds122").sweep_rates(
            cube, "uint16", [RateSpec.of("bpp", v) for v in (1.0, 4.0)]):
        recons.append(np.asarray(res.recon))
    vm = rng.random((32, 32)) > 0.1

    mesh = make_mesh(jax.devices("cpu")[:8], dp=4, sp=2)
    step = sharded_metric_ladder(mesh, has_nodata=False, caseb=True)
    refj, stack, vmj, samj, nodj, n_real = place_ladder_inputs(
        mesh, cube, recons, vm, vm, 0.0)
    qs, ss = step(refj, stack, vmj, samj, nodj)
    assert n_real == 4

    qs1 = quality_stats_ladder(jnp.asarray(cube),
                               jnp.asarray(np.stack(recons)),
                               jnp.asarray(vm), jnp.float32(0.0), False)
    ss1 = spectral_stats_ladder(jnp.asarray(cube),
                                jnp.asarray(np.stack(recons)),
                                jnp.asarray(vm))
    for k in qs1:
        np.testing.assert_allclose(np.asarray(qs[k])[:n_real],
                                   np.asarray(qs1[k]), rtol=1e-5)
    for k in ss1:
        np.testing.assert_allclose(np.asarray(ss[k])[:n_real],
                                   np.asarray(ss1[k]), rtol=1e-5)


def test_sweep_csv_identical_dp1_vs_dp8(tmp_path, rng):
    """run-codec --mesh: the CSV is bit-identical between dp=1 and dp=8
    (sharding changes layout, not results)."""
    from tpukit.codecs.registry import create
    from tpukit.io import tiff, write_manifest
    from tpukit.sweep.runner import SweepConfig, run_sweep

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (4, 32, 32)),
                   0, 4095).astype(np.uint16)
    p = tmp_path / "t.tif"
    tiff.write_geotiff(p, cube)
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseA", "tile", [{"tile_id": "T", "path": p}])

    csvs = {}
    for name, mesh in (("dp1", "1"), ("dp8", "8"), ("dp4sp2", "4,2")):
        cfg = SweepConfig(
            indices=idx, codec=create("j2k", entropy="device"), codec_label="j2k",
            outdir=tmp_path / f"runs_{name}", rate_key="quality",
            rates=[20, 60], reps=2, write_artifacts=False,
            quicklooks=False, mesh=mesh)
        run_sweep(cfg)
        csvs[name] = (tmp_path / f"runs_{name}" / "metrics.csv").read_text()

    # timing/memory columns differ run to run; compare the rest
    import csv as csvmod
    import io

    def stable(text):
        rows = list(csvmod.reader(io.StringIO(text), delimiter=";"))
        hdr = rows[0]
        drop = {i for i, h in enumerate(hdr)
                if h.startswith(("t_", "mem_"))}
        return [[v for i, v in enumerate(r) if i not in drop]
                for r in rows]

    assert stable(csvs["dp1"]) == stable(csvs["dp8"]) == stable(csvs["dp4sp2"])


def test_sharded_j2k_model_matches_host_coder(rng):
    """The sharded J2K quantized-coefficient model prices tiles byte-exactly
    vs the native embedded coder."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpukit.codecs import wavelet_common as wc
    from tpukit.codecs.j2k_codec import LEVELS, _subband_steps, \
        base_step_for_quality
    from tpukit.kernels import dwt as dwtk
    from tpukit.parallel.mesh import make_mesh, sharded_j2k_model

    T, B, H, W = 4, 2, 32, 32
    tiles = rng.integers(0, 4096, (T, B, H, W)).astype(np.float32)
    mesh = make_mesh(jax.devices("cpu")[:4], dp=4, sp=1)
    step = sharded_j2k_model(mesh, levels=LEVELS)

    order = wc.scan_order(H, W, LEVELS)
    scale = _subband_steps(H, W, 1.0)
    base = base_step_for_quality(40, 4095.0)
    rep = NamedSharding(mesh, P())
    sizes = np.asarray(step(
        jax.device_put(tiles, NamedSharding(mesh, P("dp", None, None, None))),
        jax.device_put(scale, rep),
        jax.device_put(np.float32(base), rep),
        jax.device_put(order.astype(np.int32), rep)))

    for t in range(T):
        coefs = np.asarray(dwtk.dwt2(jnp.asarray(tiles[t]), "97", LEVELS))
        qc = np.trunc(coefs / (scale * np.float32(base))[None]).astype(np.int32)
        # the mesh model prices the triple entropy backend (wenc)
        expect = sum(len(wc.wenc_encode(qc[b].ravel()[order]))
                     for b in range(B))
        assert int(sizes[t]) == expect

    # the per-subband segment layout (what the sweep's device ladder uses)
    segb = wc.subband_seg_bounds(H, W, LEVELS)
    step_sb = sharded_j2k_model(mesh, levels=LEVELS, segbounds=segb)
    sizes_sb = np.asarray(step_sb(
        jax.device_put(tiles, NamedSharding(mesh, P("dp", None, None, None))),
        jax.device_put(scale, rep),
        jax.device_put(np.float32(base), rep),
        jax.device_put(order.astype(np.int32), rep)))
    for t in range(T):
        coefs = np.asarray(dwtk.dwt2(jnp.asarray(tiles[t]), "97", LEVELS))
        qc = np.trunc(coefs / (scale * np.float32(base))[None]).astype(np.int32)
        expect = sum(len(wc.wenc_encode(qc[b].ravel()[order], segbounds=segb))
                     for b in range(B))
        assert int(sizes_sb[t]) == expect


def test_mesh_sweep_artifacts_match_single_device(tmp_path, rng):
    """--mesh with artifacts on: the host fallback artifact path (no fused
    device quicklook ladder) writes the same recon.tif and error maps as
    the single-device fused path."""
    from tpukit.codecs.registry import create
    from tpukit.io import tiff, write_manifest
    from tpukit.sweep.runner import SweepConfig, run_sweep

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (4, 32, 32)),
                   0, 4095).astype(np.uint16)
    p = tmp_path / "t.tif"
    tiff.write_geotiff(p, cube)
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseA", "tile", [{"tile_id": "T", "path": p}])

    outs = {}
    for name, mesh in (("single", None), ("mesh", "4")):
        cfg = SweepConfig(
            indices=idx, codec=create("j2k", entropy="device"), codec_label="j2k",
            outdir=tmp_path / f"runs_{name}", rate_key="quality",
            rates=[20], reps=1, mesh=mesh)
        run_sweep(cfg)
        d = tmp_path / f"runs_{name}" / "T" / "quality_20" / "rep_01"
        outs[name] = d
    files = sorted(q.name for q in outs["single"].iterdir())
    assert files == sorted(q.name for q in outs["mesh"].iterdir())
    assert "recon.tif" in files
    assert any(f.startswith("recon_ERR8_0_") for f in files)
    for f in files:
        assert (outs["single"] / f).read_bytes() == \
            (outs["mesh"] / f).read_bytes(), f


def test_sweep_rows_match_caseb_spectral_single_vs_mesh(tmp_path, rng):
    """--mesh on a Case B sweep: the dp=4,sp=2-sharded SAM/SID/LMSE
    ladder matches dp=1 to f32 reduction tolerance (sharding reassociates
    the sums), with exact agreement on sizes/flags."""
    from tpukit.codecs.registry import create
    from tpukit.io import tiff, write_manifest
    from tpukit.sweep.runner import SweepConfig, run_sweep

    base = rng.integers(300, 3000, (24, 24)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (8, 24, 24)),
                   -8192, 8191).astype(np.int16)
    p = tmp_path / "tb.tif"
    tiff.write_geotiff(p, cube)
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseB", "tile", [{"tile_id": "T", "path": p}])

    rowsets = {}
    for name, mesh in (("dp1", "1"), ("dp4sp2", "4,2")):
        cfg = SweepConfig(
            indices=idx, codec=create("j2k", entropy="device"), codec_label="j2k",
            outdir=tmp_path / f"runs_{name}", rate_key="quality",
            rates=[15, 60], reps=2, write_artifacts=False,
            quicklooks=False, mesh=mesh)
        rowsets[name] = run_sweep(cfg)["rows"]

    for a, b in zip(rowsets["dp1"], rowsets["dp4sp2"]):
        assert np.isfinite(a["sam_deg"]) and a["sam_deg"] > 0
        for k in ("bitstream_bytes", "lossless", "max_abs_err", "bpp", "cr"):
            assert a[k] == b[k], k
        for k in ("psnr_global", "ssim_global", "sam_deg", "sid", "lmse"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_sharded_ccsds122_ladder_matches_host_coder(rng):
    """dp x sp sharded CCSDS-122 point: reconstruction and per-band byte
    counts equal the native encode->truncated-decode round trip."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpukit.codecs import wavelet_common as wc
    from tpukit.kernels import dwt as dwtk
    from tpukit.parallel.mesh import make_mesh, sharded_ccsds122_ladder

    T, B, H, W = 4, 2, 32, 32
    tiles = rng.integers(0, 4096, (T, B, H, W)).astype(np.int32)
    budget = int(1.5 * H * W / 8.0)
    mesh = make_mesh(jax.devices("cpu")[:8], dp=4, sp=2)
    step = sharded_ccsds122_ladder(mesh, levels=3)

    order = wc.scan_order(H, W, 3)
    inv = wc.inverse_scan_order(H, W, 3)
    rep = NamedSharding(mesh, P())
    rec, sizes = step(
        jax.device_put(tiles, NamedSharding(mesh, P("dp", "sp", None, None))),
        jax.device_put(order.astype(np.int32), rep),
        jax.device_put(inv.astype(np.int32), rep),
        jax.device_put(np.int32(budget), rep))
    rec, sizes = np.asarray(rec), np.asarray(sizes)

    from tpukit.codecs.ccsds122_codec import subband_weight_map
    wmap = subband_weight_map(H, W)
    wperm = wmap.ravel()[order]
    for t in range(T):
        coefs = np.asarray(dwtk.dwt2(jnp.asarray(tiles[t]), "97m", 3)) * wmap
        for b in range(B):
            c = coefs[b].ravel()[order].astype(np.int32)
            assert int(sizes[t, b]) == len(wc.bpc_encode(c, budget))
        want = np.asarray(dwtk.idwt2(jnp.asarray(np.stack([
            np.rint(wc.bpc_decode(wc.bpc_encode(
                coefs[b].ravel()[order].astype(np.int32), budget),
                H * W).astype(np.float32) / wperm).astype(np.int32)
            [inv].reshape(H, W) for b in range(B)])), "97m", 3))
        np.testing.assert_array_equal(rec[t], want)


def test_mesh_j2k_quality_ladder_matches_single(rng):
    """Codec-phase parallelism: the mesh J2K quality ladder (one
    identical single-point program dispatched per device) prices every
    point byte-exactly like the single-device vmapped ladder (the
    quantizer is multiplies only — no FMA hazard) and reconstructs
    within the +-1 LSB that f32 fusion differences between program
    shapes allow; point results are independent of the device count."""
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.registry import create
    from tpukit.parallel.mesh import make_mesh

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (4, 32, 32)),
                   0, 4095).astype(np.uint16)
    specs = [RateSpec.of("quality", q) for q in (10, 35, 80)]
    single = create("j2k", entropy="device").sweep_rates(cube, "uint16", specs)
    mesh = make_mesh(jax.devices("cpu")[:8], dp=4, sp=2)
    meshed = create("j2k", entropy="device").sweep_rates(cube, "uint16", specs, mesh=mesh)
    mesh1 = make_mesh(jax.devices("cpu")[:1], dp=1, sp=1)
    meshed1 = create("j2k", entropy="device").sweep_rates(cube, "uint16", specs, mesh=mesh1)
    for s, m, m1 in zip(single, meshed, meshed1):
        assert s.bitstream_bytes == m.bitstream_bytes
        assert s.extras["quality_used"] == m.extras["quality_used"]
        diff = (np.asarray(s.recon).astype(np.int32)
                - np.asarray(m.recon).astype(np.int32))
        assert np.abs(diff).max() <= 1
        # ANY device count runs the identical executable: bit-equal
        np.testing.assert_array_equal(np.asarray(m.recon),
                                      np.asarray(m1.recon))
        assert m.bitstream_bytes == m1.bitstream_bytes


def test_mesh_bpe122_ladder_matches_single(rng):
    """Codec-phase sharding: the mesh CCSDS-122 BPE budget ladder equals
    the single-device model ladder bit for bit (integer math)."""
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.registry import create
    from tpukit.parallel.mesh import make_mesh

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (4, 32, 32)),
                   0, 4095).astype(np.uint16)
    specs = [RateSpec.of("bpp", v) for v in (0.5, 1.5, 16.0)]
    single = create("ccsds122").sweep_rates(cube, "uint16", specs)
    mesh = make_mesh(jax.devices("cpu")[:8], dp=4, sp=2)
    meshed = create("ccsds122").sweep_rates(cube, "uint16", specs,
                                            mesh=mesh)
    for s, m in zip(single, meshed):
        assert s.bitstream_bytes == m.bitstream_bytes
        np.testing.assert_array_equal(np.asarray(s.recon),
                                      np.asarray(m.recon))


def test_mesh_artifacts_match_single_device(tmp_path, rng):
    """--mesh artifact parity: recon.tif, RGB8 and ERR8 quicklooks from a
    mesh sweep are byte-identical to the single-device sweep's (integer
    codec: the ccsds122 BPE ladder and the e8 maps are exact on both
    paths)."""
    from tpukit.codecs.registry import create
    from tpukit.io import tiff, write_manifest
    from tpukit.sweep.runner import SweepConfig, run_sweep

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (4, 32, 32)),
                   0, 4095).astype(np.uint16)
    p = tmp_path / "t.tif"
    tiff.write_geotiff(p, cube)
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseA", "tile", [{"tile_id": "T", "path": p}])

    for name, mesh in (("single", None), ("mesh", "4,2")):
        cfg = SweepConfig(
            indices=idx, codec=create("ccsds122"), codec_label="ccsds122",
            outdir=tmp_path / f"runs_{name}", rate_key="bpp",
            rates=[1.0, 4.0], reps=2, ql_rgb=True, mesh=mesh)
        run_sweep(cfg)

    sdir, mdir = tmp_path / "runs_single", tmp_path / "runs_mesh"
    sfiles = sorted(q.relative_to(sdir) for q in sdir.rglob("*.tif"))
    mfiles = sorted(q.relative_to(mdir) for q in mdir.rglob("*.tif"))
    assert sfiles == mfiles and sfiles
    assert any("ERR8" in str(f) for f in sfiles)
    assert any("RGB8" in str(f) for f in sfiles)
    for f in sfiles:
        assert (sdir / f).read_bytes() == (mdir / f).read_bytes(), f


def test_ccsds121_mesh_codec_phase_plan_matches_single(rng):
    """Codec-phase mesh sharding for CCSDS-121: the per-chunk analyses
    round-robin over the mesh devices and the folded plan is IDENTICAL to
    the default-backend plan (integer model, layout-invariant), so the
    packed stream stays byte-exact vs the serial coder."""
    from tpukit.codecs import ccsds121 as dev
    from tpukit.native import ccsds121_host as ck

    n = 16 * 4096                       # multiple of J*rsi = 16
    x = (rng.integers(0, 1 << 14, n).astype(np.uint16) << 2)
    devs = jax.devices("cpu")[:8]
    pm = dev.encode_plan(x, bits=16, chunk=8192, devices=devs)
    ps = dev.encode_plan(x, bits=16, chunk=8192)
    assert pm is not None and ps is not None
    assert pm == ps
    bs = ck.encode_parallel(x, pm)
    assert bs == ck.encode(x, 16)
    assert (pm["total_bits"] + 7) // 8 == len(bs)


def test_ccsds121_codec_mesh_run_matches_host(rng):
    """CCSDS121Codec.run with a mesh in ctx (the runner's mesh mode) uses
    the sharded plan and still produces the libaec-byte-exact stream and
    a lossless recon."""
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.ccsds121_codec import CCSDS121Codec
    from tpukit.native import ccsds121_host as ck
    from tpukit.parallel.mesh import make_mesh

    B, H, W = 6, 64, 64
    cube = ((rng.integers(0, 1 << 14, (B, H, W)).astype(np.uint16)) << 2) \
        .view(np.int16)
    mesh = make_mesh(jax.devices("cpu")[:4], dp=4, sp=1)
    codec = CCSDS121Codec(tile=64, interleave="bip", preproc="none",
                          plan_chunk=4096)
    cache: dict = {}
    res = codec.run(cube, "int16", RateSpec.of("none", None), mesh=mesh,
                    device_plan_cache=cache)
    assert np.array_equal(res.recon, cube)
    # run() awaits the sharded plan and caches it; a second run reuses it
    plans = [v for k, v in cache.items()
             if isinstance(k, tuple) and len(k) == 10]
    assert len(plans) == 1 and plans[0] is not None
    res = codec.run(cube, "int16", RateSpec.of("none", None), mesh=mesh,
                    device_plan_cache=cache)
    assert np.array_equal(res.recon, cube)
    flat = np.ascontiguousarray(
        np.moveaxis(cube.view(np.uint16), 0, -1)).ravel()
    assert res.bitstream_bytes == len(ck.encode(flat, 16))


def test_mesh_keep_bitstream_j2k_matches_single(rng):
    """Mesh + --keep-bitstream (round-3 VERDICT #3): the j2k quality
    ladder on a mesh materializes REAL streams host-side after the
    sharded model pass — byte-identical to the single-device run's
    streams, with each point's total length equal to the mesh size
    model's count (asserted inside the codec)."""
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.registry import create
    from tpukit.parallel.mesh import make_mesh

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (4, 32, 32)),
                   0, 4095).astype(np.uint16)
    specs = [RateSpec.of("quality", q) for q in (10, 35, 80)]
    single = create("j2k", entropy="device").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True)
    mesh = make_mesh(jax.devices("cpu")[:8], dp=4, sp=2)
    meshed = create("j2k", entropy="device").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True, mesh=mesh)
    for s, m in zip(single, meshed):
        assert m.bitstreams and s.bitstreams.keys() == m.bitstreams.keys()
        for k in s.bitstreams:
            assert s.bitstreams[k] == m.bitstreams[k], k
        assert m.bitstream_bytes == sum(len(v)
                                        for v in m.bitstreams.values())


def test_mesh_keep_bitstream_ccsds122_matches_single(rng):
    """Mesh + --keep-bitstream for the 122 BPE budget ladder: real
    CCSDS 122.0-B segments per budget, byte-identical to the
    single-device run and to the model's byte counts."""
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.registry import create
    from tpukit.parallel.mesh import make_mesh

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (4, 32, 32)),
                   0, 4095).astype(np.uint16)
    specs = [RateSpec.of("bpp", v) for v in (0.5, 1.5)]
    single = create("ccsds122").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True)
    mesh = make_mesh(jax.devices("cpu")[:8], dp=4, sp=2)
    meshed = create("ccsds122").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True, mesh=mesh)
    for s, m in zip(single, meshed):
        assert m.bitstreams and s.bitstreams.keys() == m.bitstreams.keys()
        for k in s.bitstreams:
            assert s.bitstreams[k] == m.bitstreams[k], k
        assert m.bitstream_bytes == sum(len(v)
                                        for v in m.bitstreams.values())


def test_mesh_ebcot_identical_by_construction(rng):
    """The DEFAULT j2k backend (ebcot) under --mesh: the codec phase is
    host C++ + CPU-deterministic pricing, so a mesh run produces the
    byte-identical streams and recons of the single-device run by
    construction (documented in _sweep_ebcot — not a silent fallback:
    the runner still shards the metric/quicklook phases)."""
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.registry import create
    from tpukit.parallel.mesh import make_mesh

    base = rng.integers(300, 3000, (32, 32)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-80, 80, (2, 32, 32)),
                   0, 4095).astype(np.uint16)
    specs = [RateSpec.of("quality", q) for q in (20, 60)]
    single = create("j2k", entropy="ebcot").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True)
    mesh = make_mesh(jax.devices("cpu")[:4], dp=2, sp=2)
    meshed = create("j2k", entropy="ebcot").sweep_rates(
        cube, "uint16", specs, keep_bitstream=True, mesh=mesh)
    for s, m in zip(single, meshed):
        assert s.bitstreams.keys() == m.bitstreams.keys()
        for k in s.bitstreams:
            assert s.bitstreams[k] == m.bitstreams[k], k
        np.testing.assert_array_equal(np.asarray(s.recon),
                                      np.asarray(m.recon))


def test_mesh_honest_vs_dedupe_same_outputs(tmp_path, rng):
    """Mesh mode, honest (default) vs --dedupe-reps: identical
    deterministic outputs (sizes + metrics) while honest runs one metric
    lane per (rate, rep) with content-group upload sharing across the
    mesh devices."""
    import csv as csvmod
    import io

    from tpukit.codecs.registry import create
    from tpukit.io import tiff, write_manifest
    from tpukit.sweep.runner import SweepConfig, run_sweep

    base = rng.integers(100, 3000, (48, 48)).astype(np.int32)
    cube = np.clip(base[None] + rng.integers(-200, 200, (3, 48, 48)),
                   0, 4095).astype(np.uint16)
    p = tmp_path / "t.tif"
    tiff.write_geotiff(p, cube)
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseA", "tile", [{"tile_id": "T", "path": p}])

    def stable(path):
        rows = list(csvmod.reader(io.StringIO(path.read_text()),
                                  delimiter=";"))
        hdr = rows[0]
        drop = {i for i, c in enumerate(hdr)
                if c.startswith(("t_", "mem_", "hbm_"))}
        return [[v for i, v in enumerate(r) if i not in drop]
                for r in rows]

    outs = {}
    for name, ded in (("honest", False), ("dedupe", True)):
        cfg = SweepConfig(
            indices=idx, codec=create("j2k", entropy="device"),
            codec_label="j2k", outdir=tmp_path / f"runs_{name}",
            rate_key="quality", rates=[20, 60], reps=3,
            write_artifacts=False, quicklooks=False, mesh="4",
            dedupe_reps=ded)
        run_sweep(cfg)
        outs[name] = stable(tmp_path / f"runs_{name}" / "metrics.csv")
    assert outs["honest"] == outs["dedupe"]
    assert len(outs["honest"]) == 1 + 2 * 3   # header + 2 rates x 3 reps


def test_build_mesh_keeps_default_platform():
    """--mesh takes devices only from the default device's platform."""
    from tpukit.sweep.runner import _build_mesh

    dflt = jax.config.jax_default_device.platform
    for spec, n in (("1", 1), ("4", 4), ("2,2", 4), ("4,2", 8)):
        devs = list(_build_mesh(spec).devices.flat)
        assert len(devs) == n
        assert {d.platform for d in devs} == {dflt}


def test_build_mesh_raises_when_platform_short():
    """Too few devices on the default platform is an error, never a
    silent move to another platform."""
    from tpukit.sweep.runner import _build_mesh

    have = len(jax.devices(jax.config.jax_default_device.platform))
    with pytest.raises(ValueError, match=f"needs {have + 1} "):
        _build_mesh(str(have + 1))
