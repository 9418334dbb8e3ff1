# -*- coding: utf-8 -*-
"""CCSDS-123-class codec: lossless exactness + spectral-redundancy gains."""

import numpy as np
import pytest

from tpukit.codecs.base import RateSpec
from tpukit.codecs.ccsds123_codec import CCSDS123Codec


@pytest.fixture
def spectral_cube(rng):
    """Spectrally correlated int16 cube (shared spatial base × band gains)."""
    base = rng.integers(500, 3000, (32, 32)).astype(np.float64)
    gains = 1.0 + 0.3 * np.sin(np.linspace(0, 6, 16))
    cube = (base[None] * gains[:, None, None]
            + rng.normal(0, 8, (16, 32, 32))).astype(np.int16)
    return ((cube.view(np.uint16) >> 2) << 2).view(np.int16)


def test_lossless_roundtrip(spectral_cube):
    res = CCSDS123Codec().run(spectral_cube, "int16", RateSpec.none())
    np.testing.assert_array_equal(res.recon, spectral_cube)
    assert res.codec == "ccsds123_ext"
    assert res.extras["mode"] == "lossless_only"


def test_exploits_spectral_redundancy(spectral_cube):
    from tpukit.codecs.ccsds121_codec import CCSDS121Codec
    r123 = CCSDS123Codec().run(spectral_cube, "int16", RateSpec.none())
    r121 = CCSDS121Codec(tile=32, preproc="none").run(
        spectral_cube, "int16", RateSpec.none())
    assert r123.bitstream_bytes < r121.bitstream_bytes, \
        "inter-band predictor must beat the 1-D coder on correlated bands"


def test_uint16_and_random(rng):
    cube = rng.integers(0, 65536, (6, 16, 16)).astype(np.uint16)
    res = CCSDS123Codec().run(cube, "uint16", RateSpec.none())
    np.testing.assert_array_equal(res.recon, cube)


def test_keep_bitstream_and_decode_from_stream(spectral_cube):
    res = CCSDS123Codec().run(spectral_cube, "int16", RateSpec.none(),
                              keep_bitstream=True)
    bs = res.bitstreams["t_x00000_y00000.bit"]
    assert len(bs) == res.bitstream_bytes
    B, H, W = spectral_cube.shape
    out = CCSDS123Codec._decode(bs, B, H, W)
    np.testing.assert_array_equal(out.view(np.int16), spectral_cube)


def test_tiled_roundtrip_matches_whole(spectral_cube):
    """Real 512^2-style tiling (here 16^2 on a 32^2 cube): lossless and
    tile-independent (reference ccsds123_wrap.py:212-276 tile loop)."""
    whole = CCSDS123Codec(tile=0 or 64).run(spectral_cube, "int16",
                                            RateSpec.none())
    tiled = CCSDS123Codec(tile=16).run(spectral_cube, "int16",
                                       RateSpec.none(), keep_bitstream=True)
    np.testing.assert_array_equal(tiled.recon, spectral_cube)
    assert len(tiled.bitstreams) == 4  # 2x2 tile grid
    assert set(tiled.bitstreams) == {
        "t_x00000_y00000.bit", "t_x00016_y00000.bit",
        "t_x00000_y00016.bit", "t_x00016_y00016.bit"}
    assert tiled.bitstream_bytes == sum(len(b)
                                        for b in tiled.bitstreams.values())
    assert whole.bitstream_bytes > 0


def test_crop_nodata_skips_all_nodata_tiles(spectral_cube):
    """All-NoData tiles are excluded from the bitstream and reconstructed
    as nodata fill (reference ccsds123_wrap.py:191-229)."""
    cube = spectral_cube.copy()
    nd = -9999
    cube[:, :16, :] = nd  # top half: two full 16x16 nodata tiles

    plain = CCSDS123Codec(tile=16).run(cube, "int16", RateSpec.none())
    cropped = CCSDS123Codec(tile=16, crop_nodata=True).run(
        cube, "int16", RateSpec.none(), nodata=float(nd),
        keep_bitstream=True)

    assert cropped.extras["tiles_skipped_nodata"] == 2
    assert cropped.bitstream_bytes < plain.bitstream_bytes
    assert len(cropped.bitstreams) == 2  # only the bottom tiles coded
    np.testing.assert_array_equal(cropped.recon, cube)  # nd fill == source


def test_crop_nodata_via_dataset_mask(spectral_cube):
    """A zero dataset-mask window forces the skip even without a nodata
    value (reference _tile_is_all_nodata mask branch)."""
    mask = np.full((32, 32), 255, np.uint8)
    mask[:16, :16] = 0
    res = CCSDS123Codec(tile=16, crop_nodata=True).run(
        spectral_cube, "int16", RateSpec.none(), dataset_mask=mask)
    assert res.extras["tiles_skipped_nodata"] == 1
    # skipped tile fills with 0 when no nodata value exists
    assert (res.recon[:, :16, :16] == 0).all()
    np.testing.assert_array_equal(res.recon[:, 16:, :],
                                  spectral_cube[:, 16:, :])


def test_mask_passthrough_in_sweep(tmp_path, rng):
    """run_sweep writes the source validity mask into ccsds123 recons
    (reference ccsds123_wrap.py:279-283 dst.write_mask)."""
    from tpukit.io import tiff, write_manifest
    from tpukit.sweep.runner import SweepConfig, run_sweep

    cube = rng.integers(0, 2048, (4, 32, 32)).astype(np.uint16)
    cube[:, :8, :] = 0
    p = tmp_path / "t.tif"
    mask = (cube[0] != 0).astype(np.uint8) * 255
    tiff.write_geotiff(p, cube, nodata=0.0, mask=mask)
    idx = tmp_path / "index.json"
    write_manifest(idx, "caseB", "tile", [{"tile_id": "T", "path": p}])
    cfg = SweepConfig(
        indices=idx, codec=CCSDS123Codec(tile=32), codec_label="ccsds123_ext",
        outdir=tmp_path / "runs", quicklooks=False)
    rows = run_sweep(cfg)["rows"]
    assert rows[0]["lossless"] == 1
    with tiff.open(tmp_path / "runs" / "T" / "norate" / "rep_01" /
                   "recon.tif") as ds:
        np.testing.assert_array_equal(ds.dataset_mask(), mask)


def test_device_cube_reuse_matches_host_upload(spectral_cube):
    """run(device_cube=...) must skip the host upload yet produce the
    identical bitstream and recon — int16 rides the device bitcast."""
    import jax.numpy as jnp
    dev = jnp.asarray(spectral_cube)
    base = CCSDS123Codec().run(spectral_cube, "int16", RateSpec.none(),
                               keep_bitstream=True)
    via = CCSDS123Codec().run(spectral_cube, "int16", RateSpec.none(),
                              keep_bitstream=True, device_cube=dev)
    assert base.bitstreams == via.bitstreams
    np.testing.assert_array_equal(np.asarray(via.recon), spectral_cube)
    # wrong-shape device cube is ignored, not an error
    bad = CCSDS123Codec().run(spectral_cube, "int16", RateSpec.none(),
                              device_cube=dev[:, :16, :16])
    np.testing.assert_array_equal(np.asarray(bad.recon), spectral_cube)


def test_device_cube_reuse_uint16(rng):
    import jax.numpy as jnp
    cube = rng.integers(0, 65536, (6, 16, 16)).astype(np.uint16)
    via = CCSDS123Codec().run(cube, "uint16", RateSpec.none(),
                              device_cube=jnp.asarray(cube))
    np.testing.assert_array_equal(np.asarray(via.recon), cube)


def test_spectral_predictor_beats_1d_coder(rng):
    """The inter-band LS predictor must exploit spectral redundancy: on a
    spectrally-correlated cube its lossless stream is meaningfully smaller
    than the 1-D CCSDS-121 + diff1 path (the codec's reason to exist;
    measured ~+31% on this content class)."""
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.registry import create

    base = rng.normal(0, 1, (64, 64))
    k = np.ones(9) / 9.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    gains = 0.6 + 0.8 * np.abs(np.sin(np.linspace(0.3, 5.8, 24)))[:, None, None]
    cube = np.clip((500 + 6000 * base)[None] * gains
                   + rng.normal(0, 12, (24, 64, 64)), -8192, 8191) \
        .astype(np.int16)
    cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)

    r123 = create("ccsds123", tile=64).run(cube, "int16", RateSpec.none())
    r121 = create("ccsds121", preproc="diff1", interleave="bsq",
                  tile=64).run(cube, "int16", RateSpec.none())
    np.testing.assert_array_equal(np.asarray(r123.recon), cube)
    assert r123.bitstream_bytes < r121.bitstream_bytes * 0.92, \
        (r123.bitstream_bytes, r121.bitstream_bytes)


# ---- predictor='standard': CCSDS 123.0-B conformant path ----------------

def test_standard_roundtrip_int16(spectral_cube):
    res = CCSDS123Codec(predictor="standard").run(
        spectral_cube, "int16", RateSpec.none(), keep_bitstream=True)
    np.testing.assert_array_equal(res.recon, spectral_cube)
    assert res.extras["predictor"] == "standard"
    assert "123.0-B" in res.encoder


def test_standard_roundtrip_uint16_random(rng):
    cube = rng.integers(0, 65536, (6, 16, 16)).astype(np.uint16)
    res = CCSDS123Codec(predictor="standard").run(
        cube, "uint16", RateSpec.none())
    np.testing.assert_array_equal(res.recon, cube)


def test_standard_header_fields(spectral_cube):
    """Blue Book §5.3 header: geometry and parameters parse back."""
    from tpukit.codecs import ccsds123_std as std
    res = CCSDS123Codec(predictor="standard").run(
        spectral_cube, "int16", RateSpec.none(), keep_bitstream=True)
    bs = next(iter(res.bitstreams.values()))
    info = std.stream_info(bs)
    B, H, W = spectral_cube.shape
    assert (info["bands"], info["height"], info["width"]) == (B, H, W)
    assert info["D"] == 16 and info["signed"] and info["P"] == 3
    assert info["full_mode"] and not info["column_sums"]
    assert info["umax"] == 16


def test_standard_tiled_roundtrip(spectral_cube):
    res = CCSDS123Codec(tile=16, predictor="standard").run(
        spectral_cube, "int16", RateSpec.none(), keep_bitstream=True)
    np.testing.assert_array_equal(res.recon, spectral_cube)
    assert len(res.bitstreams) == 4
    assert all(k.endswith(".l123") for k in res.bitstreams)


def test_standard_modes_roundtrip(rng):
    """Reduced mode and column-oriented local sums round-trip too."""
    from tpukit.codecs import ccsds123_std as std
    cube = (rng.integers(0, 4096, (5, 17, 23)) << 2).astype(np.uint16)
    for full in (True, False):
        for colsum in (False, True):
            bs = std.encode(cube, is_signed=False, full_mode=full,
                            colsum=colsum)
            info = std.stream_info(bs)
            assert info["full_mode"] == full
            assert info["column_sums"] == colsum
            np.testing.assert_array_equal(std.decode(bs), cube)


def test_standard_beats_1d_coder(spectral_cube):
    """The sample-adaptive inter-band predictor must also exploit
    spectral redundancy (sanity: smaller than the 1-D CCSDS-121 coder)."""
    from tpukit.codecs.ccsds121_codec import CCSDS121Codec
    r_std = CCSDS123Codec(predictor="standard").run(
        spectral_cube, "int16", RateSpec.none())
    r121 = CCSDS121Codec(tile=32, preproc="none").run(
        spectral_cube, "int16", RateSpec.none())
    assert r_std.bitstream_bytes < r121.bitstream_bytes


def test_standard_encoding_orders_roundtrip(rng):
    """§4.2 encoding orders: BI streams (bil: M=1, bip: M=Nz, plus
    arbitrary sub-frame depths) decode exactly and record the order in
    the header. Total size is order-INVARIANT: prediction and the
    per-band entropy states depend only on order-invariant quantities,
    so only the bit interleaving changes."""
    from tpukit.codecs import ccsds123_std as std
    cube = rng.integers(0, 1 << 14, (7, 19, 13)).astype(np.uint16)
    ref = std.encode(cube, is_signed=False, order="bsq")
    for order in ("bil", "bip"):
        bs = std.encode(cube, is_signed=False, order=order)
        info = std.stream_info(bs)
        assert info["order"] == order
        assert info["subframe"] == (1 if order == "bil" else 7)
        np.testing.assert_array_equal(std.decode(bs), cube)
        assert len(bs) == len(ref) and bs != ref
    for M in (2, 3, 5):
        bs = std.encode(cube, is_signed=False, subframe=M)
        assert std.stream_info(bs)["subframe"] == M
        np.testing.assert_array_equal(std.decode(bs), cube)


def test_standard_orders_via_codec(spectral_cube):
    """--interleave bip/bil reaches the standard coder through the codec
    wrapper (the reference wrapper's knob, ccsds123_wrap.py:116)."""
    from tpukit.codecs import ccsds123_std as std
    for order in ("bip", "bil"):
        res = CCSDS123Codec(predictor="standard", interleave=order).run(
            spectral_cube, "int16", RateSpec.none(), keep_bitstream=True)
        np.testing.assert_array_equal(res.recon, spectral_cube)
        bs = next(iter(res.bitstreams.values()))
        assert std.stream_info(bs)["order"] == order
        assert res.extras["interleave"] == order


def test_standard_predictor_knobs_via_codec(spectral_cube):
    """pred_bands/pred_mode/local_sums (the CNES binaries' P/mode knobs)
    flow through the wrapper into the stream header."""
    from tpukit.codecs import ccsds123_std as std
    res = CCSDS123Codec(predictor="standard", pred_bands=5,
                        pred_mode="reduced", local_sums="column").run(
        spectral_cube, "int16", RateSpec.none(), keep_bitstream=True)
    np.testing.assert_array_equal(res.recon, spectral_cube)
    info = std.stream_info(next(iter(res.bitstreams.values())))
    assert info["P"] == 5
    assert not info["full_mode"]
    assert info["column_sums"]
    assert res.extras["pred_bands"] == 5
    assert res.extras["pred_mode"] == "reduced"
    assert res.extras["local_sums"] == "column"


def test_standard_bad_params_rejected():
    import pytest
    with pytest.raises(ValueError):
        CCSDS123Codec(predictor="standard", interleave="weird")
    with pytest.raises(ValueError):
        CCSDS123Codec(predictor="standard", pred_bands=16)
    with pytest.raises(ValueError):
        CCSDS123Codec(predictor="standard", pred_mode="banana")
    with pytest.raises(ValueError):
        CCSDS123Codec(predictor="standard", local_sums="diag")


def test_standard_block_adaptive_entropy(rng, spectral_cube):
    """§5.4.2 block-adaptive entropy: the CCSDS-121 block coder over the
    mapped residual sequence (no preprocessor), decoupled from
    prediction. Round-trips exactly in every encoding order, records
    entropy=block in the header, and flows through the codec wrapper."""
    from tpukit.codecs import ccsds123_std as std
    cube = rng.integers(0, 1 << 14, (6, 17, 19)).astype(np.uint16)
    for order in ("bsq", "bip", "bil"):
        bs = std.encode(cube, is_signed=False, order=order,
                        entropy="block")
        info = std.stream_info(bs)
        assert info["entropy"] == "block"
        np.testing.assert_array_equal(std.decode(bs), cube)

    res = CCSDS123Codec(predictor="standard", entropy="block").run(
        spectral_cube, "int16", RateSpec.none(), keep_bitstream=True)
    np.testing.assert_array_equal(res.recon, spectral_cube)
    bs = next(iter(res.bitstreams.values()))
    assert std.stream_info(bs)["entropy"] == "block"
    assert res.extras["entropy"] == "block"
    # block entropy is a standard-mode option only
    import pytest
    with pytest.raises(ValueError):
        CCSDS123Codec(predictor="ls", entropy="block")


def test_ls_weights_match_float64_solve():
    """The transmitted 4.12 weights of the ls predictor equal the
    quantized float64 least-squares solve within 1 LSB on a 180-band
    tile (the f32 normal equations run at HIGHEST precision, so a GPU
    computes them without TF32)."""
    import jax.numpy as jnp
    from tpukit.codecs.ccsds123_codec import FEAT_CLAMP, FRAC_BITS, P, \
        encode_model

    rng = np.random.default_rng(123)
    B, H, W = 180, 32, 32
    base = rng.integers(300, 3000, (H, W))
    gains = 0.5 + np.abs(np.sin(np.linspace(0.2, 5.0, B)))[:, None, None]
    cube = (base[None] * gains + rng.normal(0, 60, (B, H, W))) \
        .astype(np.uint16)
    _, wq = encode_model(jnp.asarray(cube))

    x = cube.astype(np.int64)
    d = (x - np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)) \
        % 65536
    c = np.where(d >= 32768, d - 65536, d).astype(np.float64)
    feats = [np.clip(np.concatenate([np.zeros_like(c[:j]), c[:-j]]),
                     -FEAT_CLAMP, FEAT_CLAMP) for j in range(1, P + 1)]
    F = np.stack(feats + [np.ones_like(c)], axis=1)      # (B, P+1, H, W)
    F[:, :, 0] = 0.0
    T = c.copy()
    T[:, 0] = 0.0
    Fm = F.reshape(B, P + 1, H * W)
    M = np.einsum("bfn,bgn->bfg", Fm, Fm) + 1e-3 * np.eye(P + 1)[None]
    v = np.einsum("bfn,bn->bf", Fm, T.reshape(B, H * W))
    w = np.linalg.solve(M, v[..., None])[..., 0]
    expect = np.clip(np.round(w * (1 << FRAC_BITS)), -32767, 32767)
    assert np.abs(np.asarray(wq, np.int64) - expect).max() <= 1
