# -*- coding: utf-8 -*-
"""Card-only tier: the device codec paths on an NVIDIA GPU against the
CPU platform, in one process.

Each check is a plain function of ``(dev, cube)``: the pytest cases below
run them on small cubes when a GPU is present (and skip otherwise), and
``python chip_smoke.py`` runs the same functions at real width on the card.
On a machine with a card the pytest tier runs as

    JAX_PLATFORMS=cpu,cuda python -m pytest tests/test_gpu_smoke.py -q

Integer paths (ccsds121 streams, ccsds122 byte counts + reconstructions,
ccsds123 `standard`, jpegls) must be EXACTLY equal across platforms. f32
paths (J2K's multiply-quantizer, the metric reductions, the ebcot pricing
program, the ls predictor's fitted weights) match within the stated
tolerances: f32 reduction and contraction order differ by backend.
"""
import numpy as np
import pytest

import jax

from tpukit.codecs.base import RateSpec
from tpukit.codecs.registry import create

pytestmark = pytest.mark.gpu


def _cpu():
    return jax.devices("cpu")[0]


def _run(codec, cube, specs, device, **kw):
    with jax.default_device(device):
        return codec.sweep_rates(cube, str(cube.dtype), specs, **kw)


def caseA_cube(size: int = 256, seed: int = 99) -> np.ndarray:
    """Case A-like 4-band uint16 12-in-16 tile."""
    rng = np.random.default_rng(seed)
    base = (600 + 3 * (np.arange(size)[:, None] % 1024)
            + rng.integers(0, 700, (4, size, size))).astype(np.int32)
    return np.clip(base, 0, 4095).astype(np.uint16) << 4


def caseB_cube(bands: int = 20, size: int = 40, seed: int = 5) -> np.ndarray:
    """Case B-like int16 14-in-16 hyperspectral tile."""
    rng = np.random.default_rng(seed)
    base = rng.integers(300, 1500, (size, size)).astype(np.int32)
    cube = (base[None] + rng.integers(-20, 20, (bands, size, size))) \
        .astype(np.int16)
    return ((cube.view(np.uint16) >> 2) << 2).view(np.int16)


def check_ccsds121_byte_equal(dev, cube):
    """The CCSDS-121 device encode plan (device diff1 + interleave, chunked
    split-cost model; four chunks per tile) yields byte-identical streams
    on both platforms (pure integer program)."""
    specs = [RateSpec.none()]
    chunk = cube[:, :512, :512].size // 4

    def run(device):
        return _run(create("ccsds121", preproc="diff1", plan_chunk=chunk),
                    cube, specs, device, keep_bitstream=True,
                    device_cube=jax.device_put(cube, device),
                    device_plan_cache={})[0]

    r_cpu = run(_cpu())
    r_dev = run(dev)
    assert r_cpu.bitstream_bytes == r_dev.bitstream_bytes
    assert r_cpu.bitstreams.keys() == r_dev.bitstreams.keys()
    for k in r_cpu.bitstreams:
        assert r_cpu.bitstreams[k] == r_dev.bitstreams[k], k
    assert np.array_equal(np.asarray(r_cpu.recon), np.asarray(r_dev.recon))


def check_ccsds122_ladder_integer_equal(dev, cube):
    """The CCSDS-122 BPE budget ladder (integer 9/7M DWT + integer
    stream-layout model) produces identical bytes and identical integer
    reconstructions on both platforms."""
    specs = [RateSpec.of("bpp", 1.0), RateSpec.of("bpp", 4.0)]
    rs_cpu = _run(create("ccsds122"), cube, specs, _cpu(),
                  keep_bitstream=True)
    rs_dev = _run(create("ccsds122"), cube, specs, dev, keep_bitstream=True)
    for rc, rd in zip(rs_cpu, rs_dev):
        assert rc.bitstream_bytes == rd.bitstream_bytes
        for k in rc.bitstreams:
            assert rc.bitstreams[k] == rd.bitstreams[k], k
        assert np.array_equal(np.asarray(rc.recon), np.asarray(rd.recon))


def check_j2k_quality_ladder(dev, cube):
    """One J2K device-backend quality ladder: stream sizes within 0.5%
    (f32 quantizer — last-ULP flips move a few coefficients across
    quantization bins) and recon MSE within 1%."""
    specs = [RateSpec.of("quality", 20), RateSpec.of("quality", 60)]
    rs_cpu = _run(create("j2k", entropy="device"), cube, specs, _cpu())
    rs_dev = _run(create("j2k", entropy="device"), cube, specs, dev)
    for rc, rd in zip(rs_cpu, rs_dev):
        assert rd.bitstream_bytes == pytest.approx(rc.bitstream_bytes,
                                                   rel=5e-3)
        mse_c = float(np.mean((np.asarray(rc.recon).astype(np.float64)
                               - cube) ** 2))
        mse_d = float(np.mean((np.asarray(rd.recon).astype(np.float64)
                               - cube) ** 2))
        assert mse_d == pytest.approx(mse_c, rel=1e-2)


def check_metric_pass(dev, cube):
    """One fused quality-stats pass: PSNR/SSIM agree to 1e-4 relative
    (f32 reduction order differs by backend), max|err| exactly."""
    from tpukit.metrics.quality import (assemble_quality,
                                        merge_quality_stats,
                                        quality_stats_dual)
    rng = np.random.default_rng(3)
    recon = (cube.astype(np.int32)
             + rng.integers(-48, 48, cube.shape)).clip(0, 65535) \
        .astype(np.uint16)
    vm = np.ones(cube.shape[1:], bool)

    def stats(device):
        qm, _ = quality_stats_dual(jax.device_put(cube, device),
                                   jax.device_put(recon, device),
                                   jax.device_put(vm, device))
        return assemble_quality(
            merge_quality_stats([{k: np.asarray(v)
                                  for k, v in qm.items()}]), 65535.0)

    m_cpu = stats(_cpu())
    m_dev = stats(dev)
    for k in ("psnr_global", "ssim_global", "psnr_band_avg",
              "ssim_band_avg"):
        assert m_dev[k] == pytest.approx(m_cpu[k], rel=1e-4), k
    assert m_dev["max_abs_err"] == m_cpu["max_abs_err"]


def check_j2k_ebcot_pricing(dev, cube):
    """The ebcot quality->byte-target pricing program (light size model:
    device DWT + ladder sizes) agrees across platforms within
    f32-quantizer tolerance. (The canonical sweep deliberately prices on
    the LOCAL CPU for topology-invariant budgets; this pins that the
    program itself is healthy on the card.)"""
    import jax.numpy as jnp
    from tpukit.codecs import j2k_codec as jc
    from tpukit.codecs import wavelet_common as wc
    from tpukit.kernels import dwt as dwtk

    B, H, W = cube.shape
    m = 1 << jc.LEVELS
    Hp, Wp = H + (-H) % m, W + (-W) % m
    order = wc.scan_order(Hp, Wp, jc.LEVELS)
    segb = wc.subband_seg_bounds(Hp, Wp, jc.LEVELS)
    peak = float(np.abs(cube.astype(np.float64)).max())
    scale_host = jc._subband_steps(Hp, Wp, 1.0)
    inv_perm = (np.float32(1.0) / scale_host).ravel()[np.asarray(order)]
    bases = np.array([jc.base_step_for_quality(q, peak)
                      for q in (10, 40, 80)], np.float32)

    def price(device):
        with jax.default_device(device):
            wf = jax.device_put(
                np.pad(cube.astype(np.float32),
                       ((0, 0), (0, Hp - H), (0, Wp - W)), mode="edge"),
                device)
            coefs = dwtk.dwt2(wf, "97", jc.LEVELS)
            return np.asarray(jc._device_ladder_sizes(
                coefs, jnp.asarray(order), jnp.asarray(inv_perm),
                jnp.asarray(np.float32(1.0) / bases), segbounds=segb,
                light=True))

    s_cpu = price(_cpu())
    s_dev = price(dev)
    assert s_cpu.shape == s_dev.shape
    np.testing.assert_allclose(s_dev.sum(axis=-1), s_cpu.sum(axis=-1),
                               rtol=5e-3)


def check_jpegls(dev, cube):
    """JPEG-LS under the card as default device: the coder is host C++
    (CharLS byte-compatible), so streams and recon must be EXACTLY equal
    to the CPU-platform run."""
    specs = [RateSpec.none()]
    r_cpu = _run(create("jpegls"), cube, specs, _cpu(),
                 keep_bitstream=True)[0]
    r_dev = _run(create("jpegls"), cube, specs, dev, keep_bitstream=True)[0]
    assert r_cpu.bitstream_bytes == r_dev.bitstream_bytes
    for k in r_cpu.bitstreams:
        assert r_cpu.bitstreams[k] == r_dev.bitstreams[k], k
    np.testing.assert_array_equal(np.asarray(r_cpu.recon),
                                  np.asarray(r_dev.recon))


def check_ccsds123(dev, cube):
    """CCSDS-123 on a hyperspectral tile, both predictors. The standard
    predictor is host C++: byte-identical streams on either platform. The
    ls predictor FITS its transmitted 4.12 weights with f32 normal
    equations on device (HIGHEST precision, no TF32) — a last-ULP
    platform difference can still flip a quantized weight, so streams are
    not byte-pinned: each platform's stream must round-trip losslessly
    and the sizes must agree within 2%."""
    for pred in ("ls", "standard"):
        res = {}
        for tag, device in (("cpu", _cpu()), ("dev", dev)):
            with jax.default_device(device):
                r = create("ccsds123", predictor=pred).run(
                    cube, "int16", RateSpec.none(), keep_bitstream=True)
            np.testing.assert_array_equal(np.asarray(r.recon), cube,
                                          err_msg=f"{pred}/{tag}")
            res[tag] = r
        if pred == "standard":
            assert res["dev"].bitstream_bytes == res["cpu"].bitstream_bytes
            for k in res["cpu"].bitstreams:
                assert res["dev"].bitstreams[k] == res["cpu"].bitstreams[k]
        else:
            assert res["dev"].bitstream_bytes == pytest.approx(
                res["cpu"].bitstream_bytes, rel=0.02)


def check_mesh_metric_ladder(dev, cube, workdir):
    """One run-codec sweep with --mesh 1 on the card: the mesh
    metric-ladder dispatch produces the same metric rows as the CPU run
    (integer codec; f32 metrics within tolerance)."""
    from tpukit.cli.main import run_codec_main
    from tpukit.io import tiff, write_manifest
    from tpukit.sweep import csvio

    p = workdir / "t.tif"
    tiff.write_geotiff(p, cube, blockxsize=128, blockysize=128)
    idx = workdir / "i.json"
    write_manifest(idx, "caseA", "tile", [{"tile_id": "T", "path": p}])

    rows = {}
    for tag, device in (("cpu", _cpu()), ("dev", dev)):
        with jax.default_device(device):
            run_codec_main([
                "--indices", str(idx), "--codec", "ccsds121",
                "--rate-key", "none", "--reps", "1", "--preproc", "none",
                "--nbit", "16", "--mesh", "1",
                "--outdir", str(workdir / f"o_{tag}")])
        rows[tag] = csvio.read_metrics_rows(workdir / f"o_{tag}"
                                            / "metrics.csv")[0]
    a, b = rows["cpu"], rows["dev"]
    assert a["bitstream_bytes"] == b["bitstream_bytes"]
    assert a["lossless"] == b["lossless"] == "1"
    assert a["max_abs_err"] == b["max_abs_err"] == "0"


# (name, check, which cube) — chip_smoke.py walks this table at real width
CHECKS = [
    ("ccsds121_byte_equal", check_ccsds121_byte_equal, "A"),
    ("ccsds122_ladder_integer_equal", check_ccsds122_ladder_integer_equal,
     "A"),
    ("j2k_quality_ladder", check_j2k_quality_ladder, "A"),
    ("metric_pass", check_metric_pass, "A"),
    ("j2k_ebcot_pricing", check_j2k_ebcot_pricing, "A"),
    ("jpegls", check_jpegls, "A"),
    ("ccsds123", check_ccsds123, "B"),
]


@pytest.fixture(scope="module")
def dev():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cpu,cuda); "
                    "python chip_smoke.py runs these checks on the card")


@pytest.fixture(scope="module")
def cube16():
    return caseA_cube()


def test_smoke_ccsds121_byte_equal(dev, cube16):
    check_ccsds121_byte_equal(dev, cube16)


def test_smoke_ccsds122_ladder_integer_equal(dev, cube16):
    check_ccsds122_ladder_integer_equal(dev, cube16)


def test_smoke_j2k_quality_ladder(dev, cube16):
    check_j2k_quality_ladder(dev, cube16)


def test_smoke_metric_pass(dev, cube16):
    check_metric_pass(dev, cube16)


def test_smoke_j2k_ebcot_pricing(dev, cube16):
    check_j2k_ebcot_pricing(dev, cube16)


def test_smoke_jpegls_band(dev, cube16):
    check_jpegls(dev, cube16[:1])


def test_smoke_ccsds123_tile(dev):
    check_ccsds123(dev, caseB_cube())


def test_smoke_mesh_metric_ladder(dev, cube16, tmp_path):
    check_mesh_metric_ladder(dev, cube16, tmp_path)
