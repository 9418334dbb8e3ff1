# -*- coding: utf-8 -*-
"""Golden-vector generator for the CCSDS-122/123 stream formats.

The environment holds no reference `bpe.exe` (CCSDS-122) or CNES
enc123/dec123 (CCSDS-123) binaries to validate against (the reference
repo makes the user supply them, reference README.md:84-90), so these
committed vectors serve two purposes:

  1. they PIN the exact stream bytes tpukit emits — any format change
     fails tests/test_golden_vectors.py loudly and regeneration becomes
     a conscious, reviewed act (rerun this script);
  2. a future environment that DOES hold the real binaries or the Blue
     Book text can validate tpukit's formats in minutes: feed the
     committed .npy inputs to the reference coder and compare, or parse
     the committed streams against the normative field tables.

Run from the repo root:  python tests/vectors/generate.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, os.pardir, os.pardir))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def _pin_cpu() -> None:
    # pin the default device like tests/conftest.py so generation never
    # touches an accelerator (every compute stage here is integer →
    # byte-identical on any backend anyway)
    import jax

    try:
        jax.config.update("jax_default_device", jax.devices("cpu")[0])
    except Exception:
        pass


def _mk_tile122() -> np.ndarray:
    """(1, 64, 64) uint16 smooth-ramp + seeded noise — enough structure
    that every BPE stage (DC gaggles, AC depths, all plane passes) is
    exercised at both committed budgets."""
    rng = np.random.default_rng(122)
    y, x = np.mgrid[0:64, 0:64]
    base = (800 * np.sin(y / 9.0) * np.cos(x / 7.0) + 3000
            + 40.0 * y + 25.0 * x)
    tile = np.clip(base + rng.normal(0, 60, (64, 64)), 0, 16383)
    return tile.astype(np.uint16)[None]


def _mk_cube123() -> np.ndarray:
    """(5, 16, 16) int16 spectrally-correlated cube (band b scales a
    shared scene plus band noise) — exercises the inter-band predictor
    and both local-sum modes."""
    rng = np.random.default_rng(123)
    scene = rng.normal(0, 900, (16, 16))
    bands = [scene * (1.0 + 0.12 * b) + rng.normal(0, 35, (16, 16))
             for b in range(5)]
    return np.clip(np.stack(bands), -8192, 8191).astype(np.int16)


def main() -> None:
    _pin_cpu()
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.ccsds122_codec import CCSDS122Codec
    from tpukit.codecs import ccsds123_std as std

    expected = {}

    # ---- CCSDS-122 (BPE) -------------------------------------------------
    tile = _mk_tile122()
    np.save(os.path.join(HERE, "ccsds122_input_1x64x64_u16.npy"), tile)
    codec = CCSDS122Codec(entropy="bpe")
    for tag, bpp in (("bpp1", 1.0), ("bpp8", 8.0)):
        res = codec.run(tile, "uint16", RateSpec.of("bpp", bpp),
                        keep_bitstream=True)
        assert len(res.bitstreams) == 1
        stream = next(iter(res.bitstreams.values()))
        fn = f"ccsds122_{tag}.bpe"
        with open(os.path.join(HERE, fn), "wb") as f:
            f.write(stream)
        expected[fn] = {
            "codec": "ccsds122", "rate_key": "bpp", "rate": bpp,
            "input": "ccsds122_input_1x64x64_u16.npy",
            "bytes": len(stream),
            "recon_max_abs_err": int(
                np.abs(res.recon.astype(np.int64) -
                       tile.astype(np.int64)).max()),
        }
        print(f"{fn}: {len(stream)} bytes")

    # ---- CCSDS-123 (standard mode) ---------------------------------------
    cube = _mk_cube123()
    np.save(os.path.join(HERE, "ccsds123_input_5x16x16_i16.npy"), cube)
    configs = [
        ("bsq_full", dict(order="bsq")),
        ("bip_full", dict(order="bip")),
        ("bil_full", dict(order="bil")),
        ("bsq_reduced_colsum_p2", dict(order="bsq", full_mode=False,
                                       colsum=True, P=2)),
        ("bsq_block", dict(order="bsq", entropy="block")),
    ]
    for tag, kw in configs:
        stream = std.encode(cube.view(np.uint16), is_signed=True, **kw)
        assert np.array_equal(std.decode(stream).view(np.int16), cube)
        fn = f"ccsds123_{tag}.l123"
        with open(os.path.join(HERE, fn), "wb") as f:
            f.write(stream)
        expected[fn] = {
            "codec": "ccsds123_std",
            "input": "ccsds123_input_5x16x16_i16.npy",
            "bytes": len(stream),
            "header": std.stream_info(stream),
        }
        print(f"{fn}: {len(stream)} bytes")

    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=2, sort_keys=True)
    print("expected.json written")


if __name__ == "__main__":
    main()
