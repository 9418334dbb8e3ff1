# -*- coding: utf-8 -*-
"""Device CCSDS-121 model: exact size parity with the C++/libaec coder."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpukit.codecs import ccsds121 as dev
from tpukit.native import ccsds121_host as ck


def _gen(rng, n, kind, hi=16):
    if kind == 0:
        return rng.integers(0, 2 ** int(rng.integers(2, hi + 1)), n).astype(np.uint16)
    if kind == 1:
        return (np.cumsum(rng.integers(-5, 6, n)).astype(np.int64) % 65536).astype(np.uint16)
    if kind == 2:
        x = np.zeros(n, np.uint16)
        idx = rng.integers(0, n, max(1, n // 8))
        x[idx] = rng.integers(0, 3000, idx.size).astype(np.uint16)
        return x
    return rng.integers(0, 65536, n).astype(np.uint16)


def test_encode_size_exact(rng):
    for trial in range(40):
        n = int(rng.choice([16, 64, 256, 1024]))
        x = _gen(rng, n, int(rng.integers(0, 4)))
        assert int(dev.encode_size(jnp.asarray(x))) == len(ck.encode(x, 16))


def test_encode_size_variants(rng):
    for J, rsi in ((8, 2), (16, 4), (8, 64)):
        n = 32 * J
        x = _gen(rng, n, 1)
        got = int(dev.encode_size(jnp.asarray(x), J=J, rsi=rsi))
        assert got == len(ck.encode(x, 16, J, rsi))


def test_chunked_matches_monolithic(rng):
    chunk = 512
    for trial in range(10):
        n = chunk * int(rng.integers(1, 5)) + 16 * int(rng.integers(0, chunk // 16))
        x = _gen(rng, n, int(rng.integers(0, 4)))
        got = dev.encode_size_chunked(jnp.asarray(x), chunk=chunk)
        assert got == len(ck.encode(x, 16)), (n, trial)


def test_codec_device_size_matches_run(tile_caseB):
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.ccsds121_codec import CCSDS121Codec
    codec = CCSDS121Codec(tile=32, interleave="bip", preproc="none")
    res = codec.run(tile_caseB, "int16", RateSpec.none())
    sz = int(codec.encode_size_device(jnp.asarray(tile_caseB)))
    assert sz == res.bitstream_bytes


def test_encode_parallel_matches_sequential(rng):
    """Device-planned parallel encode (chunked, k-state from the device plan,
    bit-spliced) must be byte-identical to the sequential coder."""
    from tpukit.codecs.ccsds121 import encode_plan

    for trial in range(12):
        nch = int(rng.integers(2, 6))
        chunk = 16 * int(rng.integers(4, 40))           # multiple of J*rsi
        rem = 16 * int(rng.integers(0, chunk // 16))
        n = nch * chunk + rem
        x = _gen(rng, n, int(rng.integers(0, 4)))
        plan = encode_plan(jnp.asarray(x), chunk=chunk)
        assert plan is not None
        par = ck.encode_parallel(x, plan)
        seq = ck.encode(x, 16)
        assert par == seq, (trial, n, chunk, rem)
        assert len(par) == (plan["total_bits"] + 7) // 8


def test_encode_parallel_unaligned_offsets(rng):
    """Chunks whose bit lengths are not byte-aligned exercise the splice's
    shifted word path."""
    from tpukit.codecs.ccsds121 import encode_plan
    x = _gen(rng, 16 * 64, 1)
    plan = encode_plan(jnp.asarray(x), chunk=16 * 8)
    assert plan is not None
    assert any(o % 8 for o in plan["bit_off"][1:])      # genuinely unaligned
    assert ck.encode_parallel(x, plan) == ck.encode(x, 16)


def test_pack_device_matches_native(rng):
    """Full on-device encode (pack_words): byte-exact vs the C++ coder,
    monolithic and chunked (k-state threaded through pack k_init)."""
    for trial in range(8):
        n = 8 * int(rng.integers(2, 400))
        x = _gen(rng, n, trial % 4)
        assert dev.encode_device(jnp.asarray(x), chunk=1 << 22) == ck.encode(x, 16)
    for trial in range(3):
        chunk = 16 * int(rng.integers(4, 50))
        n = chunk * int(rng.integers(2, 5)) + 16 * int(rng.integers(0, chunk // 16))
        x = _gen(rng, n, trial % 4)
        assert dev.encode_device(jnp.asarray(x), chunk=chunk) == ck.encode(x, 16)


def test_pack_device_all_zero_and_saturating(rng):
    """Zero-run/ROS markers and no-compression blocks through the packer."""
    assert (dev.encode_device(jnp.zeros(8 * 200, jnp.uint16), chunk=1 << 22)
            == ck.encode(np.zeros(8 * 200, np.uint16), 16))
    x = rng.integers(0, 65536, 8 * 64).astype(np.uint16)   # white noise -> NC
    assert dev.encode_device(jnp.asarray(x), chunk=1 << 22) == ck.encode(x, 16)


def test_device_model_sub16_bits(rng):
    """bits<16 must use the true xmax=(1<<bits)-1 in the residual map
    (regression: the model silently assumed 16-bit samples)."""
    for bits in (12, 14, 9):
        x = rng.integers(0, 1 << bits, 8 * 150).astype(np.uint16)
        assert int(dev.encode_size(jnp.asarray(x), bits=bits)) == \
            len(ck.encode(x, bits))
        assert dev.encode_device(jnp.asarray(x), bits=bits, chunk=1 << 22) \
            == ck.encode(x, bits)


def test_chunk_misaligned_to_rsi(rng):
    """encode_plan must round the chunk down to an RSI boundary (or fall
    back) instead of asserting for rsi values that do not divide it."""
    x = _gen(rng, 8 * 3 * 100, 1)
    n = dev.encode_size_chunked(jnp.asarray(x), rsi=3, chunk=8 * 3 * 10 + 8)
    assert n == len(ck.encode(x, 16, 8, 3))


def test_pack_device_wide_blocks(rng):
    """J=16/32 codewords exceed 160 bits (regression: the packer's register
    file was fixed at 5 words and silently dropped the overflow)."""
    for J in (16, 32):
        n = J * 96  # fixed size per J: one compiled shape each
        for trial in range(3):
            x = _gen(rng, n, trial + 1)
            got = dev.encode_device(jnp.asarray(x), J=J, chunk=1 << 22)
            assert got == ck.encode(x, 16, J, 2), (J, trial)


@pytest.mark.parametrize("J", [8, 16])
def test_fs_table_matches_numpy_oracle(J):
    """The split-cost table equals sum(coded >> k) over each block for
    every k, on one BIP row of a Case B tile (512 pixels x 180 bands) of
    full-range 16-bit residuals plus all-zero and all-max blocks."""
    rng = np.random.default_rng(J)
    coded = rng.integers(0, 1 << 16, (512 * 180 // J, J)).astype(np.int32)
    coded[0] = 0
    coded[1] = (1 << 16) - 1
    expect = np.stack([(coded >> k).sum(axis=1, dtype=np.int64)
                       for k in range(dev.KMAX + 1)], axis=1)
    got = np.asarray(dev._fs_table(jnp.asarray(coded)))
    assert got.shape == (coded.shape[0], dev.KMAX + 1)
    np.testing.assert_array_equal(got, expect)


def test_no_preprocess_size_exact(rng):
    """preprocess=False models the native coder with flags=0 (no unit-delay
    map, no reference samples) — the entropy backend CCSDS-123 uses on its
    already-mapped residuals."""
    for trial in range(24):
        n = int(rng.choice([16, 64, 256, 1024, 16 * 64 * 3]))
        x = _gen(rng, n, int(rng.integers(0, 4)))
        got = int(dev.encode_size(jnp.asarray(x), preprocess=False))
        assert got == len(ck.encode(x, 16, 8, 2, flags=0)), (trial, n)
    # CCSDS-123's entropy geometry (J=16, rsi=64) + zero runs across
    # segment boundaries
    x = np.zeros(16 * 64 * 4, np.uint16)
    x[::977] = 3
    got = int(dev.encode_size(jnp.asarray(x), J=16, rsi=64,
                              preprocess=False))
    assert got == len(ck.encode(x, 16, 16, 64, flags=0))


def test_no_preprocess_pack_and_plan(rng):
    """On-device pack with preprocess=False: byte-exact vs flags=0 C++,
    chunked and monolithic; the returned plan decodes via both parallel
    host paths."""
    for trial in range(6):
        chunk = 16 * 64 * int(rng.integers(1, 4))       # J=16, rsi=64
        n = chunk * int(rng.integers(2, 4))
        x = _gen(rng, n, trial % 4)
        bs, plan = dev.encode_device(jnp.asarray(x), J=16, rsi=64,
                                     chunk=chunk, preprocess=False,
                                     return_plan=True)
        ref = ck.encode(x, 16, 16, 64, flags=0)
        assert bs == ref, (trial, n, chunk)
        np.testing.assert_array_equal(ck.decode_parallel(bs, plan), x)
        np.testing.assert_array_equal(
            np.asarray(ck.decode_to_device(bs, plan)), x)
    # single-chunk fallback still returns a usable plan
    x = _gen(rng, 16 * 64, 1)
    bs, plan = dev.encode_device(jnp.asarray(x), J=16, rsi=64,
                                 chunk=1 << 22, preprocess=False,
                                 return_plan=True)
    assert bs == ck.encode(x, 16, 16, 64, flags=0)
    np.testing.assert_array_equal(
        np.asarray(ck.decode_to_device(bs, plan)), x)


def test_no_preprocess_plan_parallel_encode(rng):
    """encode_plan(preprocess=False) + host encode_parallel must equal the
    sequential flags=0 coder (the fetch-overlap path's contract)."""
    for trial in range(6):
        chunk = 16 * int(rng.integers(4, 40))
        n = chunk * int(rng.integers(2, 5)) + 16 * int(rng.integers(0, 8))
        x = _gen(rng, n, int(rng.integers(0, 4)))
        plan = dev.encode_plan(jnp.asarray(x), chunk=chunk,
                               preprocess=False)
        assert plan is not None
        assert ck.encode_parallel(x, plan) == \
            ck.encode(x, 16, 8, 2, flags=0), (trial, n, chunk)


def test_encode_device_chunked_misaligned_tail(rng):
    """n not a multiple of J*rsi no longer forces a monolithic pack: full
    chunks end on reference-sample intervals and the tail chunk carries
    the leftover blocks — still byte-identical to the sequential coder."""
    for trial in range(6):
        step = 8 * 2                         # J=8, rsi=2
        chunk = step * int(rng.integers(3, 9))
        # tail misaligned vs step but whole blocks (J multiples)
        n = chunk * int(rng.integers(2, 4)) + 8 * int(rng.integers(1, 2 * 2))
        x = _gen(rng, n, int(rng.integers(0, 4)))
        bs, plan = dev.encode_device(jnp.asarray(x), chunk=chunk,
                                     return_plan=True)
        assert bs == ck.encode(x, 16, 8, 2), (trial, n, chunk)
        np.testing.assert_array_equal(ck.decode_parallel(bs, plan), x)


def test_encode_device_monolithic_overflow_guard():
    class FakeArr:
        shape = (1 << 28,)
    import pytest as _pytest
    with _pytest.raises(ValueError, match="too large"):
        dev.encode_device(FakeArr(), chunk=0)


def test_codec_device_size_matches_run_diff1_tiled(tile_caseB):
    """encode_size_device must honor diff1 preprocessing AND the
    independent tile grid — the configuration run() actually codes."""
    from tpukit.codecs.base import RateSpec
    from tpukit.codecs.ccsds121_codec import CCSDS121Codec
    for preproc, tile in (("diff1", 32), ("diff1", 16), ("none", 16)):
        codec = CCSDS121Codec(tile=tile, interleave="bip", preproc=preproc)
        res = codec.run(tile_caseB, "int16", RateSpec.none())
        sz = int(codec.encode_size_device(jnp.asarray(tile_caseB)))
        assert sz == res.bitstream_bytes, (preproc, tile)
