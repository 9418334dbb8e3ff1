# -*- coding: utf-8 -*-
"""CCSDS-121 block-adaptive Rice coder — device modeling path.

The reference runs this codec as an external subprocess per 512² tile
(reference tools/codecs/ccsds121/ccsds121_wrap.py:170-219). Here the whole
encoder *model* — residual mapping, per-block option costs, libaec's
stateful split-k selection, zero-run/ROS segmentation and exact output
length — runs on the device over the full flattened cube in one jitted
program:

  * unit-delay prediction + residual mapping: pure elementwise ops;
  * per-block split costs for all k at once: a (nblocks, K) shifted-sum
    table (the FLOP-heavy part, fully vectorized);
  * libaec's sequential hill-climb k-state (see native/src/ccsds121.cpp
    assess_split) collapses to ``k_b = clip(k_{b-1}, mlo_b, mhi_b)`` over
    the convex cost curve's minimizer interval [mlo, mhi]; compositions of
    clips are clips, so the whole chain is a ``jax.lax.associative_scan``
    — O(log nblocks) depth instead of a 6M-step sequential loop;
  * zero-run heads/lengths/ROS via masked cummax segmentation.

``encode_size`` returns the *exact* byte length the bit-exact C++ encoder
(and libaec, and therefore the reference's `aec` CLI) produces — validated
in tests/test_ccsds121_device.py. ``encode``/``decode`` produce/consume the
actual bitstream via the native packer.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

ID_LEN = 4        # 8 < bits <= 16
KMAX = (1 << ID_LEN) - 3          # 13
SEGMENT_BLOCKS = 64


def _map_residuals(x: jax.Array, ref_period: int, bits: int = 16) -> jax.Array:
    """Unit-delay predictor + standard residual mapping; raw samples at
    reference positions (every ref_period samples)."""
    xi = x.astype(jnp.int32)
    prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), xi[:-1]])
    xmax = jnp.int32((1 << bits) - 1)
    theta = jnp.minimum(prev, xmax - prev)
    delta = xi - prev
    d = jnp.where((delta >= 0) & (delta <= theta), 2 * delta,
                  jnp.where((delta < 0) & (-delta <= theta), -2 * delta - 1,
                            theta + jnp.abs(delta)))
    is_ref = (jnp.arange(x.shape[0], dtype=jnp.int32) % ref_period) == 0
    return jnp.where(is_ref, xi, d)


def _fs_table(coded: jax.Array) -> jax.Array:
    """(nb, J) -> (nb, KMAX+1) split-sample cost table: sum(coded >> k).

    Plain jnp: XLA fuses the KMAX+1 sibling reductions over ``coded``
    into one multi-output fusion, so the residuals are read once."""
    with jax.named_scope("fs_table"):
        return jnp.stack([jnp.sum(coded >> k, axis=1)
                          for k in range(KMAX + 1)], axis=1)


def _clip_compose(left, right):
    """Compose clamp intervals: (right ∘ left)(k) = clip(clip(k,L),R)."""
    lo_l, hi_l = left
    lo_r, hi_r = right
    lo = jnp.clip(lo_l, lo_r, hi_r)
    hi = jnp.clip(hi_l, lo_r, hi_r)
    return lo, hi


@partial(jax.jit, static_argnames=("bits", "J", "rsi", "preprocess"))
def analyze(x: jax.Array, bits: int = 16, J: int = 8, rsi: int = 2,
            preprocess: bool = True):
    """Full encoder model for a flattened sample stream.

    Returns a dict of per-block decisions and the exact total byte size:
      d        : (nb, J) mapped residuals (slot 0 raw on ref blocks)
      k_sel    : (nb,) selected split k (valid where option==k-split)
      option   : (nb,) 0=split,1=SE,2=nocomp,3=zero-head-or-member
      blk_bits : (nb,) emitted bits attributed to each block
      nbytes   : () total bitstream bytes

    ``preprocess=False`` models the coder with the unit-delay preprocessor
    off (libaec without AEC_DATA_PREPROCESS, native flags=0): samples are
    coded as-is and there are no reference samples; zero-run segmentation
    still resets at RSI and 64-block boundaries (the native coder buffers
    in RSI chunks regardless of preprocessing, see
    native/src/ccsds121.cpp encode_core).
    """
    n = x.shape[0]
    assert n % J == 0, "whole blocks required"
    # ID_LEN/KMAX are the 4-bit-ID regime of the standard; other sample
    # sizes need a different ID table — reject rather than model wrongly
    assert 8 < bits <= 16, f"device model supports 8 < bits <= 16, got {bits}"
    nb = n // J
    ref_period = J * rsi

    if preprocess:
        d_flat = _map_residuals(x, ref_period, bits)
    else:
        d_flat = x.astype(jnp.int32)
    d = d_flat.reshape(nb, J)
    bidx = jnp.arange(nb, dtype=jnp.int32)
    is_ref = ((bidx % rsi) == 0) if preprocess \
        else jnp.zeros((nb,), jnp.bool_)
    m = jnp.where(is_ref, J - 1, J).astype(jnp.int32)

    # coded residuals (slot 0 excluded on ref blocks)
    slot0 = jnp.arange(J) == 0
    coded = jnp.where(is_ref[:, None] & slot0[None, :], 0, d)

    # ---- split-k cost table -------------------------------------------------
    # One (nb,) reduction per k keeps peak memory at O(nb*J), not O(nb*J*K).
    ks = jnp.arange(KMAX + 1, dtype=jnp.int32)
    fs_len = _fs_table(coded)  # (nb, K)
    split_len = fs_len + m[:, None] * (ks[None, :] + 1)

    # minimizer interval [mlo, mhi] of the convex split_len row
    best = jnp.min(split_len, axis=1, keepdims=True)
    is_min = split_len == best
    mlo = jnp.argmax(is_min, axis=1).astype(jnp.int32)
    mhi = (KMAX - jnp.argmax(is_min[:, ::-1], axis=1)).astype(jnp.int32)
    split_min = best[:, 0]

    # ---- second extension ---------------------------------------------------
    # int32-safe: SE can only win when the block is cheap (< nc_len bits),
    # so γ values are capped and any capped block is marked non-viable.
    GCAP = 1 << 20
    se_src = jnp.where(is_ref[:, None] & slot0[None, :], 0, d)
    a = se_src[:, 0::2]
    b = se_src[:, 1::2]
    # SE only ever wins below nc_len (≤ 16·J bits), so γ beyond GCAP is
    # irrelevant; capping the pair sum keeps γ far inside int32.
    ssum = jnp.minimum(a + b, 2048)
    gam = ssum * (ssum + 1) // 2 + jnp.minimum(b, 65535)
    gam_c = jnp.minimum(gam, GCAP)
    se_len = 1 + jnp.sum(gam_c + 1, axis=1)
    se_len = jnp.where(jnp.any(gam_c >= GCAP, axis=1), jnp.int32(1) << 28, se_len)

    nc_len = (m * bits).astype(jnp.int32)

    # ---- zero blocks --------------------------------------------------------
    allzero = jnp.all(coded == 0, axis=1)

    # k-state chain: zero blocks are identity (0, KMAX)
    lo_e = jnp.where(allzero, 0, mlo)
    hi_e = jnp.where(allzero, KMAX, mhi)
    lo_s, hi_s = jax.lax.associative_scan(_clip_compose, (lo_e, hi_e))
    k_sel = lo_s  # apply composed clamp to k_init = 0

    # per-block split length at the selected k: k_sel lies inside the argmin
    # interval [mlo, mhi], so the selected length IS the row minimum (no
    # gather needed)
    split_sel = split_min

    # option choice (mirrors native emit_block: SE wins ties vs split)
    use_se = (se_len <= split_sel) & (se_len < nc_len)
    use_nc = (~use_se) & (split_sel >= nc_len)
    option = jnp.where(allzero, 3, jnp.where(use_se, 1, jnp.where(use_nc, 2, 0)))

    payload = jnp.where(use_se, se_len,
                        jnp.where(use_nc, nc_len, split_sel))
    nonzero_bits = ID_LEN + jnp.where(is_ref, bits, 0) + payload

    # ---- zero-run segmentation ---------------------------------------------
    cb = bidx % rsi                       # position within RSI chunk
    seg_break_before = (cb == 0) | (cb % SEGMENT_BLOCKS == 0)
    prev_zero = jnp.concatenate([jnp.array([False]), allzero[:-1]])
    run_start = allzero & (seg_break_before | ~prev_zero | is_ref)
    # head index for every block (cummax of start positions)
    head_pos = jnp.where(run_start, bidx, -1)
    head_idx = jax.lax.cummax(head_pos)
    # run end: next block breaks the run
    nxt_break = jnp.concatenate([
        (((cb[:-1] + 1) == rsi) | (((cb[:-1] + 1) % SEGMENT_BLOCKS) == 0)
         | ~allzero[1:] | is_ref[1:]),
        jnp.array([True])])
    run_end = allzero & nxt_break
    z = (bidx - head_idx + 1).astype(jnp.int32)
    # seg-end flush: run ends at a segment/chunk/data boundary
    at_seg_end = jnp.concatenate([
        (((cb[:-1] + 1) == rsi) | (((cb[:-1] + 1) % SEGMENT_BLOCKS) == 0)),
        jnp.array([True])])
    ros = run_end & at_seg_end & (z > 4)
    fs_bits = jnp.where(ros, 5, jnp.where(z <= 4, z, z + 1))
    head_is_ref = is_ref[jnp.clip(head_idx, 0, nb - 1)]
    marker_bits = (ID_LEN + 1 + jnp.where(head_is_ref, bits, 0) + fs_bits)
    zero_bits = jnp.where(run_end, marker_bits, 0)

    # int32 totals: callers chunk streams below 2^31 bits (256 MB output);
    # Case B tiles are ~7.5e8 bits, well inside.
    blk_bits = jnp.where(allzero, zero_bits, nonzero_bits).astype(jnp.int32)
    total_bits = jnp.sum(blk_bits)
    nbytes = (total_bits + 7) // 8

    return {
        "d": d,
        "coded": coded,
        "k_sel": k_sel,
        "lo_s": lo_s,
        "hi_s": hi_s,
        "is_ref": is_ref,
        "allzero": allzero,
        "option": option,
        "gam_c": gam_c,
        "blk_bits": blk_bits,
        "nbytes": nbytes,
        "total_bits": total_bits,
        # outgoing split-k interval: k_out = clip(k_in, k_lo_out, k_hi_out)
        "k_lo_out": lo_s[-1],
        "k_hi_out": hi_s[-1],
        "run_end": run_end,
        "head_idx": head_idx,
        "z": z,
        "ros": ros,
    }


@partial(jax.jit, static_argnames=("bits", "J", "rsi", "preprocess"))
def encode_size(x: jax.Array, bits: int = 16, J: int = 8, rsi: int = 2,
                preprocess: bool = True) -> jax.Array:
    """Exact compressed byte size (== native/libaec encoder output length).

    A partial final block is padded by repeating the last sample — the
    libaec convention the host coder also follows — so arbitrary sample
    counts stay exact."""
    pad = (-x.shape[0]) % J
    if pad:
        x = jnp.concatenate([x, jnp.broadcast_to(x[-1:], (pad,))])
    return analyze(x, bits=bits, J=J, rsi=rsi,
                   preprocess=preprocess)["nbytes"]


# ---------------------------------------------------------------------------
# Device bit-packer: the full encoder ON DEVICE (SURVEY §7.3's design —
# vectorized per-block codeword registers, prefix-sum bit offsets, and a
# disjoint-bit scatter-add into the output word buffer).
# ---------------------------------------------------------------------------

def _reg_words(bits: int, J: int) -> int:
    """Register words per block: the worst codeword is ID_LEN + 1 (SE
    selector) + J*bits (no-compression payload, reference sample included)."""
    return (ID_LEN + 1 + J * bits + 31) // 32


def _reg_insert(W, pos, value, width, mask):
    """OR `width`-bit `value` (MSB-first) at local bit `pos` into the
    (nb, reg_words) register file. Vector over blocks; pos/width may vary
    per block. Out-of-range positions drop silently (callers gate by mask,
    which zeroes the value)."""
    value = jnp.where(mask, value.astype(jnp.uint32), jnp.uint32(0))
    pos = pos.astype(jnp.int32)
    width = jnp.asarray(width, jnp.int32) + jnp.zeros_like(pos)
    l = pos >> 5
    s = pos & 31
    left_space = 32 - s
    rsh = width - left_space            # > 0: the value spans two words
    # shift counts MUST be uint32: a signed count would promote the uint32
    # value to signed and turn >> into an arithmetic shift
    sh_span = jnp.clip(rsh, 0, 31).astype(jnp.uint32)
    sh_fit = jnp.clip(left_space - width, 0, 31).astype(jnp.uint32)
    sh_lo = jnp.clip(32 - rsh, 0, 31).astype(jnp.uint32)
    hi = jnp.where(rsh > 0, value >> sh_span, value << sh_fit)
    lo = jnp.where(rsh > 0, value << sh_lo, jnp.uint32(0))
    lanes = jnp.arange(W.shape[1], dtype=jnp.int32)
    W = W | jnp.where(l[:, None] == lanes[None], hi[:, None], jnp.uint32(0))
    W = W | jnp.where((l + 1)[:, None] == lanes[None], lo[:, None],
                      jnp.uint32(0))
    return W


def _excl_cumsum(x, axis):
    c = jnp.cumsum(x, axis=axis)
    return c - x


@partial(jax.jit, static_argnames=("bits", "J", "rsi", "out_words", "preprocess"))
def pack_words(x: jax.Array, k_init: jax.Array, bits: int = 16, J: int = 8,
               rsi: int = 2, out_words: int = 0, preprocess: bool = True):
    """Full CCSDS-121 encode on device.

    Returns (words[out_words] uint32, total_bits, k_lo_out, k_hi_out): the
    packed stream plus the chunk's outgoing split-k interval so callers can
    chain chunks as device scalars without a host sync.

    Bit-exact with the C++/libaec coder (fuzz-tested): every block's
    codeword is built in a fixed-width register file sized for the worst
    codeword of (bits, J) (vectorized over all blocks), block bit offsets
    come from a prefix sum of the modeled lengths, and the registers
    scatter-add into the output — contributions never share set bits, so
    add == or. The bitstream is the big-endian byte view of `words`.
    ``k_init`` is the split-k search state entering the chunk (0 for a
    whole stream).
    """
    a = analyze(x, bits=bits, J=J, rsi=rsi, preprocess=preprocess)
    n = x.shape[0]
    nb = n // J
    d = a["d"]
    coded = a["coded"]
    is_ref = a["is_ref"]
    option = a["option"]
    run_end = a["run_end"]
    k_sel = jnp.clip(k_init.astype(jnp.int32), a["lo_s"], a["hi_s"])

    blk_off = _excl_cumsum(a["blk_bits"], 0)
    W = jnp.zeros((nb, _reg_words(bits, J)), jnp.uint32)
    slot0 = jnp.arange(J) == 0
    coded_mask = ~(is_ref[:, None] & slot0[None, :])
    zeros = jnp.zeros((nb,), jnp.int32)

    is_split = option == 0
    is_se = option == 1
    is_nc = option == 2

    # --- ID fields -----------------------------------------------------------
    W = _reg_insert(W, zeros, k_sel + 1, ID_LEN, is_split)
    W = _reg_insert(W, zeros, jnp.ones((nb,), jnp.int32), ID_LEN + 1, is_se)
    W = _reg_insert(W, zeros, jnp.full((nb,), (1 << ID_LEN) - 1, jnp.int32),
                    ID_LEN, is_nc)
    # zero-run marker ID+selector are all-zero bits: nothing to set

    # --- reference samples ---------------------------------------------------
    ref_pos = jnp.where(is_se, ID_LEN + 1, ID_LEN) + zeros
    W = _reg_insert(W, ref_pos, d[:, 0], bits, is_ref & (is_split | is_se))

    # --- no-compression body: J raw (preprocessed) samples -------------------
    for i in range(J):
        W = _reg_insert(W, zeros + ID_LEN + bits * i, d[:, i], bits, is_nc)

    # --- split option: fs codes then k-bit LSBs -------------------------------
    base = ID_LEN + jnp.where(is_ref, bits, 0)
    q = coded >> k_sel[:, None]
    fs_len = jnp.where(coded_mask, q + 1, 0)
    cumex = _excl_cumsum(fs_len, 1)
    one_pos = base[:, None] + cumex + q          # position of each fs '1'
    ones = jnp.ones((nb,), jnp.int32)
    for i in range(J):
        W = _reg_insert(W, one_pos[:, i], ones, 1,
                        is_split & coded_mask[:, i])
    fs_total = cumex[:, -1] + fs_len[:, -1]
    base2 = base + fs_total
    rank = jnp.cumsum(coded_mask, axis=1) - 1
    kmask = (jnp.uint32(1) << jnp.clip(k_sel, 0, 31).astype(jnp.uint32)) - 1
    for i in range(J):
        W = _reg_insert(W, base2 + rank[:, i] * k_sel,
                        coded[:, i].astype(jnp.uint32) & kmask, k_sel,
                        is_split & coded_mask[:, i] & (k_sel > 0))

    # --- second extension: gamma fs codes -------------------------------------
    gam = a["gam_c"]
    gbase = ID_LEN + 1 + jnp.where(is_ref, bits, 0)
    gcum = _excl_cumsum(gam + 1, 1)
    for p in range(J // 2):
        W = _reg_insert(W, gbase + gcum[:, p] + gam[:, p], ones, 1, is_se)

    # --- zero-run markers (attributed to the run-end block) ------------------
    head = jnp.clip(a["head_idx"], 0, nb - 1)
    head_is_ref = jnp.take(is_ref, head)
    zref = jnp.take(d[:, 0], head)
    W = _reg_insert(W, zeros + ID_LEN + 1, zref, bits,
                    run_end & head_is_ref)
    z = a["z"]
    v = jnp.where(a["ros"], 4, jnp.where(z <= 4, z - 1, z))
    W = _reg_insert(W, ID_LEN + 1 + jnp.where(head_is_ref, bits, 0) + v,
                    ones, 1, run_end)

    # --- scatter the registers into the global word buffer -------------------
    out = jnp.zeros((out_words,), jnp.uint32)
    for l in range(_reg_words(bits, J)):
        gb = blk_off + 32 * l
        g = gb >> 5
        s = gb & 31
        wl = W[:, l]
        hi = wl >> s.astype(jnp.uint32)
        lo = jnp.where(s > 0, wl << jnp.clip(32 - s, 0, 31).astype(jnp.uint32),
                       jnp.uint32(0))
        out = out.at[g].add(hi, mode="drop")
        out = out.at[g + 1].add(lo, mode="drop")
    return out, a["total_bits"], a["k_lo_out"], a["k_hi_out"]


def pack_cap_words(n: int, bits: int = 16, J: int = 8) -> int:
    """Static output-word capacity for pack_words. Exact worst case per
    block is ID_LEN + 1 (SE selector) + J*bits (reference samples are
    included in the J*bits of the no-compression payload), so this bound
    can never be exceeded — overflowing scatter writes would be silently
    dropped (mode=\"drop\")."""
    nb = (n + J - 1) // J
    cap_bits = nb * (ID_LEN + 1) + n * bits + 64
    return cap_bits // 32 + 2


def encode_device(x, bits: int = 16, J: int = 8, rsi: int = 2,
                  chunk: int = 1 << 23, preprocess: bool = True,
                  return_plan: bool = False):
    """Produce the actual CCSDS-121 bitstream entirely on device.

    Chunks end on reference-sample intervals, and the split-k chain threads
    between chunks as DEVICE scalars (k_next = clip(k, lo_out, hi_out)), so
    every chunk's pack dispatches asynchronously and analyze() runs exactly
    once per chunk; the packed word buffers and bit lengths come down in one
    device_get and are bit-spliced on host (the only host work).
    Byte-identical to encode()/libaec.

    With ``return_plan=True`` returns ``(bytes, plan)`` where plan carries
    the chunk sample counts and exact bit offsets — enough for
    ccsds121_host.decode_parallel to decode every chunk independently."""
    from tpukit.native.ccsds121_host import splice_segments

    n = int(x.shape[0])
    step = J * rsi
    assert n % J == 0, "whole blocks required"
    chunk -= chunk % step
    if chunk <= 0 or n <= chunk:
        # monolithic pack: analyze()'s bit accounting is int32, so refuse
        # streams whose worst-case output could cross 2^31 bits instead
        # of silently corrupting offsets (chunked callers never get here)
        if pack_cap_words(n, bits, J) * 32 >= (1 << 31):
            raise ValueError(
                f"stream of {n} samples too large for a monolithic pack; "
                f"pass a positive chunk size")
        words, total_bits, _, _ = pack_words(
            x, jnp.int32(0), bits=bits, J=J, rsi=rsi,
            out_words=pack_cap_words(n, bits, J), preprocess=preprocess)
        words, total_bits = jax.device_get((words, total_bits))
        nbytes = (int(total_bits) + 7) // 8
        bs = words.astype(">u4").tobytes()[:nbytes]
        if return_plan:
            plan = {"n": n, "sizes": [n], "bit_off": [0],
                    "seg_bits": [int(total_bits)],
                    "total_bits": int(total_bits), "bits": bits, "J": J,
                    "rsi": rsi, "preprocess": preprocess}
            return bs, plan
        return bs

    sizes = [chunk] * (n // chunk)
    if n % chunk:
        sizes.append(n % chunk)
    parts = []
    start = 0
    k = jnp.int32(0)
    for sz in sizes:
        words, tb, lo, hi = pack_words(x[start:start + sz], k, bits=bits,
                                       J=J, rsi=rsi,
                                       out_words=pack_cap_words(sz, bits, J),
                                       preprocess=preprocess)
        parts.append((words, tb))
        k = jnp.clip(k, lo, hi)
        start += sz
    # two-phase fetch: the bit lengths first (scalars, one tiny transfer),
    # then the word buffers TRIMMED on device to the used prefix (+2 words
    # of zero slack for the splicer) — roughly halves the download vs the
    # padded capacity buffers
    seg_bits = [int(t) for t in jax.device_get([tb for _, tb in parts])]
    host_words = jax.device_get(
        [w[:(t + 31) // 32 + 2] for (w, _), t in zip(parts, seg_bits)])
    off = 0
    bit_off = []
    for tb in seg_bits:
        bit_off.append(off)
        off += tb
    plan = {"n": n, "sizes": sizes, "bit_off": bit_off,
            "seg_bits": seg_bits, "total_bits": off, "bits": bits, "J": J,
            "rsi": rsi, "preprocess": preprocess}
    bs = splice_segments(
        [(words.astype(">u4").view(np.uint8), tb) for words, tb
         in zip(host_words, seg_bits)], plan)
    return (bs, plan) if return_plan else bs


# ---------------------------------------------------------------------------
# Chunked model: fixed-shape chunks => one small compiled program reused,
# with the k-state chain folded across chunks on host.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("bits", "J", "rsi", "preprocess"))
def chunk_stats(x: jax.Array, bits: int = 16, J: int = 8, rsi: int = 2,
                preprocess: bool = True):
    """Per-chunk model: (total_bits, k_lo_out, k_hi_out).

    The chunk's bit length is INVARIANT to the incoming split-k state:
    every block's k is ``clip(k_in-composed, mlo_b, mhi_b)`` and the final
    clip lands inside the block's argmin interval [mlo_b, mhi_b], where by
    construction every k attains the row-minimum split cost — so the cost
    of every block (and the SE/no-compression option choice, which compares
    against that minimum) does not depend on k_in. Only the *bit pattern*
    (the emitted ID and fs codes) depends on k, which is why the parallel
    encoder still threads the k chain: k_out = clip(k_in, k_lo_out,
    k_hi_out). Mirrors libaec's assess_splitting_option, where the carried
    k breaks ties but never changes the selected length.
    """
    a = analyze(x, bits=bits, J=J, rsi=rsi, preprocess=preprocess)
    return a["total_bits"], a["k_lo_out"], a["k_hi_out"]


@partial(jax.jit, static_argnames=("size", "bits", "J", "rsi",
                                   "preprocess"))
def _chunk_stats_slice(x, start, size: int, bits: int = 16, J: int = 8,
                       rsi: int = 2, preprocess: bool = True):
    """chunk_stats of ``x[start:start+size]`` with the slice INSIDE the
    program: an eager ``x[sl]`` on a device array compiles a separate
    dynamic_slice program per chunk shape. ``start`` is traced, so
    one program per (stream shape, chunk size) covers every chunk."""
    xs = jax.lax.dynamic_slice(x, (start,), (size,))
    a = analyze(xs, bits=bits, J=J, rsi=rsi, preprocess=preprocess)
    return a["total_bits"], a["k_lo_out"], a["k_hi_out"]


@jax.jit
def _stack_tables(ts, los, his):
    """Batch the per-chunk scalars into three arrays for ONE device_get —
    as a single compiled program (the eager jnp.stack pair compiles
    broadcast_in_dim + concatenate)."""
    return jnp.stack(ts), jnp.stack(los), jnp.stack(his)


def encode_plan(x, bits: int = 16, J: int = 8, rsi: int = 2,
                chunk: int = 1 << 22, preprocess: bool = True,
                devices=None):
    """Device-computed parallel-encode plan.

    Splits the stream into chunks aligned to reference-sample intervals
    (chunks are then independent except for the carried split-k search
    state), computes every chunk's k-state table on device — all programs
    dispatch asynchronously, the tiny (nch, K) tables come back in ONE
    device_get (the link's device->host latency dominates, so one batched
    transfer instead of one per chunk) — and folds the exact k-state chain
    on host in Python ints (no 32-bit overflow for huge streams).

    Returns a dict with per-chunk ``sizes`` (samples), ``k_in`` (split-k
    state entering each chunk), ``bit_off`` (exact bit offset of each
    chunk's codewords in the stream), ``seg_bits`` (exact bit length of
    each chunk), and ``total_bits``. A thread pool can then entropy-code
    every chunk independently and splice the results at the planned
    offsets — the device plans, the host packs (see
    tpukit.native.ccsds121_host.encode_parallel). Returns None when the
    stream is too small or misaligned to chunk (callers fall back to the
    monolithic path).

    ``devices``: optional list of jax devices to round-robin the chunk
    programs over (codec-phase mesh sharding). Chunk analyses are
    independent (the k chain folds on host), and the model is pure
    integer arithmetic, so per-device placement is bit-exact regardless
    of layout — the plan equals the single-device plan. ``x`` should be
    a HOST (numpy) array in this mode so chunks commit straight onto
    their mesh device, never to the default device first."""
    n = int(x.shape[0])
    step = J * rsi
    chunk -= chunk % step       # chunks must end on an RSI boundary
    # misaligned streams (incl. partial final blocks) take the monolithic
    # path, which pads like the coder does
    if chunk <= 0 or n <= chunk or n % step != 0 or n % J != 0:
        return None
    main = (n // chunk) * chunk
    rem = n - main
    # fixed-shape per-chunk dispatches reuse ONE cached program regardless
    # of chunk count (a vmapped variant would recompile per count);
    # dispatch is async, so the serial launches overlap, and the tables
    # come down in one device_get below
    def _piece(i, sl, sz):
        if devices is not None:
            xs = jax.device_put(x[sl], devices[i % len(devices)])
            return chunk_stats(xs, bits=bits, J=J, rsi=rsi,
                               preprocess=preprocess)
        if isinstance(x, np.ndarray):
            # host stream: the slice is a free view; the jit uploads it
            return chunk_stats(x[sl], bits=bits, J=J, rsi=rsi,
                               preprocess=preprocess)
        # device-resident stream: slice INSIDE the program (one compiled
        # program per chunk size instead of dynamic_slice + chunk_stats)
        return _chunk_stats_slice(x, sl.start or 0, sz, bits=bits, J=J,
                                  rsi=rsi, preprocess=preprocess)

    results = [_piece(i, slice(i * chunk, (i + 1) * chunk), chunk)
               for i in range(n // chunk)]
    sizes = [chunk] * (n // chunk)
    if rem:
        results.append(_piece(n // chunk, slice(main, main + rem), rem))
        sizes.append(rem)
    if devices is None:
        totals, los, his = jax.device_get(
            _stack_tables(tuple(t for t, _, _ in results),
                          tuple(lo for _, lo, _ in results),
                          tuple(hi for _, _, hi in results)))
    else:
        # results live on different devices — stacking would force a
        # cross-device colocation; fetch the 3 scalars per chunk directly
        # (mesh devices are local, per-call latency is not a concern)
        got = jax.device_get(results)
        totals = [t for t, _, _ in got]
        los = [lo for _, lo, _ in got]
        his = [hi for _, _, hi in got]
    k = 0
    off = 0
    k_in, bit_off, seg_bits = [], [], []
    for t, lo, hi in zip(totals, los, his):
        k_in.append(k)
        bit_off.append(off)
        seg_bits.append(int(t))
        off += int(t)
        k = int(min(max(k, lo), hi))
    return {"n": n, "sizes": sizes, "k_in": k_in, "bit_off": bit_off,
            "seg_bits": seg_bits, "total_bits": off,
            "bits": bits, "J": J, "rsi": rsi, "preprocess": preprocess}


def encode_size_chunked(x, bits: int = 16, J: int = 8, rsi: int = 2,
                        chunk: int = 1 << 22, preprocess: bool = True) -> int:
    """Exact encoded byte size using fixed-shape chunks (see encode_plan)."""
    plan = encode_plan(x, bits=bits, J=J, rsi=rsi, chunk=chunk,
                       preprocess=preprocess)
    if plan is None:
        return int(encode_size(x, bits=bits, J=J, rsi=rsi,
                               preprocess=preprocess))
    return (plan["total_bits"] + 7) // 8


# ---------------------------------------------------------------------------
# Full codec API (bitstream via native packer; model on device)
# ---------------------------------------------------------------------------

def encode(samples: np.ndarray, bits: int = 16, J: int = 8, rsi: int = 2) -> bytes:
    """Produce the actual CCSDS-121 bitstream (bit-exact with libaec)."""
    from tpukit.native import ccsds121_host
    return ccsds121_host.encode(np.asarray(samples).ravel(), bits, J, rsi)


def decode(bitstream: bytes, n_samples: int, bits: int = 16, J: int = 8,
           rsi: int = 2) -> np.ndarray:
    from tpukit.native import ccsds121_host
    return ccsds121_host.decode(bitstream, n_samples, bits, J, rsi)
