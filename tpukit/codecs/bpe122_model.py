# -*- coding: utf-8 -*-
"""Exact on-device model of the CCSDS 122.0-B BPE coder
(native/src/bpe122.cpp): stream byte counts and truncated-decode
reconstructions as pure jnp functions of the (S, 64) weighted block
coefficients.

Like codecs/bitplane_model.py for the embedded coder, every bit the BPE
emits sits at a position that is a closed-form function of the
coefficients' MSB indices and the per-gaggle code-option selections —
both deterministic. So a rate ladder can price and reconstruct every
SegByteLimit point on device: DWT -> gather -> model -> inverse DWT with
no coefficient-plane transfers; the host coder materializes real
segments only when ``keep_bitstream`` asks. Byte-level agreement model
== native coder is fuzz-pinned in tests/test_bpe122_model.py.

Scope: single-segment streams (the codec's default — one segment per
band; S <= 2^20). The atomicity rules mirrored here are documented in
bpe122.cpp: DC/depth gaggles atomic, the depth section all-or-nothing,
stage-1..3 units (word + signs) atomic, per-bit elsewhere.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

GAGGLE = 16
HDR_BYTES = 20                    # Part 1A + 1B + 2 + 3 + 4 (single seg)
HDR_BITS = 8 * HDR_BYTES
# module constants stay NUMPY: creating device arrays at import time
# dispatches tiny convert programs to the DEFAULT backend, and this module
# is imported by the codec registry even for sweeps that never touch
# CCSDS-122. Inside jit the numpy constants
# embed at trace time for free (jnp.asarray at the indexed use sites).
_INF = np.int32(1 << 30)

# ---------------------------------------------------------------------------
# VLC tables — mirror native/src/bpe122.cpp exactly
# ---------------------------------------------------------------------------

_OPT_LENS = {
    2: [[1, 2, 3, 3]],
    3: [[1, 2, 3, 4, 5, 6, 7, 7],
        [2, 2, 3, 3, 4, 4, 5, 5]],
    4: [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 15],
        [2, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7],
        [3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5]],
}
_ID_BITS = {2: 1, 3: 2, 4: 2}


def _sym_tables():
    """(5,16) word-value -> symbol maps, full and restricted (popcount
    asc, value asc; restricted drops the all-zero word)."""
    full = np.zeros((5, 16), np.int32)
    restr = np.zeros((5, 16), np.int32)
    for L in (2, 3, 4):
        n = 1 << L
        order = sorted(range(n), key=lambda v: (bin(v).count("1"), v))
        for s, v in enumerate(order):
            full[L, v] = s
            if s >= 1:
                restr[L, v] = s - 1
    return full, restr


def _len_tables():
    """(5, 3, 16) code length per (class, option, symbol); absent options
    are +inf so they never win the min."""
    t = np.full((5, 3, 16), 1 << 20, np.int64)
    for L, opts in _OPT_LENS.items():
        for o, lens in enumerate(opts):
            t[L, o, :len(lens)] = lens
    return t.astype(np.int32)


_SYM_FULL, _SYM_RESTR = _sym_tables()
_LEN_TAB = _len_tables()
_NOPT = np.asarray([0, 0, 1, 2, 3], np.int32)         # coded options / class
_IDB = np.asarray([0, 0, 1, 2, 2], np.int32)          # ID field bits / class


def _msb(mag):
    return 31 - jax.lax.clz(mag.astype(jnp.uint32)).astype(jnp.int32)


def _bits_twoscomp(v):
    vi = v.astype(jnp.int32)
    mag_pos = jnp.where(vi > 0, _msb(vi.astype(jnp.uint32)) + 1, 0)
    m = jnp.uint32(0) - vi.astype(jnp.uint32)          # |v| for v<0 (mod 2^32)
    mag_neg = _msb(m) + 1
    pow2 = (m & (m - 1)) == 0
    return jnp.where(vi >= 0, mag_pos + 1,
                     jnp.where(pow2, mag_neg, mag_neg + 1))


def _select_q(bd_dc, bd_ac):
    half = 1 + (bd_ac + 1) // 2
    qp = jnp.where(bd_dc <= 3, 0,
                   jnp.where(bd_dc - half <= 1, bd_dc - 3,
                             jnp.where(bd_dc - half > 10, bd_dc - 10,
                                       half)))
    return jnp.maximum(qp, 3)


def _option_field_bits(N):
    return jnp.where(N <= 2, 1, jnp.where(N <= 4, 2,
                                          jnp.where(N <= 8, 3, 4)))


def _dpcm_section(vals, real, N, is_signed, range_top, S):
    """Bit accounting of one DPCM/Rice gaggle section (encode_dpcm).

    vals: (Sp,) int32 (padded), real: (Sp,) bool. Returns
    (section_bits, per-block unit-end offsets (Sp,), both assuming the
    section starts at bit 0). For N == 1 the section is per-bit: block
    m's value ends at bit m+1.
    """
    Sp = vals.shape[0]
    G = Sp // GAGGLE
    vmin = jnp.where(is_signed, -(jnp.int32(1) << (N - 1)), 0)
    vmax = jnp.where(is_signed, (jnp.int32(1) << (N - 1)) - 1, range_top)
    prev = jnp.concatenate([vals[:1], vals[:-1]])
    theta = jnp.minimum(prev - vmin, vmax - prev)
    d = vals - prev
    mapped = jnp.where((d >= 0) & (d <= theta), 2 * d,
                       jnp.where((d < 0) & (d >= -theta), -2 * d - 1,
                                 theta + jnp.abs(d))).astype(jnp.int32)
    idx = jnp.arange(Sp, dtype=jnp.int32)
    is_mapped = real & (idx >= 1)                      # index 0 is the ref
    mapped = jnp.where(is_mapped, mapped, 0)

    F = _option_field_bits(N)
    kmax = jnp.minimum(N - 2, (jnp.int32(1) << F) - 2)
    mg = mapped.reshape(G, GAGGLE)
    rg = is_mapped.reshape(G, GAGGLE)
    cnt = rg.sum(axis=1).astype(jnp.int32)
    best = cnt * N                                     # uncoded
    for k in range(9):                                 # kmax <= 8 always
        ck = jnp.where(rg, (mg >> k) + 1 + k, 0).sum(axis=1)
        ck = jnp.where(k <= kmax, ck, _INF)
        best = jnp.minimum(best, ck.astype(jnp.int32))
    # every gaggle in [0, ceil(S/16)) exists in the stream (the encoder
    # iterates g0 < n): F-bit option field + codes; gaggle 0 adds the
    # N-bit reference sample
    gbits = (F + best).astype(jnp.int32)
    gbits = gbits.at[0].add(N)
    gend = jnp.cumsum(gbits)
    section = gend[-1]
    per_block_end = gend[idx // GAGGLE]
    # N == 1: S uncoded bits, per-bit granularity
    per_block_end = jnp.where(N == 1, idx + 1, per_block_end)
    section = jnp.where(N == 1, S, section)
    return section.astype(jnp.int32), per_block_end.astype(jnp.int32)


def _pack_bits(flags):
    """(..., L) significance bits (MSB first) -> packed integer value,
    skipping entries where flags is -1 (not in the word)."""
    # flags: int32 with -1 = absent, 0/1 = bit
    val = jnp.zeros(flags.shape[:-1], jnp.int32)
    for i in range(flags.shape[-1]):
        f = flags[..., i]
        val = jnp.where(f >= 0, val * 2 + f, val)
    return val


def bpe_stream_layout(blocks: jax.Array):
    """Budget-independent layout for one band's (S, 64) weighted int32
    blocks: everything bpe_decode_at needs (per-coefficient acquisition
    ends, refinement positions, DC offsets, the full byte count)."""
    S = blocks.shape[0]
    Sp = ((S + GAGGLE - 1) // GAGGLE) * GAGGLE
    pad = Sp - S
    blk = jnp.pad(blocks, ((0, pad), (0, 0))) if pad else blocks
    real = jnp.arange(Sp) < S

    dc = blk[:, 0]
    ac = blk[:, 1:]                                   # (Sp, 63)
    mag = jnp.abs(ac).astype(jnp.uint32)
    msb = jnp.where(mag > 0, _msb(mag), -1)           # (Sp, 63)

    fam = msb.reshape(Sp, 3, 21)
    msbP = fam[:, :, 0]                               # (Sp, 3)
    msbC = fam[:, :, 1:5].max(axis=2)
    msbH = fam[:, :, 5:].reshape(Sp, 3, 4, 4).max(axis=3)  # (Sp, 3, 4)
    msbG = msbH.max(axis=2)
    msbD = jnp.maximum(msbC, msbG)
    msbB = msbD.max(axis=1)                           # (Sp,)
    dmax = jnp.where(real, msb.max(axis=1) + 1, 0)    # (Sp,)

    bd_dc = jnp.maximum(jnp.where(real, _bits_twoscomp(dc), 1).max(), 1)
    bd_ac = dmax.max()
    q = _select_q(bd_dc, bd_ac)
    N = jnp.maximum(bd_dc - q, 1)
    qdc = jnp.where(real, dc >> q, 0)

    # ---- DC section ----
    dc_bits, dc_end = _dpcm_section(qdc, real, N, True, 0, S)
    # ---- additional DC planes ----
    n_add = jnp.maximum(q - jnp.maximum(bd_ac, 0), 0)
    add_bits = n_add * S
    add_start = dc_bits
    # ---- depth section ----
    Nd = jnp.where(bd_ac > 0, _msb(bd_ac.astype(jnp.uint32)) + 1, 1)
    depths = jnp.where(real, dmax, 0)
    dpt_bits, _ = _dpcm_section(depths, real, Nd, False, bd_ac, S)
    dpt_bits = jnp.where(bd_ac > 0, dpt_bits, 0)
    dpt_start = add_start + add_bits
    dpt_end = dpt_start + dpt_bits

    # ---- per-plane slot grid ----
    # slots per block: 0 parent word (stage 1); 1 tranB, 2 tranD,
    # 3..5 typesC (stage 2); 6 tranG, then per family f: 7+5f tranH,
    # 8+5f+j typesH (stage 3). 22 slots total.
    NSLOT = 22
    G = Sp // GAGGLE
    gidx = jnp.arange(Sp, dtype=jnp.int32) // GAGGLE
    # emission-order key per slot: stage-major, then block, then slot
    slot_stage = np.ones(NSLOT, np.int32)
    slot_stage[1:6] = 2
    slot_stage[6:] = 3
    slot_stage = jnp.asarray(slot_stage)
    ordkey = (slot_stage[None, :] * (Sp * NSLOT) +
              jnp.arange(Sp, dtype=jnp.int32)[:, None] * NSLOT +
              jnp.arange(NSLOT, dtype=jnp.int32)[None, :])

    # one traced plane body vmapped over b (32 planes) — an unrolled
    # Python loop here compiles ~30x slower for the identical HLO work
    def _plane(b):
        live_p = b < bd_ac                          # traced bool (plane on)
        live = (dmax > b) & real                    # (Sp,)
        new = msb == b
        open_ = msb <= b

        wlen = jnp.zeros((Sp, NSLOT), jnp.int32)
        wval = jnp.zeros((Sp, NSLOT), jnp.int32)
        restr = jnp.zeros((Sp, NSLOT), jnp.bool_)
        nsign = jnp.zeros((Sp, NSLOT), jnp.int32)
        active = jnp.zeros((Sp, NSLOT), jnp.bool_)
        rawbit = jnp.zeros((Sp, NSLOT), jnp.bool_)  # 1-bit raw words

        # slot 0: parents
        popen = msbP <= b
        plen = popen.sum(axis=1).astype(jnp.int32)
        pflags = jnp.where(popen, (msbP == b).astype(jnp.int32), -1)
        pval = _pack_bits(pflags)
        pns = (popen & (msbP == b)).sum(axis=1).astype(jnp.int32)
        a0 = live & (plen >= 1)
        wlen = wlen.at[:, 0].set(jnp.where(a0, plen, 0))
        wval = wval.at[:, 0].set(pval)
        nsign = nsign.at[:, 0].set(jnp.where(a0, pns, 0))
        active = active.at[:, 0].set(a0)
        rawbit = rawbit.at[:, 0].set(a0 & (plen == 1))

        bsig = msbB >= b
        # slot 1: tranB (raw bit, possibly forced-omitted)
        no_par_new = ~(msbP == b).any(axis=1)
        forcedB = (b == dmax - 1) & no_par_new
        a1 = live & (msbB <= b) & ~forcedB
        wlen = wlen.at[:, 1].set(jnp.where(a1, 1, 0))
        active = active.at[:, 1].set(a1)
        rawbit = rawbit.at[:, 1].set(a1)

        # slot 2: tranD
        d_open = msbD <= b
        any_dsel = (msbD > b).any(axis=1)
        dlen = d_open.sum(axis=1).astype(jnp.int32)
        dflags = jnp.where(d_open, (msbD == b).astype(jnp.int32), -1)
        dval = _pack_bits(dflags)
        drestr = (msbB == b) & ~any_dsel
        a2 = live & bsig & (dlen >= 1) & ~((dlen == 1) & drestr)
        wlen = wlen.at[:, 2].set(jnp.where(a2, dlen, 0))
        wval = wval.at[:, 2].set(dval)
        restr = restr.at[:, 2].set(drestr)
        active = active.at[:, 2].set(a2)
        rawbit = rawbit.at[:, 2].set(a2 & (dlen == 1))

        child_msb = fam[:, :, 1:5]                    # (Sp, 3, 4)
        child_new_any = (child_msb == b).any(axis=2)
        child_any = (child_msb >= b).any(axis=2)
        # slots 3..5: typesC per family
        for f in range(3):
            cm = child_msb[:, f]                      # (Sp, 4)
            copen = cm <= b
            clen = copen.sum(axis=1).astype(jnp.int32)
            cflags = jnp.where(copen, (cm == b).astype(jnp.int32), -1)
            cval = _pack_bits(cflags)
            cns = (copen & (cm == b)).sum(axis=1).astype(jnp.int32)
            af = live & bsig & (msbD[:, f] >= b) & (clen >= 1)
            wlen = wlen.at[:, 3 + f].set(jnp.where(af, clen, 0))
            wval = wval.at[:, 3 + f].set(cval)
            nsign = nsign.at[:, 3 + f].set(jnp.where(af, cns, 0))
            active = active.at[:, 3 + f].set(af)
            rawbit = rawbit.at[:, 3 + f].set(af & (clen == 1))

        # slot 6: tranG
        forcedG = (msbD == b) & ~child_new_any & ~child_any   # (Sp, 3)
        g_in = (msbD >= b) & (msbG <= b) & ~forcedG
        glen = g_in.sum(axis=1).astype(jnp.int32)
        gflags = jnp.where(g_in, (msbG == b).astype(jnp.int32), -1)
        gval = _pack_bits(gflags)
        a6 = live & bsig & (glen >= 1)
        wlen = wlen.at[:, 6].set(jnp.where(a6, glen, 0))
        wval = wval.at[:, 6].set(gval)
        active = active.at[:, 6].set(a6)
        rawbit = rawbit.at[:, 6].set(a6 & (glen == 1))

        g_known = (msbD >= b) & (msbG >= b)           # (Sp, 3)
        for f in range(3):
            hm = msbH[:, f]                           # (Sp, 4)
            hopen = hm <= b
            any_hsel = (hm > b).any(axis=1)
            hlen = hopen.sum(axis=1).astype(jnp.int32)
            hflags = jnp.where(hopen, (hm == b).astype(jnp.int32), -1)
            hval = _pack_bits(hflags)
            hrestr = (msbG[:, f] == b) & ~any_hsel
            ah = live & bsig & g_known[:, f] & (hlen >= 1) & \
                ~((hlen == 1) & hrestr)
            s = 7 + 5 * f
            wlen = wlen.at[:, s].set(jnp.where(ah, hlen, 0))
            wval = wval.at[:, s].set(hval)
            restr = restr.at[:, s].set(hrestr)
            active = active.at[:, s].set(ah)
            rawbit = rawbit.at[:, s].set(ah & (hlen == 1))
            gm = fam[:, f, 5:].reshape(Sp, 4, 4)      # (Sp, 4 groups, 4)
            for j in range(4):
                tm = gm[:, j]                          # (Sp, 4)
                topen = tm <= b
                tlen = topen.sum(axis=1).astype(jnp.int32)
                tflags = jnp.where(topen, (tm == b).astype(jnp.int32), -1)
                tval = _pack_bits(tflags)
                tns = (topen & (tm == b)).sum(axis=1).astype(jnp.int32)
                trestr = msbH[:, f, j] == b
                at_ = live & bsig & g_known[:, f] & (msbH[:, f, j] >= b) \
                    & (tlen >= 1)
                omitted = (tlen == 1) & trestr
                sj = 8 + 5 * f + j
                wlen = wlen.at[:, sj].set(
                    jnp.where(at_ & ~omitted, tlen, 0))
                wval = wval.at[:, sj].set(tval)
                restr = restr.at[:, sj].set(trestr)
                nsign = nsign.at[:, sj].set(jnp.where(at_, tns, 0))
                active = active.at[:, sj].set(at_)
                rawbit = rawbit.at[:, sj].set(at_ & ~omitted & (tlen == 1))

        # nothing emits on dead planes
        active = active & live_p
        wlen = jnp.where(active, wlen, 0)
        nsign = jnp.where(active, nsign, 0)

        # ---- option selection per (gaggle, class) ----
        sym = jnp.where(restr, jnp.asarray(_SYM_RESTR)[wlen, wval],
                        jnp.asarray(_SYM_FULL)[wlen, wval])
        coded = active & (wlen >= 2)
        code_len = jnp.where(rawbit & active, 1, 0)    # raw 1-bit words
        id_extra = jnp.zeros((Sp, NSLOT), jnp.int32)
        for L in (2, 3, 4):
            mk = coded & (wlen == L)
            mg = mk.reshape(G, GAGGLE, NSLOT)
            unc = jnp.where(mk, L, 0).reshape(G, GAGGLE, NSLOT) \
                .sum(axis=(1, 2)).astype(jnp.int32)
            best = unc
            best_is = jnp.full((G,), 3, jnp.int32)     # 3 = uncoded
            nopt = int(_NOPT[L])
            for o in range(nopt - 1, -1, -1):          # reverse: ties ->
                lo = jnp.asarray(_LEN_TAB)[L, o, sym]  # lowest index wins
                co = jnp.where(mk, lo, 0).reshape(G, GAGGLE, NSLOT) \
                    .sum(axis=(1, 2)).astype(jnp.int32)
                pick = co <= best                      # <=: earlier wins
                best = jnp.where(pick, co, best)
                best_is = jnp.where(pick, o, best_is)
            # note: forward order with strict < equals reverse order with
            # <= (both resolve ties to the lowest option index; uncoded
            # only wins on strict <)
            sel = best_is[gidx]                        # (Sp,)
            len_sel = jnp.where(
                sel[:, None] >= nopt, L,
                jnp.asarray(_LEN_TAB)[L, jnp.clip(sel, 0, 2)[:, None],
                                      sym])
            code_len = jnp.where(mk, len_sel, code_len)
            # ID field on the first coded word of the class per gaggle
            okey = jnp.where(mk, ordkey, _INF)
            first = okey.reshape(G, GAGGLE * NSLOT).min(axis=1)
            isf = mk & (ordkey == first[gidx][:, None])
            id_extra = id_extra + jnp.where(isf, _IDB[L], 0)

        unit_len = code_len + id_extra + nsign         # (Sp, NSLOT)

        # ---- emission-order prefix sums ----
        l1 = unit_len[:, 0:1].reshape(-1)
        l2 = unit_len[:, 1:6].reshape(-1)
        l3 = unit_len[:, 6:].reshape(-1)
        ends = jnp.cumsum(jnp.concatenate([l1, l2, l3]))
        e1 = ends[:Sp].reshape(Sp, 1)
        e2 = ends[Sp:6 * Sp].reshape(Sp, 5)
        e3 = ends[6 * Sp:].reshape(Sp, 16)
        unit_end = jnp.concatenate([e1, e2, e3], axis=1)  # (Sp, NSLOT)
        words_total = ends[-1]

        # ---- stage 4 ----
        refmask = (msb > b) & live_p & real[:, None]
        cnt4 = refmask.sum(axis=1).astype(jnp.int32)
        blk_off = jnp.cumsum(cnt4) - cnt4
        within = jnp.cumsum(refmask.astype(jnp.int32), axis=1) - 1
        s4_pos = jnp.where(refmask, blk_off[:, None] + within, _INF)
        s4_total = cnt4.sum()

        stage0_bits = jnp.where(live_p & (b < q), S, 0)
        plane_bits = jnp.where(live_p,
                               stage0_bits + words_total + s4_total, 0)
        return (plane_bits.astype(jnp.int32), unit_end, s4_pos,
                stage0_bits, words_total)

    (plane_bits, unit_end_all, s4_pos_all, stage0_all,
     words_tot_all) = jax.vmap(_plane)(jnp.arange(32, dtype=jnp.int32))
    # plane_bits (32,); unit_end_all (32,Sp,22); s4_pos_all (32,Sp,63)
    # planes run bd_ac-1 .. 0: plane b starts after all higher planes
    above = (jnp.cumsum(plane_bits[::-1])[::-1] - plane_bits)
    plane_start = dpt_end + above                      # (32,)

    words_start = plane_start + stage0_all
    s4_start = words_start + words_tot_all

    total_bits = dpt_end + plane_bits.sum()
    full_bytes = HDR_BYTES + (total_bits + 7) // 8

    # per-coefficient acquisition unit: the slot that declares it at its
    # MSB plane — parent k=21f -> slot 0; child -> slot 3+f; grandchild
    # (f, group j) -> slot 8+5f+j
    slot_of = np.zeros(63, np.int32)
    for f in range(3):
        slot_of[21 * f] = 0
        slot_of[21 * f + 1: 21 * f + 5] = 3 + f
        for j in range(4):
            slot_of[21 * f + 5 + 4 * j: 21 * f + 9 + 4 * j] = 8 + 5 * f + j
    slot_of = jnp.asarray(slot_of)
    msb_c = jnp.clip(msb, 0, 31)
    acq_end = (words_start[msb_c] +
               jnp.take_along_axis(
                   unit_end_all[msb_c, jnp.arange(Sp)[:, None]],
                   slot_of[None, :, None], axis=2)[..., 0])
    acq_end = jnp.where(msb >= 0, acq_end, _INF)       # (Sp, 63)

    return {
        # NOTE: every entry is an array (vmap/jit-friendly pytree); the
        # padded block count Sp = ceil(S/16)*16 is recoverable from
        # shapes, S itself rides as a scalar array
        "S": jnp.int32(S),
        "mag": mag, "msb": msb, "neg": ac < 0,
        "qdc": qdc, "q": q, "bd_ac": bd_ac,
        "dc_orig": jnp.where(real, dc, 0),
        "dc_end": dc_end,                              # (Sp,)
        "add_start": add_start, "n_add": n_add,
        "dpt_end": dpt_end,
        "plane_start": plane_start, "s4_start": s4_start,
        "s4_pos": s4_pos_all,
        "acq_end": acq_end,
        "total_bits": total_bits, "full_bytes": full_bytes,
        "real": real,
    }


def bpe_size_bytes(blocks: jax.Array):
    """Exact untruncated stream byte count for one band."""
    return bpe_stream_layout(blocks)["full_bytes"]


def bpe_decode_at(layout: dict, budget_bytes: jax.Array):
    """Evaluate one byte budget: returns ((Sp, 64) int32 reconstructed
    weighted blocks — gaggle-PADDED, slice [:S] yourself — midpoint-
    filled exactly like the native decoder, and the exact encoded byte
    count)."""
    budget = jnp.asarray(budget_bytes, jnp.int32)
    eff = jnp.maximum(budget, HDR_BYTES + 8)           # encoder's floor
    nbytes = jnp.where(budget > 0,
                       jnp.minimum(layout["full_bytes"], eff),
                       layout["full_bytes"])
    cut = jnp.where(budget > 0,
                    8 * jnp.minimum(eff, jnp.int32(1 << 27)) - HDR_BITS,
                    _INF)

    Sp = layout["qdc"].shape[0]
    S = layout["S"]
    q = layout["q"]
    qdc = layout["qdc"]
    msb, mag = layout["msb"], layout["mag"]

    # ---- DC ----
    got_dc = layout["dc_end"] <= cut                   # (Sp,)
    dc = jnp.where(got_dc, qdc << q, 0)
    dc_known = jnp.where(got_dc, q, 32)
    # additional planes: bit (plane b = q-1-i, block m) at
    # add_start + i*S + m, received iff pos < cut
    idx = jnp.arange(Sp, dtype=jnp.int32)
    iv = jnp.arange(29, dtype=jnp.int32)[:, None]      # n_add <= q <= 22
    bv = q - 1 - iv                                    # (29, 1)
    pos = layout["add_start"] + iv * S + idx[None, :]
    ok = (iv < layout["n_add"]) & (pos < cut) & (idx[None, :] < S)
    bc = jnp.maximum(bv, 0)
    dcbits = (layout["dc_orig"][None, :] >> bc) & 1
    dc = dc | jnp.where(ok, dcbits << bc, 0).sum(axis=0)
    dc_known = jnp.minimum(dc_known,
                           jnp.where(ok, bv, 32).min(axis=0))

    # stage-0 DC refinement: plane b < min(q, bd_ac), position
    # plane_start[b] + m
    b0 = jnp.arange(32, dtype=jnp.int32)[:, None]      # (32, 1)
    pos = layout["plane_start"][:, None] + idx[None, :]
    ok = (b0 < layout["bd_ac"]) & (b0 < q) & (pos < cut) & \
        (idx[None, :] < S)
    dcbits = (layout["dc_orig"][None, :] >> b0) & 1
    dc = dc | jnp.where(ok, dcbits << b0, 0).sum(axis=0)
    dc_known = jnp.minimum(dc_known,
                           jnp.where(ok, b0, 32).min(axis=0))

    dcv = jnp.where(dc_known >= 32, 0,
                    jnp.where(dc_known > 0,
                              dc + (jnp.int32(1) << jnp.maximum(
                                  dc_known - 1, 0)), dc))

    # ---- AC ----
    acq = (msb >= 0) & (layout["acq_end"] <= cut)      # (Sp, 63)
    msb_c = jnp.clip(msb, 0, 31).astype(jnp.uint32)
    rec = jnp.where(acq, jnp.uint32(1) << msb_c, jnp.uint32(0))
    known = jnp.clip(msb, 0, 31)
    b4 = jnp.arange(32, dtype=jnp.int32)[:, None, None]     # (32,1,1)
    pos = layout["s4_start"][:, None, None] + layout["s4_pos"]
    inc = (b4 < msb[None]) & (pos < cut)                    # (32,Sp,63)
    rec = rec + jnp.where(
        inc, mag[None] & (jnp.uint32(1) << b4.astype(jnp.uint32)),
        jnp.uint32(0)).sum(axis=0, dtype=jnp.uint32)
    known = jnp.minimum(known, jnp.where(inc, b4, 32).min(axis=0))
    m = rec + jnp.where(acq & (known > 0),
                        jnp.uint32(1) << jnp.clip(known - 1, 0)
                        .astype(jnp.uint32),
                        jnp.uint32(0))
    acv = jnp.where(acq,
                    jnp.where(layout["neg"], -m.astype(jnp.int32),
                              m.astype(jnp.int32)), 0)

    out = jnp.concatenate([dcv[:, None], acv], axis=1)
    return out, nbytes


def bpe_truncated_decode(blocks: jax.Array, budget_bytes):
    """Model decode(encode(blocks, budget)) on device for one band."""
    layout = bpe_stream_layout(blocks)
    return bpe_decode_at(layout, budget_bytes)
