# -*- coding: utf-8 -*-
"""Exact on-device size model for the embedded bit-plane coder.

`native/src/bitplane.cpp` streams, per plane p (MSB→LSB):
  * one gate bit per not-yet-active group (activates when topg == p),
  * one significance bit per still-insignificant member of active groups,
    plus a sign bit for members that become significant at p,
  * one refinement bit per previously-significant coefficient.

Because every bit's plane membership is a closed-form function of the
coefficient's MSB index and its group's top plane, the total stream length
needs NO per-plane loop — it is a pure O(n) reduction:

  gates   = Σ_g (nplanes − max(topg_g, 0))        (gate-0 runs + the gate-1)
  members = Σ_i (topg_{g(i)} − max(msb_i, 0) + 1)  for groups with topg ≥ 0
  signs   = #{i : mag_i > 0}
  refine  = Σ_i max(msb_i, 0)

  bytes = 1 + ceil((gates+members+signs+refine) / 8)

This is the device-side "quantized-coefficient model" for the embedded
backend — CCSDS-122's only entropy stage (its -r bpp surface needs
truncatable streams) and J2K's fallback when the zigzag overflows the
Rice backend (j2k_codec.wenc_size_bytes): rate ladders and rate-target
searches can
price candidate quantizations entirely on device, with byte-exact
agreement with the host coder (tested in tests/test_bitplane_model.py).
The reference has no counterpart — its BPE/OpenJPEG rate control is
trial-encode-per-point in external binaries (ccsds122_wrap.py:110-121,
j2k_wrap.py:79-105).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

GROUP = 16  # must match bitplane.cpp


def _msb_index(mag: jax.Array) -> jax.Array:
    """31 - clz(mag); -1 for zero (matches bitplane.cpp msb_index)."""
    return 31 - jax.lax.clz(mag.astype(jnp.uint32)).astype(jnp.int32)


def bpc_size_bits(coefs: jax.Array, valid: jax.Array | None = None) -> jax.Array:
    """Exact bit count (excluding the 1-byte header) of bpc_encode over the
    last axis of ``coefs`` (int32, already in scan order). Leading axes are
    batch. ``valid`` masks padded tail entries (True = real coefficient);
    pad with zeros AND mark them invalid.
    """
    mag = jnp.abs(coefs).astype(jnp.uint32)
    if valid is None:
        w = jnp.ones(coefs.shape[-1], jnp.int32)
    else:
        w = valid.astype(jnp.int32)
    w = jnp.broadcast_to(w, coefs.shape)

    n = coefs.shape[-1]
    pad = (-n) % GROUP
    if pad:
        zpad = [(0, 0)] * (coefs.ndim - 1) + [(0, pad)]
        mag = jnp.pad(mag, zpad)
        w = jnp.pad(w, zpad)
    g = mag.shape[-1] // GROUP
    magg = mag.reshape(mag.shape[:-1] + (g, GROUP))
    wg = w.reshape(w.shape[:-1] + (g, GROUP))

    msb = _msb_index(magg)                      # (..., g, GROUP); -1 for 0
    topg = jnp.max(jnp.where(wg > 0, msb, -1), axis=-1)   # (..., g)
    nplanes = jnp.maximum(jnp.max(topg, axis=-1) + 1, 0)  # (...,)

    gates = jnp.sum(nplanes[..., None] - jnp.maximum(topg, 0), axis=-1)
    act = (topg >= 0)[..., None]                # group ever activates
    members = jnp.sum(
        jnp.where(act & (wg > 0),
                  topg[..., None] - jnp.maximum(msb, 0) + 1, 0),
        axis=(-2, -1))
    signs = jnp.sum((magg > 0) & (wg > 0), axis=(-2, -1)).astype(jnp.int32)
    refine = jnp.sum(jnp.where(wg > 0, jnp.maximum(msb, 0), 0),
                     axis=(-2, -1))
    # int32 is ample: one band's stream is < 2^31 bits (256 MB) by far
    return gates + members + signs + refine


def bpc_size_bytes(coefs: jax.Array, valid: jax.Array | None = None) -> jax.Array:
    """Exact byte length of bpc_encode (header byte included)."""
    bits = bpc_size_bits(coefs, valid)
    return 1 + (bits + 7) // 8


def bpc_size_bytes_host(coefs: np.ndarray) -> np.ndarray:
    """Host convenience wrapper (jits on default backend)."""
    return np.asarray(jax.jit(bpc_size_bytes)(jnp.asarray(coefs)))


# ---------------------------------------------------------------------------
# Exact truncated-decode model.
#
# bpc_encode(coefs, max_bytes) emits the embedded stream truncated at
# exactly 8*(max_bytes-1) payload bits (bitio.hpp BitWriter: overflowing
# bytes are dropped, never reordered), and bpc_decode reconstructs from the
# prefix with atomic significance units, bit-granular refinement, and a
# midpoint fill at each coefficient's lowest fully-known plane
# (bitplane.cpp decoder tail). Every one of those bit positions is a
# closed-form function of the coefficients' MSB indices, so the *decoded
# result of the truncated stream* — what the CCSDS-122 `-r {bpp}` surface
# actually produces (reference tools/codecs/ccsds122/ccsds122_wrap.py:
# 110-121) — can be computed on device without materializing the stream:
#
#   * per plane p, per group g, the significance-pass unit length is
#       inactive (topg<p): 1 gate bit;  fresh (topg==p): 1+nb+nh;
#       active  (topg>p): nb+nh if nb>0 else 0,
#     with nb = #{members: msb<=p}, nh = #{members: msb==p};
#   * the refinement pass of plane p holds one bit per coefficient with
#     msb>p, ordered by significance acquisition (= msb descending, scan
#     position ascending — a stable argsort);
#   * a coefficient is reconstructed iff its acquisition unit ends at or
#     before the cut; it receives each refinement bit whose absolute
#     position is below the cut, plus 1<<(known-1) where `known` is the
#     lowest plane whose bit arrived (or its MSB plane if none did).
#
# Byte-exactness vs the native coder is pinned by fuzz tests
# (tests/test_bitplane_model.py). This is what lets the CCSDS-122 rate
# ladder run device-resident end to end: DWT -> model -> inverse DWT with
# no coefficient-plane transfers.
# ---------------------------------------------------------------------------


def bpc_stream_layout(coefs: jax.Array, valid: jax.Array | None = None):
    """Budget-INDEPENDENT stream geometry for one band: everything
    `bpc_decode_at` needs to evaluate any byte budget — per-coefficient
    magnitude/MSB/sign, acquisition-unit end positions, refinement-pass
    start positions, acquisition ranks, and the full stream length. A
    rate ladder computes this once and prices/reconstructs every budget
    from it (the cut comparisons are the only budget-dependent work)."""
    n = coefs.shape[-1]
    mag = jnp.abs(coefs).astype(jnp.uint32)
    if valid is None:
        w = jnp.ones((n,), jnp.int32)
    else:
        w = valid.astype(jnp.int32)
    pad = (-n) % GROUP
    if pad:
        mag = jnp.pad(mag, (0, pad))
        w = jnp.pad(w, (0, pad))
    npad = mag.shape[-1]
    g = npad // GROUP
    magg = mag.reshape(g, GROUP)
    wg = w.reshape(g, GROUP)

    msb = jnp.where(wg > 0, _msb_index(magg), -1)        # (g, GROUP)
    topg = jnp.max(msb, axis=-1)                          # (g,)
    nplanes = jnp.maximum(jnp.max(topg) + 1, 0)           # scalar

    p = jnp.arange(32, dtype=jnp.int32)                   # plane axis
    # (32, g): unit composition per plane
    nb = jnp.sum((msb[None] <= p[:, None, None]) & (wg[None] > 0),
                 axis=-1).astype(jnp.int32)
    nh = jnp.sum(msb[None] == p[:, None, None], axis=-1).astype(jnp.int32)
    inactive = topg[None] < p[:, None]
    fresh = topg[None] == p[:, None]
    # positions fit int32: the stream is < 66 bits/coefficient, so any
    # band under ~32M coefficients stays far below 2^31 bits
    sig_bits = jnp.where(
        inactive, 1,
        jnp.where(fresh, 1 + nb + nh,
                  jnp.where(nb > 0, nb + nh, 0))).astype(jnp.int32)
    live = (p[:, None] < nplanes)
    sig_bits = jnp.where(live, sig_bits, 0)               # (32, g)

    sig_total = jnp.sum(sig_bits, axis=-1)                # (32,)
    # refinement bits at plane p: one per coefficient with msb > p
    msb_flat = msb.reshape(-1)
    ref_total = jnp.where(
        p < nplanes,
        jnp.sum(msb_flat[None] > p[:, None], axis=-1).astype(jnp.int32), 0)

    # stream runs planes nplanes-1 .. 0, each plane sig then ref; the
    # start of plane p's segments is the total of all higher planes
    seg_len = sig_total + ref_total
    above = jnp.cumsum(seg_len[::-1])[::-1] - seg_len     # Σ_{q>p} seg_len
    start_sig = above
    start_ref = above + sig_total

    # inclusive prefix of unit ends within each sig pass
    unit_end = start_sig[:, None] + jnp.cumsum(sig_bits, axis=-1)  # (32, g)

    total_bits = jnp.sum(seg_len)
    full_bytes = 1 + (total_bits + 7) // 8

    # acquisition rank: msb descending, scan position ascending (stable)
    order = jnp.argsort(-msb_flat, stable=True)
    rank = jnp.zeros((npad,), jnp.int32).at[order].set(
        jnp.arange(npad, dtype=jnp.int32))

    gidx = jnp.arange(npad, dtype=jnp.int32) // GROUP
    msb_c = jnp.clip(msb_flat, 0, 31)
    neg = (jnp.pad(coefs, (0, pad)) if pad else coefs) < 0
    # NOTE: every entry is an array (vmap-friendly pytree); padded length
    # npad = ceil(n/GROUP)*GROUP — callers slice [:n] themselves
    return {
        "mag": mag,                              # (npad,) uint32
        "msb": msb_flat,                         # (npad,) int32; -1 for 0
        "msb_c": msb_c,
        "neg": neg,
        "rank": rank,                            # acquisition order index
        "unit_end_i": unit_end[msb_c, gidx],     # per-coef unit end bit
        "start_ref": start_ref,                  # (32,)
        "full_bytes": full_bytes,
    }


def bpc_decode_at(layout: dict, budget_bytes: jax.Array):
    """Evaluate one byte budget against a precomputed stream layout.
    Returns (recon (npad,) int32 — group-padded, slice [:n] yourself —
    and the exact encoded nbytes)."""
    budget = jnp.asarray(budget_bytes, jnp.int32)
    nbytes = jnp.where(budget > 0,
                       jnp.minimum(layout["full_bytes"], budget),
                       layout["full_bytes"])
    # int32-safe cut sentinel: a budget beyond 2^27 bytes (1 Gbit) is
    # always past the whole stream, so clamping keeps 8*(budget-1) exact
    INF = jnp.int32(2**31 - 1)
    bclamp = jnp.minimum(budget, jnp.int32(1 << 27))
    cut = jnp.where(budget > 0, 8 * jnp.maximum(bclamp - 1, 0), INF)

    mag, msb_flat = layout["mag"], layout["msb"]
    msb_c, rank = layout["msb_c"], layout["rank"]
    start_ref = layout["start_ref"]
    acq = (msb_flat >= 0) & (layout["unit_end_i"] <= cut)

    # refinement reception: bit of plane q incorporated iff its absolute
    # position start_ref[q] + rank is below the cut (and q < msb). All of
    # a coefficient's refinement positions lie after its unit end, so no
    # extra acq gating is needed inside the loop.
    rec = jnp.where(acq, jnp.uint32(1) << msb_c.astype(jnp.uint32),
                    jnp.uint32(0))
    known = msb_c
    for q in range(32):
        inc = (q < msb_flat) & (start_ref[q] + rank < cut)
        rec = rec + jnp.where(inc, mag & jnp.uint32(1 << q), 0)
        known = jnp.where(inc, jnp.minimum(known, q), known)
    m = rec + jnp.where(acq & (known > 0),
                        jnp.uint32(1) << jnp.clip(known - 1, 0).astype(jnp.uint32),
                        jnp.uint32(0))
    out = jnp.where(acq,
                    jnp.where(layout["neg"], -m.astype(jnp.int32),
                              m.astype(jnp.int32)),
                    0)
    return out, nbytes


def bpc_truncated_decode(coefs: jax.Array, budget_bytes: jax.Array,
                         valid: jax.Array | None = None):
    """Model bpc_decode(bpc_encode(coefs, budget_bytes)) on device.

    ``coefs``: (n,) int32 in scan order. ``budget_bytes``: scalar int32
    (<=0 means untruncated). Returns ``(recon, nbytes)`` where ``recon``
    is the (n,) int32 reconstruction and ``nbytes`` the exact encoded
    byte length (header included, truncation applied).
    """
    out, nbytes = bpc_decode_at(bpc_stream_layout(coefs, valid),
                                budget_bytes)
    return out[:coefs.shape[-1]], nbytes
