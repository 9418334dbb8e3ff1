# -*- coding: utf-8 -*-
"""CCSDS-122-class codec: band-by-band DWT bit-plane coding with per-band
bpp rate control.

Behavior surface mirrors the reference wrapper
(reference tools/codecs/ccsds122/ccsds122_wrap.py):
  * band-by-band processing of the full image (:148-192)
  * rate control: per-band bpp; --cr converts via
    bits_per_sample/CR per band (:97-104)
  * an effective-lossless request (target bpp >= native bits) drops the
    rate limit entirely (:107, :121)

The transform is the standard's reversible integer 9/7M DWT (3 levels,
CCSDS 122.0-B §3.3) on device with the standard's subband weights applied
on rate-limited points (§3.6 — bit-plane significance then tracks pixel
distortion; measured +0.9..+3.5 dB at 0.5-2 bpp); the entropy stage on
rate-limited points is tpukit's embedded bit-plane coder, truncated at
the per-band byte budget — functionally equivalent rate control to the
BPE's `-r {bpp}` (the reference's BPE is a user-supplied Windows binary,
so bitstream-level parity is out of scope by construction; rate/quality
behavior is the contract). Effective-lossless points (the reference drops
`-r` entirely) need no truncatability, so they code through the quadruple
wenc backend (wavelet_common: Rice / run-length / Rice-split / embedded,
min-selected per band over exact device size models) — measured 3-6%
smaller lossless streams than the embedded coder alone.

Device-resident execution: the rate ladder never moves coefficient planes over
the link. `bitplane_model.bpc_truncated_decode` reproduces the native
coder's truncated decode (atomic significance units, bit-granular
refinement, midpoint fill) and its exact byte count on device, so
DWT -> entropy model -> inverse DWT runs HBM-resident; only the per-band
byte counts are fetched. The host coder (`wavelet_common.bpc_encode`)
materializes real streams when ``keep_bitstream`` asks for them, and the
fuzzed equality model==coder is pinned in tests/test_bitplane_model.py.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from tpukit.codecs.base import Codec, CodecResult, RateSpec, device_work
from tpukit.codecs import bitplane_model as bm
from tpukit.codecs import bpe122_model as bpm
from tpukit.codecs import wavelet_common as wc
from tpukit.kernels import dwt as dwtk
from tpukit.sweep.proc import mem_phase

LEVELS = 3

# Integer-DWT subband weights (CCSDS 122.0-B §3.6 Γ, doubled so HH1 — whose
# standard weight is ½ — stays at an exact ×1): bit-plane significance then
# tracks pixel-domain distortion, matching the BPE's rate-distortion
# behavior. Applied to RATE-LIMITED points only; effective-lossless streams
# code the raw coefficients (a uniform ×2 would append an all-zero plane's
# worth of refinement bits for nothing). Verified against the measured 9/7M
# synthesis-basis L2 norms (within the pow2 rounding): LL3 6.42, HL3/LH3
# 3.48, HH3 1.87, HL2/LH2 1.77, HH2 0.97, HL1/LH1 1.05, HH1 0.67.
_WEIGHTS = {"LL3": 16, "HL3": 8, "LH3": 8, "HH3": 4,
            "HL2": 4, "LH2": 4, "HH2": 2,
            "HL1": 2, "LH1": 2, "HH1": 1}

_WMAP_CACHE: Dict[tuple, np.ndarray] = {}


def subband_weight_map(Hp: int, Wp: int) -> np.ndarray:
    """(Hp, Wp) int32 pow2 weight per coefficient of the packed layout."""
    key = (Hp, Wp)
    hit = _WMAP_CACHE.get(key)
    if hit is None:
        hit = np.empty((Hp, Wp), np.int32)
        for name, lv, sl in dwtk.subband_slices(Hp, Wp, LEVELS):
            hit[sl] = _WEIGHTS[name]
        _WMAP_CACHE[key] = hit
    return hit


@partial(jax.jit, static_argnames=("weighted", "shift"))
def _analyze_ladder_device(work, order, budgets, wmap, weighted: bool,
                           shift: int = 0):
    """(B,Hp,Wp) int32 + (Q,) budgets -> ((Q,B,n) recon coefs, (Q,B) bytes,
    (B,n) scan-ordered coefficients as coded).

    The budget-independent stream layout (MSB geometry, bit offsets,
    acquisition ranks — including the per-band argsort) is computed ONCE
    and shared across the whole ladder; each budget point only pays the
    cut comparisons (bpc_decode_at). One compile serves any ladder of the
    same length: budgets are traced scalars. The coefficients stay a
    device output — only keep_bitstream callers fetch them.

    ``weighted``: scale by the subband weight map before coding and divide
    it back out (with rounding — midpoint fills need not stay multiples)
    after the truncated decode.
    """
    B = work.shape[0]
    if shift:
        # effective-lossless on bit-packed data: code (x >> k) of the k
        # exactly-zero LSBs (base.trailing_zero_shift); the caller shifts
        # the synthesized recon back
        work = work >> shift
    coefs = dwtk.dwt2(work, "97m", LEVELS)
    if weighted:
        coefs = coefs * wmap[None]
    perm = coefs.reshape(B, -1)[:, order]
    layouts = jax.vmap(bm.bpc_stream_layout)(perm)
    rec, nbytes = jax.vmap(lambda b: jax.vmap(
        lambda l: bm.bpc_decode_at(l, b))(layouts))(budgets)
    if weighted:
        wperm = wmap.reshape(-1)[order]
        rec = jnp.rint(rec.astype(jnp.float32)
                       / wperm[None, None]).astype(rec.dtype)
    return rec, nbytes, perm


@partial(jax.jit, static_argnames=("segbounds", "shift"))
def _lossless_analyze_device(work, order, segbounds, shift: int = 0):
    """Effective-lossless analysis: the stream needs no truncatability
    (the reference drops `-r` entirely, ccsds122_wrap.py:107/:121), so the
    entropy stage is the quadruple wenc backend (Rice / run-length /
    Rice-split / bit-plane, min-selected per band over exact device size
    models — j2k_codec.wenc_size_bytes) instead of the embedded coder:
    measured 3-6% smaller lossless streams. Returns ((B,n) scan-ordered
    coefficients — the untruncated decode is exact, so they ARE the recon
    coefficients — and (B,) exact stream bytes)."""
    from tpukit.codecs.j2k_codec import wenc_size_bytes

    B = work.shape[0]
    if shift:
        work = work >> shift
    coefs = dwtk.dwt2(work, "97m", LEVELS)
    perm = coefs.reshape(B, -1)[:, order]
    return perm, wenc_size_bytes(perm, segbounds)


@jax.jit
def _bpe_ladder_device(work, gather, wexp, budgets):
    """(B,Hp,Wp) int32 pixels + (Q,) byte budgets -> ((Q,B,Sp,64) int32
    reconstructed WEIGHTED blocks, (Q,B) exact stream bytes) for the
    CCSDS 122.0-B BPE backend.

    The budget-independent stream layout (gaggle DC/depth sections,
    per-coefficient acquisition ends, stage-4 positions) is computed ONCE
    per band and shared across the ladder; each budget point pays only
    the cut comparisons (bpe122_model.bpe_decode_at). lax.map over
    budgets keeps the per-point decode intermediates at single-budget
    size and compiles the point body once regardless of ladder length."""
    B = work.shape[0]
    coefs = dwtk.dwt2(work, "97m", LEVELS)
    blocks = (coefs << wexp[None]).reshape(B, -1)[:, gather]
    layouts = jax.vmap(bpm.bpe_stream_layout)(blocks)
    rec, nbytes = jax.lax.map(
        lambda b: jax.vmap(lambda l: bpm.bpe_decode_at(l, b))(layouts),
        budgets)
    return rec, nbytes, blocks


@jax.jit
def _bpe_blocks_device(work, gather, wexp):
    """(B,Hp,Wp) int32 pixels -> (B,Sp,64) weighted DWT blocks in BPE scan
    order — the host coder's input (the analysis half of
    _bpe_ladder_device, for materializing streams without re-running the
    whole ladder)."""
    B = work.shape[0]
    coefs = dwtk.dwt2(work, "97m", LEVELS)
    return (coefs << wexp[None]).reshape(B, -1)[:, gather]


@partial(jax.jit, static_argnames=("Hp", "Wp", "H0", "W0", "out_dtype"))
def _bpe_synthesize_device(rec, scatter, wexp, Hp, Wp, H0, W0, out_dtype,
                           lo, hi):
    """(B, Sp, 64) weighted recon blocks -> (B, H0, W0) clipped pixels.
    The pow2 subband weights (§3.6) divide back out with round-half-to-
    even in exact integer arithmetic — bit-identical to
    bpe122.decode_plane's float64 np.rint (truncated streams midpoint-
    fill, so reconstructions need not stay weight multiples)."""
    B = rec.shape[0]
    nb = (Hp // 8) * (Wp // 8)
    plane = rec[:, :nb].reshape(B, -1)[:, scatter].reshape(B, Hp, Wp)
    k = wexp[None]
    q = plane >> k
    r = plane - (q << k)
    half = (jnp.int32(1) << k) >> 1
    up = (k > 0) & ((r > half) | ((r == half) & ((q & 1) == 1)))
    plane = q + up.astype(jnp.int32)
    out = dwtk.idwt2(plane, "97m", LEVELS)[:, :H0, :W0]
    return jnp.clip(out, lo, hi).astype(out_dtype)


@partial(jax.jit, static_argnames=("Hp", "Wp", "H0", "W0", "out_dtype",
                                   "shift"))
def _synthesize_device(rec, inv, Hp, Wp, H0, W0, out_dtype, lo, hi,
                       shift: int = 0):
    B = rec.shape[0]
    planes = rec[:, inv].reshape(B, Hp, Wp)
    out = dwtk.idwt2(planes, "97m", LEVELS)[:, :H0, :W0]
    if shift:
        out = out << shift
    return jnp.clip(out, lo, hi).astype(out_dtype)


class CCSDS122Codec(Codec):
    """entropy='bpe' (default) codes CCSDS 122.0-B segment-structured
    streams (native/src/bpe122.cpp: headers, gaggle DC/depth coding,
    stages 0-4, SegByteLimit truncation — see the conformance note
    there); entropy='embedded' keeps the original tpukit embedded-coder
    format whose rate ladder is fully device-resident."""

    name = "ccsds122"
    encoder_desc = "tpukit CCSDS-122-class (device 9/7M DWT + embedded bit-plane coder)"
    bpe_desc = "tpukit CCSDS-122 BPE (9/7M DWT, segment/gaggle/stage structure)"
    supports_lossy = True

    def __init__(self, entropy: str = "bpe"):
        if entropy not in ("bpe", "embedded"):
            raise ValueError(f"entropy must be bpe|embedded, got {entropy!r}")
        self.entropy = entropy

    def budget_for(self, rate: RateSpec, B: int, H: int, W: int,
                   dtype_name: str):
        """RateSpec → (target_bpp_band, per-band byte budget; 0 = lossless)
        per reference ccsds122_wrap.py:97-121."""
        from tpukit.codecs.base import per_band_bpp
        bits_per_sample = 16.0 if dtype_name in ("uint16", "int16") else 8.0
        target_bpp_band, lossless_req = per_band_bpp(rate, B, bits_per_sample)
        budget = 0 if lossless_req else int(target_bpp_band * H * W / 8.0)
        return target_bpp_band, budget

    def _sweep_bpe(self, cube: np.ndarray, dtype_name: str, specs,
                   keep_bitstream: bool = False, **opts) -> list:
        """Standard-structure backend, device-resident: one device DWT +
        one stream-layout analysis feed every budget point; exact stream
        sizes and truncated reconstructions come from the on-device model
        (bpe122_model, fuzz-pinned byte- and coefficient-exact vs the
        native coder in tests/test_bpe122_model.py). The host BPE
        materializes real CCSDS 122.0-B segments only when
        ``keep_bitstream`` asks for them — and those sizes are asserted
        against the model. The standard codes raw pixel planes (no LSB
        shift — the reference's bpe.exe sees unshifted samples too);
        zero LSB planes of bit-packed baselines cost only near-empty
        planes."""
        from tpukit.codecs import bpe122

        specs = list(specs)
        B, H, W = cube.shape
        mult = 1 << LEVELS
        Hp, Wp = H + (-H) % mult, W + (-W) % mult
        info = np.iinfo(cube.dtype)
        points = [self.budget_for(spec, B, H, W, dtype_name)
                  for spec in specs]

        # distinct budgets evaluate once; every spec reuses its point
        out: list = [None] * len(points)
        by_budget: Dict[int, list] = {}
        for i, (_, budget) in enumerate(points):
            by_budget.setdefault(budget, []).append(i)
        budgets = list(by_budget)

        gather, scatter = bpe122.block_indices(Hp, Wp)
        wexp = bpe122.weight_exp_map(Hp, Wp)

        mesh = opts.get("mesh")
        if mesh is not None:
            # codec-phase sharding: budgets over dp, bands over sp
            # (parallel.mesh.sharded_bpe122_budget_ladder); integer math
            # end to end, so mesh layouts agree bit-for-bit. With
            # --keep-bitstream the host BPE materializes real segments
            # per budget AFTER the sharded model pass (the round-3 gate
            # fell back to single-device instead).
            return self._sweep_bpe_mesh(
                mesh, cube, points, by_budget, budgets, gather, scatter,
                wexp, Hp, Wp, H, W, info,
                keep_bitstream=keep_bitstream, dtype_name=dtype_name)

        work = device_work(cube, opts, mult, "int32")
        t0 = time.perf_counter()
        with mem_phase("comp"):
            rec_all, nbytes_all, blocks = _bpe_ladder_device(
                work, jnp.asarray(gather), jnp.asarray(wexp),
                jnp.asarray(budgets, jnp.int32))
            nbytes_all = np.asarray(nbytes_all)       # (Q, B) small fetch
        t_ladder = time.perf_counter() - t0

        blocks_host = np.asarray(blocks) if keep_bitstream else None
        signed = 1 if dtype_name.startswith("int") else 0
        for qi, (budget, ixs) in enumerate(by_budget.items()):
            t0 = time.perf_counter()
            with mem_phase("dec"):
                recon = _bpe_synthesize_device(
                    rec_all[qi], jnp.asarray(scatter), jnp.asarray(wexp),
                    Hp, Wp, H, W, cube.dtype.name,
                    int(info.min), int(info.max))
                recon.block_until_ready()
            t_dec = time.perf_counter() - t0

            streams = None
            t_enc = 0.0
            if keep_bitstream:
                t0 = time.perf_counter()
                with mem_phase("comp"):
                    streams = [bpe122.bpe_encode_blocks(
                        blocks_host[b], seg_byte_limit=budget,
                        img_width=W, pad_rows=Hp - H, pixel_bitdepth=16,
                        signed_pixels=signed) for b in range(B)]
                t_enc = time.perf_counter() - t0
                assert [len(s) for s in streams] == \
                    nbytes_all[qi].tolist(), "bpe122 device size model " \
                    "disagrees with the native coder"

            nbytes = int(nbytes_all[qi].sum())
            for i in ixs:
                target_bpp_band, _ = points[i]
                out[i] = CodecResult(
                    codec="ccsds122_ext", encoder=self.bpe_desc,
                    bitstream_bytes=nbytes, recon=recon,
                    t_comp_s=(t_ladder / len(budgets) + t_enc) / len(ixs),
                    t_dec_s=t_dec / len(ixs),
                    bitstreams={f"b{b+1:02d}.bpe": streams[b]
                                for b in range(B)} if keep_bitstream
                    else None,
                    extras={"bands": int(B),
                            "bpp_target_band": float(target_bpp_band),
                            "entropy": "bpe"})
        return out

    def _sweep_bpe_mesh(self, mesh, cube, points, by_budget, budgets,
                        gather, scatter, wexp, Hp, Wp, H, W, info,
                        keep_bitstream: bool = False,
                        dtype_name: str = "uint16") -> list:
        """BPE budget ladder on a device mesh: distinct budgets shard over
        dp, bands over sp (parallel.mesh.sharded_bpe122_budget_ladder).
        ``keep_bitstream`` materializes real CCSDS 122.0-B segments per
        budget host-side after the sharded model pass, asserted against
        the model's byte counts."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from tpukit.codecs.j2k_codec import (_MESH_LADDERS,
                                             mesh_for_bands)
        from tpukit.parallel.mesh import (pad_to_dp,
                                          sharded_bpe122_budget_ladder)

        B = cube.shape[0]
        m = mesh_for_bands(mesh, B)
        key = ("bpe122", m, LEVELS, H, W, Hp, Wp, int(info.min),
               int(info.max), cube.dtype.name)
        step = _MESH_LADDERS.get(key)
        if step is None:
            step = sharded_bpe122_budget_ladder(
                m, LEVELS, H, W, int(info.min), int(info.max),
                cube.dtype.name)
            _MESH_LADDERS[key] = step
        refs = NamedSharding(m, P("sp", None, None))
        rep = NamedSharding(m, P())
        qv = NamedSharding(m, P("dp"))

        t0 = time.perf_counter()
        with mem_phase("comp"):
            work = np.pad(cube.astype(np.int32),
                          ((0, 0), (0, Hp - H), (0, Wp - W)), mode="edge")
            budgets_p, _ = pad_to_dp(m, np.asarray(budgets, np.int32))
            rec_all, nbytes_all = step(
                jax.device_put(work, refs),
                jax.device_put(np.asarray(gather), rep),
                jax.device_put(np.asarray(wexp), rep),
                jax.device_put(budgets_p, qv),
                jax.device_put(np.asarray(scatter), rep))
            nbytes_all = np.asarray(nbytes_all)
        t_ladder = time.perf_counter() - t0
        t0 = time.perf_counter()
        with mem_phase("dec"):
            rec_all.block_until_ready()
        t_dec = time.perf_counter() - t0

        blocks_host = None
        signed = 1 if dtype_name.startswith("int") else 0
        if keep_bitstream:
            from tpukit.codecs import bpe122
            # one weighted-block analysis on the first mesh device feeds
            # the host coder for every budget (integer program — identical
            # blocks on any device)
            d0 = list(m.devices.ravel())[0]
            blocks_host = np.asarray(_bpe_blocks_device(
                jax.device_put(work, d0),
                jax.device_put(np.asarray(gather), d0),
                jax.device_put(np.asarray(wexp), d0)))

        out: list = [None] * len(points)
        for qi, (budget, ixs) in enumerate(by_budget.items()):
            streams = None
            t_enc = 0.0
            if keep_bitstream:
                t0 = time.perf_counter()
                with mem_phase("comp"):
                    streams = [bpe122.bpe_encode_blocks(
                        blocks_host[b], seg_byte_limit=budget,
                        img_width=W, pad_rows=Hp - H, pixel_bitdepth=16,
                        signed_pixels=signed) for b in range(B)]
                t_enc = time.perf_counter() - t0
                if [len(s) for s in streams] != nbytes_all[qi].tolist():
                    # not an assert: must survive python -O — a model/
                    # coder drift silently desyncs CSV byte counts from
                    # the written .bpe artifacts otherwise
                    raise RuntimeError(
                        "bpe122 mesh size model disagrees with the "
                        f"native coder: {[len(s) for s in streams]} != "
                        f"{nbytes_all[qi].tolist()}")
            nbytes = int(nbytes_all[qi].sum())
            for i in ixs:
                target_bpp_band, _ = points[i]
                out[i] = CodecResult(
                    codec="ccsds122_ext", encoder=self.bpe_desc,
                    bitstream_bytes=nbytes, recon=rec_all[qi],
                    t_comp_s=(t_ladder / len(budgets) + t_enc) / len(ixs),
                    t_dec_s=t_dec / len(budgets) / len(ixs),
                    bitstreams={f"b{b+1:02d}.bpe": streams[b]
                                for b in range(B)} if keep_bitstream
                    else None,
                    extras={"bands": int(B),
                            "bpp_target_band": float(target_bpp_band),
                            "entropy": "bpe"})
        return out

    def sweep_rates(self, cube: np.ndarray, dtype_name: str, specs,
                    keep_bitstream: bool = False, **opts) -> list:
        """Rate ladder, device-resident end to end: one DWT feeds every
        budget point; reconstructions and exact stream sizes come from the
        on-device truncated-decode model; host streams only on demand."""
        if self.entropy == "bpe":
            return self._sweep_bpe(cube, dtype_name, specs,
                                   keep_bitstream=keep_bitstream, **opts)
        specs = list(specs)
        B, H, W = cube.shape
        work = device_work(cube, opts, 1 << LEVELS, "int32")
        H0, W0 = H, W
        Hp, Wp = work.shape[-2:]
        order, inv = wc.device_scan_orders(Hp, Wp, LEVELS)
        info = np.iinfo(cube.dtype)

        points = [self.budget_for(spec, B, H, W, dtype_name)
                  for spec in specs]
        wmap = jnp.asarray(subband_weight_map(Hp, Wp))
        from tpukit.codecs.base import trailing_zero_shift
        shift = trailing_zero_shift(cube)

        # rate-limited points code SUBBAND-WEIGHTED coefficients (standard
        # BPE behavior, see _WEIGHTS); effective-lossless points code raw
        # coefficients — at most two device dispatches per ladder
        out: list = [None] * len(points)
        t_model_total = t_syn_total = 0.0
        parts = {}
        for i, (_, budget) in enumerate(points):
            parts.setdefault(budget > 0, []).append(i)
        segb = wc.subband_seg_bounds(Hp, Wp, LEVELS)
        for weighted, ixs in parts.items():
            # the shift applies to effective-lossless points only (a
            # rate-limited stream is budget-truncated either way)
            sh = 0 if weighted else shift
            host_perm = None
            t0 = time.perf_counter()
            with mem_phase("comp"):
                if weighted:
                    rec, nbytes, perm = _analyze_ladder_device(
                        work, order,
                        jnp.asarray([points[i][1] for i in ixs], jnp.int32),
                        wmap, weighted, sh)
                    nbytes_host = np.asarray(nbytes)    # (len(ixs), B)
                else:
                    # effective-lossless: untruncated streams through the
                    # quadruple wenc backend; every such point shares one
                    # analysis (identical recon and sizes)
                    perm, sizes = _lossless_analyze_device(
                        work, order, segb, sh)
                    rec = perm[None]
                    nbytes_host = np.broadcast_to(
                        np.asarray(sizes)[None] + 1,    # 1-byte shift pfx
                        (len(ixs), B))
                if keep_bitstream:
                    # the ladder already holds the scan-ordered
                    # coefficients; this fetch is the materializing path's
                    # only bulk transfer
                    host_perm = np.asarray(perm)
            t_model = time.perf_counter() - t0
            t_model_total += t_model

            t0 = time.perf_counter()
            with mem_phase("dec"):
                recons = jax.vmap(
                    lambda r: _synthesize_device(
                        r, inv, Hp, Wp, H0, W0, cube.dtype.name,
                        info.min, info.max, sh))(rec)
                recons.block_until_ready()
            t_syn = time.perf_counter() - t0
            t_syn_total += t_syn

            for k, i in enumerate(ixs):
                target_bpp_band, budget = points[i]
                streams = None
                t_streams = 0.0
                if keep_bitstream:
                    t0 = time.perf_counter()
                    # rate-point streams carry WEIGHTED coefficients —
                    # the .wbit suffix keeps them distinguishable on disk
                    # from raw-coefficient lossless streams (decode recipe:
                    # bpc_decode, then /subband_weight_map, then idwt)
                    if weighted:
                        streams = {f"b{b+1:02d}.wbit":
                                   wc.bpc_encode(host_perm[b], budget)
                                   for b in range(B)}
                    else:
                        # lossless .bit streams: 1-byte LSB-shift prefix +
                        # a wenc stream (marker-dispatched backend; decode:
                        # wenc_decode the rest with the subband segbounds,
                        # idwt, << shift)
                        streams = {f"b{b+1:02d}.bit":
                                   bytes([sh]) +
                                   wc.wenc_encode(host_perm[b],
                                                  segbounds=segb)
                                   for b in range(B)}
                    t_streams = time.perf_counter() - t0
                out[i] = CodecResult(
                    codec="ccsds122_ext", encoder=self.encoder_desc,
                    bitstream_bytes=int(nbytes_host[k].sum()),
                    # all effective-lossless points share the single
                    # analysis lane (recons has leading dim 1 there)
                    recon=recons[k if weighted else 0],
                    t_comp_s=t_model / len(ixs) + t_streams,
                    t_dec_s=t_syn / len(ixs), bitstreams=streams,
                    extras={"bands": int(B),
                            "bpp_target_band": float(target_bpp_band),
                            "subband_weighted": bool(weighted)})
        return out

    def run(self, cube: np.ndarray, dtype_name: str, rate: RateSpec,
            keep_bitstream: bool = False, **opts) -> CodecResult:
        return self.sweep_rates(cube, dtype_name, [rate],
                                keep_bitstream=keep_bitstream, **opts)[0]
