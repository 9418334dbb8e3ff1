# -*- coding: utf-8 -*-
"""Multi-chip scaling: shard the tile×band batch over a device mesh.

The reference has no distributed execution at all — its parallel structure
is embarrassingly-parallel loop nests run serially over subprocesses
(SURVEY §2.3; reference tools/run_codec.py:448-563 and the per-tile loops
in the wrappers). tpukit scales the same structure over a device mesh:

  * mesh axes ("dp", "sp"): data-parallel over independent tiles, and
    spectral-parallel over the band axis for the metric reductions (the
    180-band axis is the only long "sequence" in this workload,
    SURVEY §5.7);
  * work is expressed as one jitted step with NamedSharding constraints —
    GSPMD inserts the all-gathers/psums (over ICI) where the codec model
    needs whole-cube streams or the metrics need cross-band totals;
  * scalar results replicate; nothing rides DCN because tiles are
    independent.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpukit.codecs import ccsds121 as ck_dev
from tpukit.metrics.quality import quality_stats, quality_stats_ladder
from tpukit.metrics.spectral import spectral_stats, spectral_stats_ladder


def make_mesh(devices: Optional[Sequence] = None, dp: Optional[int] = None,
              sp: int = 1) -> Mesh:
    """Build a ("dp","sp") mesh. Defaults: all devices on dp."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp={dp * sp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def analysis_step_fn(tiles: jax.Array, recons: jax.Array,
                     valid: jax.Array) -> Dict[str, jax.Array]:
    """One fused benchmark step over a batch of tiles: exact CCSDS-121
    stream size per tile (encoder model) + full quality and spectral
    metrics. tiles/recons: (T, B, H, W) uint16-ring; valid: (T, H, W).

    This is the framework's flagship compute graph: what the reference
    does with per-tile subprocesses + numpy passes (run_codec.py:472-529)
    becomes one compiled program over the batch.
    """
    T, B, H, W = tiles.shape

    def per_tile(cube, rec, vm):
        flat = jnp.moveaxis(cube, 0, -1).reshape(-1)  # BIP stream order
        size = ck_dev.encode_size(flat)
        q = quality_stats(cube.astype(jnp.int32), rec.astype(jnp.int32), vm)
        s = spectral_stats(cube.astype(jnp.int32), rec.astype(jnp.int32), vm)
        return {"bitstream_bytes": size, "quality": q, "spectral": s}

    return jax.vmap(per_tile)(tiles, recons, valid)


def sharded_analysis_step(mesh: Mesh):
    """jit analysis_step_fn with tile batches sharded (dp) and the band
    axis sharded (sp)."""
    tile_sharding = NamedSharding(mesh, P("dp", "sp", None, None))
    mask_sharding = NamedSharding(mesh, P("dp", None, None))
    out_sharding = NamedSharding(mesh, P("dp"))

    return jax.jit(
        analysis_step_fn,
        in_shardings=(tile_sharding, tile_sharding, mask_sharding),
        out_shardings={"bitstream_bytes": out_sharding,
                       "quality": out_sharding,
                       "spectral": out_sharding},
    )


def sharded_metric_ladder(mesh: Mesh, has_nodata: bool, caseb: bool):
    """jit the sweep runner's rate-ladder metric pass over the mesh: the
    lane axis (rates × reps) shards over dp, the band axis over sp. This is
    the general path every codec's reconstructions go through — the sweep's
    metric workload for ANY codec scales over chips (SURVEY §2.3 item 3).

    Returns step(ref (B,H,W), recons (N,B,H,W), vm (H,W), sam_vm (H,W),
    nodata scalar) -> (quality stats pytree, spectral stats pytree | None),
    each leaf leading with the lane axis (sharded dp)."""
    lane = NamedSharding(mesh, P("dp", "sp", None, None))
    refs = NamedSharding(mesh, P("sp", None, None))
    rep = NamedSharding(mesh, P())
    out = NamedSharding(mesh, P("dp"))

    def fn(ref, recons, vm, sam_vm, nodata):
        qs = quality_stats_ladder(ref, recons, vm, nodata, has_nodata)
        ss = spectral_stats_ladder(ref, recons, sam_vm) if caseb else None
        return qs, ss

    return jax.jit(
        fn,
        in_shardings=(refs, lane, rep, rep, rep),
        out_shardings=(out, out if caseb else None),
    )


def place_ladder_inputs(mesh: Mesh, ref: np.ndarray, recons,
                        vm: np.ndarray, sam_vm: np.ndarray, nodata):
    """device_put the ladder inputs directly onto the mesh sharding (never
    via the default backend — see run_sharded_batch). ``recons`` is a list
    of (B,H,W) host/device arrays; the lane axis is padded to a multiple
    of dp by repeating the last lane (extra rows are sliced off by the
    caller). Returns (ref, stack, vm, sam_vm, nodata, n_real)."""
    dp = mesh.shape["dp"]
    n_real = len(recons)
    pad = (-n_real) % dp
    lanes = list(recons) + [recons[-1]] * pad
    stack = np.stack([np.asarray(x) for x in lanes])
    lane = NamedSharding(mesh, P("dp", "sp", None, None))
    refs = NamedSharding(mesh, P("sp", None, None))
    rep = NamedSharding(mesh, P())
    return (jax.device_put(np.asarray(ref), refs),
            jax.device_put(stack, lane),
            jax.device_put(np.asarray(vm), rep),
            jax.device_put(np.asarray(sam_vm), rep),
            jax.device_put(np.float32(nodata), rep),
            n_real)


def sharded_j2k_model(mesh: Mesh, levels: int = 5, segbounds=None):
    """Sharded J2K quantized-coefficient model: tiles (T,B,Hp,Wp) float32
    (already edge-padded to multiples of 2^levels) shard over dp; per tile
    the step runs the device 9/7 DWT, deadzone-quantizes at the given base
    step, and prices the embedded bit-plane stream EXACTLY with the
    closed-form size model (codecs/bitplane_model.py). Returns
    step(tiles, scale_map (Hp,Wp), base scalar, order (Hp*Wp,)) ->
    (T,) total bytes, without running the host coder at all."""
    from tpukit.codecs.j2k_codec import wenc_size_bytes
    from tpukit.kernels import dwt as dwtk

    tl = NamedSharding(mesh, P("dp", None, None, None))
    rep = NamedSharding(mesh, P())
    out = NamedSharding(mesh, P("dp"))

    def fn(tiles, scale_map, base, order):
        def per_tile(cube):
            coefs = dwtk.dwt2(cube, "97", levels)
            qc = jnp.trunc(coefs / (scale_map * base)[None]).astype(jnp.int32)
            perm = jnp.take(qc.reshape(qc.shape[0], -1), order, axis=1)
            return jnp.sum(wenc_size_bytes(perm, segbounds))

        return jax.vmap(per_tile)(tiles)

    return jax.jit(fn, in_shardings=(tl, rep, rep, rep),
                   out_shardings=out)


def sharded_ccsds122_ladder(mesh: Mesh, levels: int = 3,
                            weighted: bool = True):
    """Sharded CCSDS-122 rate point: tiles (T,B,Hp,Wp) int32 shard over
    dp (tiles) x sp (bands — every stage is band-independent, so the
    spectral axis shards with zero collectives). Per tile the step runs
    the reversible 9/7M DWT, applies the standard's subband weights
    (ccsds122_codec.subband_weight_map — rate points code weighted
    coefficients), the EXACT truncated-decode model of the embedded coder
    at the given per-band byte budget
    (codecs/bitplane_model.bpc_truncated_decode), unweights, and runs the
    inverse DWT. Returns step(tiles, order, inv, budget) ->
    (recon_planes (T,B,Hp,Wp) int32, per-band bytes (T,B)).

    ``weighted=False`` matches the codec's effective-lossless (budget 0)
    mode, which codes RAW coefficients (CCSDS122Codec.sweep_rates)."""
    from tpukit.codecs.bitplane_model import bpc_truncated_decode
    from tpukit.codecs.ccsds122_codec import subband_weight_map
    from tpukit.kernels import dwt as dwtk

    tl = NamedSharding(mesh, P("dp", "sp", None, None))
    rep = NamedSharding(mesh, P())
    szs = NamedSharding(mesh, P("dp", "sp"))

    def fn(tiles, order, inv, budget):
        Hp, Wp = tiles.shape[-2:]
        wmap = jnp.asarray(subband_weight_map(Hp, Wp))

        def per_tile(cube):
            coefs = dwtk.dwt2(cube, "97m", levels)
            if weighted:
                coefs = coefs * wmap[None]
            B = coefs.shape[0]
            perm = jnp.take(coefs.reshape(B, -1), order, axis=1)
            rec, nbytes = jax.vmap(
                lambda c: bpc_truncated_decode(c, budget))(perm)
            if weighted:
                wperm = wmap.reshape(-1)[order]
                rec = jnp.rint(rec.astype(jnp.float32)
                               / wperm[None]).astype(rec.dtype)
            planes = jnp.take(rec, inv, axis=1).reshape(coefs.shape)
            return dwtk.idwt2(planes, "97m", levels), nbytes

        return jax.vmap(per_tile)(tiles)

    return jax.jit(fn, in_shardings=(tl, rep, rep, rep),
                   out_shardings=(tl, szs))


def sharded_bpe122_budget_ladder(mesh: Mesh, levels: int, H0: int, W0: int,
                                 lo: int, hi: int, dtype: str):
    """Mesh-sharded CCSDS-122 BPE rate ladder: the Q byte budgets shard
    over dp, bands over sp. One shared 9/7M DWT + one stream-layout
    analysis (bpe122_model.bpe_stream_layout) feed every budget point;
    each dp group evaluates its budgets' exact stream bytes and
    truncated-decode reconstructions. Integer arithmetic end to end —
    mesh and single-device results are bit-identical
    (ccsds122_codec._bpe_ladder_device / _bpe_synthesize_device).

    Returns step(work (B,Hp,Wp) int32, gather (nb,64), wexp (Hp,Wp),
    budgets (Q,), scatter (Hp*Wp,)) ->
    (recons (Q,B,H0,W0) dtype, bytes (Q,B))."""
    from tpukit.codecs import bpe122_model as bpm
    from tpukit.kernels import dwt as dwtk

    refs = NamedSharding(mesh, P("sp", None, None))
    rep = NamedSharding(mesh, P())
    qv = NamedSharding(mesh, P("dp"))
    recon_sh = NamedSharding(mesh, P("dp", "sp", None, None))
    sz_sh = NamedSharding(mesh, P("dp", "sp"))

    def fn(work, gather, wexp, budgets, scatter):
        B = work.shape[0]
        Hp, Wp = work.shape[-2:]
        nb = (Hp // 8) * (Wp // 8)
        coefs = dwtk.dwt2(work, "97m", levels)
        blocks = (coefs << wexp[None]).reshape(B, -1)[:, gather]
        layouts = jax.vmap(bpm.bpe_stream_layout)(blocks)

        def point(b):
            rec, nbytes = jax.vmap(
                lambda l: bpm.bpe_decode_at(l, b))(layouts)
            plane = rec[:, :nb].reshape(B, -1)[:, scatter] \
                .reshape(B, Hp, Wp)
            k = wexp[None]
            q = plane >> k
            r = plane - (q << k)
            half = (jnp.int32(1) << k) >> 1
            up = (k > 0) & ((r > half) | ((r == half) & ((q & 1) == 1)))
            plane = q + up.astype(jnp.int32)
            out = dwtk.idwt2(plane, "97m", levels)[:, :H0, :W0]
            return jnp.clip(out, lo, hi).astype(dtype), nbytes

        return jax.vmap(point)(budgets)

    return jax.jit(fn, in_shardings=(refs, rep, rep, qv, rep),
                   out_shardings=(recon_sh, sz_sh))


def pad_to_dp(mesh: Mesh, vals: np.ndarray):
    """Pad a ladder axis to a multiple of dp by repeating the last entry
    (callers slice the padded rows back off)."""
    dp = mesh.shape["dp"]
    pad = (-len(vals)) % dp
    if pad:
        vals = np.concatenate([vals, np.repeat(vals[-1:], pad, axis=0)])
    return vals, pad


def run_sharded_batch(tiles: np.ndarray, recons: np.ndarray,
                      valid: np.ndarray, mesh: Optional[Mesh] = None):
    """Host entry: place a (T,B,H,W) batch on the mesh and run the step.

    Host arrays are `device_put` directly onto the mesh sharding — never
    committed to the default backend first (the mesh may live on a
    different backend, e.g. the virtual-CPU mesh under a GPU default).
    """
    mesh = mesh or make_mesh()
    tile_sh = NamedSharding(mesh, P("dp", "sp", None, None))
    mask_sh = NamedSharding(mesh, P("dp", None, None))
    step = sharded_analysis_step(mesh)
    out = step(jax.device_put(np.asarray(tiles), tile_sh),
               jax.device_put(np.asarray(recons), tile_sh),
               jax.device_put(np.asarray(valid), mask_sh))
    return jax.tree_util.tree_map(np.asarray, out)
