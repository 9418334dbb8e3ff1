# -*- coding: utf-8 -*-
"""Fused image-quality metrics on device (PSNR / global SSIM / max|Δ|).

Replicates the *non-standard* definitions of the reference harness —
windowless global SSIM (reference tools/run_codec.py:67-80), data-range-aware
PSNR with the 255/4095/65535/8191 bit-packing heuristic (:86-117), masked
per-band and global aggregation (:240-304) — but computes them the device way:

  * one fused device pass over the HBM-resident ``(B, H, W)`` cube pair
    produces every per-band moment needed for all metrics at once;
  * second moments are accumulated about per-band centers (mean estimates
    from a first cheap reduction), so float32 reductions carry no
    catastrophic cancellation: results agree with the reference's float64
    numpy path to ~1e-6 relative;
  * max|Δ| and the lossless flag come from exact int32 reductions;
  * masking is weight-based (multiply-by-0/1), never gather-based, so the
    whole thing is a static-shape XLA reduction that vmaps/pjits cleanly.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpukit.io.bitdepth import effective_data_range


@jax.jit
def quality_stats(ref: jax.Array, tst: jax.Array, valid: jax.Array) -> Dict[str, jax.Array]:
    """Per-band moments for PSNR/SSIM/max|Δ| under a validity mask.

    ref/tst: (B, H, W) integer cubes; valid: (H, W) bool/int mask.
    Matches reference run_codec.py:264-285: if the mask selects nothing,
    statistics fall back to all pixels (``use_mask = np.any(vm)``).
    """
    # Integer cubes difference exactly in int32; float cubes must NOT be
    # truncated toward zero (the reference differences the original arrays
    # in float64, run_codec.py:275-285) — keep them in float32.
    is_float = jnp.issubdtype(ref.dtype, jnp.floating) or \
        jnp.issubdtype(tst.dtype, jnp.floating)
    work_dt = jnp.float32 if is_float else jnp.int32
    a = ref.astype(work_dt)
    r = tst.astype(work_dt)
    w = valid.astype(jnp.int32)
    any_valid = jnp.any(w > 0)
    w = jnp.where(any_valid, w, jnp.ones_like(w))
    wf = w.astype(jnp.float32)[None]          # (1,H,W)
    wi = w[None].astype(work_dt)

    af = a.astype(jnp.float32)
    rf = r.astype(jnp.float32)
    n = jnp.sum(wf)

    # pass 1: center estimates (any constant works; mean keeps residues small)
    c_a = jnp.sum(af * wf, axis=(1, 2)) / jnp.maximum(n, 1.0)
    c_r = jnp.sum(rf * wf, axis=(1, 2)) / jnp.maximum(n, 1.0)

    # pass 2: centered moments (no cancellation in f32)
    ac = (af - c_a[:, None, None]) * wf
    rc = (rf - c_r[:, None, None]) * wf

    d = (a - r) * wi                           # exact int32 difference
    df = d.astype(jnp.float32)

    stats = {
        "n": n,
        "c_a": c_a, "c_r": c_r,
        "sum_ac": jnp.sum(ac, axis=(1, 2)),
        "sum_rc": jnp.sum(rc, axis=(1, 2)),
        "sum_ac2": jnp.sum(ac * ac, axis=(1, 2)),
        "sum_rc2": jnp.sum(rc * rc, axis=(1, 2)),
        "sum_acrc": jnp.sum(ac * rc, axis=(1, 2)),
        "sse": jnp.sum(df * df, axis=(1, 2)),
        "maxerr": jnp.max(jnp.abs(d), axis=(1, 2)),
        "max_abs_obs": jnp.max(jnp.maximum(jnp.abs(a), jnp.abs(r)) * wi, axis=(1, 2)),
    }
    return stats


def _psnr_from(sse: float, n: float, rng: float) -> float:
    if n <= 0:
        return float("nan")
    if sse == 0:
        return float("inf")
    m = sse / n
    return 20.0 * math.log10(rng) - 10.0 * math.log10(m)


def _ssim_from(mu_x, mu_y, sigma_x2, sigma_y2, sigma_xy, rng) -> float:
    """Windowless global SSIM (reference run_codec.py:67-80: population
    variance, den==0 -> 1, clipped to [0,1])."""
    L = rng
    C1 = (0.01 * L) ** 2
    C2 = (0.03 * L) ** 2
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x2 + sigma_y2 + C2)
    if den == 0:
        return 1.0
    return max(0.0, min(1.0, num / den))


def assemble_quality(stats: Dict[str, np.ndarray], data_range: float) -> Dict[str, float]:
    """Host-side float64 assembly of the reference metric dict
    (run_codec.py:294-304 keys: psnr/ssim band avg + global, max_abs_err,
    lossless, per-band psnr_b{i}/ssim_b{i}/maxerr_b{i})."""
    n = float(np.asarray(stats["n"], dtype=np.float64))
    c_a = np.asarray(stats["c_a"], dtype=np.float64)
    c_r = np.asarray(stats["c_r"], dtype=np.float64)
    sum_ac = np.asarray(stats["sum_ac"], dtype=np.float64)
    sum_rc = np.asarray(stats["sum_rc"], dtype=np.float64)
    sum_ac2 = np.asarray(stats["sum_ac2"], dtype=np.float64)
    sum_rc2 = np.asarray(stats["sum_rc2"], dtype=np.float64)
    sum_acrc = np.asarray(stats["sum_acrc"], dtype=np.float64)
    sse = np.asarray(stats["sse"], dtype=np.float64)
    maxerr = np.asarray(stats["maxerr"], dtype=np.float64)  # float cubes
    B = len(c_a)

    def _err(v: float):
        return int(v) if float(v).is_integer() else float(v)

    psnrs, ssims = [], []
    for i in range(B):
        psnrs.append(_psnr_from(sse[i], n, data_range))
        if n > 0:
            mu_x = c_a[i] + sum_ac[i] / n
            mu_y = c_r[i] + sum_rc[i] / n
            var_x = sum_ac2[i] / n - (sum_ac[i] / n) ** 2
            var_y = sum_rc2[i] / n - (sum_rc[i] / n) ** 2
            cov = sum_acrc[i] / n - (sum_ac[i] / n) * (sum_rc[i] / n)
            ssims.append(_ssim_from(mu_x, mu_y, var_x, var_y, cov, data_range))
        else:
            ssims.append(float("nan"))
    sse_total = float(np.sum(sse))
    n_total = n * B
    rng_obs = float(np.max(np.asarray(stats["max_abs_obs"])))
    if n_total > 0:
        rng_use = max(float(data_range), rng_obs) if math.isfinite(data_range) else rng_obs
        psnr_total = float("inf") if sse_total == 0.0 else (
            20.0 * math.log10(rng_use) - 10.0 * math.log10(sse_total / n_total))
    else:
        psnr_total = float("nan")
    ssim_total = float(np.nanmean(ssims)) if ssims else float("nan")
    out = {
        "psnr_band_avg": float(np.nanmean(psnrs)) if psnrs else float("nan"),
        "ssim_band_avg": float(np.nanmean(ssims)) if ssims else float("nan"),
        "psnr_global": psnr_total,
        "ssim_global": ssim_total,
        "max_abs_err": _err(maxerr.max()) if B else 0,
        "lossless": 1 if (B and maxerr.max() == 0) else 0,
    }
    for i in range(B):
        out[f"psnr_b{i+1}"] = psnrs[i]
        out[f"ssim_b{i+1}"] = ssims[i]
        out[f"maxerr_b{i+1}"] = _err(maxerr[i])
    return out


def compute_metrics(ref_cube: np.ndarray, tst_cube: np.ndarray,
                    dtype_name: Optional[str] = None,
                    valid: Optional[np.ndarray] = None,
                    nodata: Optional[float] = None,
                    ref_mask: Optional[np.ndarray] = None,
                    tst_mask: Optional[np.ndarray] = None,
                    data_range: Optional[float] = None) -> Dict[str, float]:
    """End-to-end equivalent of reference run_codec.py:240-304 on arrays.

    The reference builds the validity map as dataset_mask(ref) ∧
    dataset_mask(tst) ∧ (band != nodata for every band of both) ∧ user mask
    (:249-263); pass those components here. ``data_range`` overrides the
    dtype/bit-packing heuristic (:86-117, computed from the *reference* cube).
    """
    ref_cube = np.asarray(ref_cube)
    tst_cube = np.asarray(tst_cube)
    if ref_cube.shape != tst_cube.shape:
        raise ValueError("Reference and test must match in size and band count.")
    B, H, W = ref_cube.shape
    if dtype_name is None:
        dtype_name = ref_cube.dtype.name
    if data_range is None:
        data_range = effective_data_range(ref_cube, dtype_name)

    vm = np.ones((H, W), dtype=bool)
    if ref_mask is not None:
        vm &= np.asarray(ref_mask) > 0
    if tst_mask is not None:
        vm &= np.asarray(tst_mask) > 0
    if nodata is not None and math.isfinite(nodata):
        for i in range(B):
            vm &= ref_cube[i] != nodata
            vm &= tst_cube[i] != nodata
    if valid is not None:
        v = np.asarray(valid)
        if v.shape != (H, W):
            raise ValueError(f"Mask shape {v.shape} != {(H, W)}")
        vm &= v.astype(bool)

    stats = quality_stats(jnp.asarray(ref_cube), jnp.asarray(tst_cube),
                          jnp.asarray(vm))
    stats = {k: np.asarray(v) for k, v in stats.items()}
    return assemble_quality(stats, float(data_range))


# ---------------------------------------------------------------------------
# Batched variant: one call over (N, B, H, W) stacks (rates × reps × tiles)
# ---------------------------------------------------------------------------

@jax.jit
def quality_stats_batched(ref: jax.Array, tst: jax.Array, valid: jax.Array):
    """vmap of quality_stats over a leading batch axis.

    ref/tst: (N, B, H, W); valid: (N, H, W). This is how the sweep runner
    scores a whole rate ladder in one device launch instead of the
    reference's per-(tile,rate,rep) subprocess + numpy pass
    (run_codec.py:472-529)."""
    return jax.vmap(lambda a, r, v: quality_stats(a, r, v))(ref, tst, valid)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("has_nodata",))
def quality_stats_ladder(ref: jax.Array, recons: jax.Array,
                         valid_base: jax.Array, nodata,
                         has_nodata: bool):
    """Rate-ladder metrics with the reference cube closed over (uploaded
    once): recons is (N, B, H, W) against one (B, H, W) ref. The per-recon
    validity mask folds the recon-side nodata exclusion on device
    (reference run_codec.py:249-263 builds the mask from BOTH cubes)."""
    def one(t):
        vm = valid_base
        if has_nodata:
            vm = vm & jnp.all(t != nodata, axis=0)
        return quality_stats(ref, t, vm)
    return jax.vmap(one)(recons)


def assemble_quality_many(stacked: Dict[str, np.ndarray],
                          data_range: float) -> list:
    """Split a stacked (leading axis N) stats fetch into N reference metric
    dicts via assemble_quality."""
    n = len(np.asarray(stacked["maxerr"]))
    return [assemble_quality({k: np.asarray(v)[i] for k, v in stacked.items()},
                             data_range) for i in range(n)]


# ---------------------------------------------------------------------------
# Strip streaming: per-strip stats + exact float64 merge (scene-scale sweeps)
# ---------------------------------------------------------------------------

@jax.jit
def quality_stats_dual(ref: jax.Array, tst: jax.Array, valid: jax.Array):
    """quality_stats twice for one strip: under the strip's validity mask
    (NO empty-mask fallback — a strip with zero valid pixels contributes
    nothing) and under an all-ones mask. The merge layer picks the all-ones
    accumulation only when the GLOBAL mask is empty, reproducing the
    reference's whole-image fallback (run_codec.py:264-266) without a
    second pass over the scene.

    Bands are processed SEQUENTIALLY (lax.map): the streaming path's peak
    working set must stay O(rows × W), not O(B × rows × W) — a strip of a
    wide many-band scene would otherwise materialize GBs of f32
    temporaries in one launch."""
    is_float = jnp.issubdtype(ref.dtype, jnp.floating) or \
        jnp.issubdtype(tst.dtype, jnp.floating)
    work_dt = jnp.float32 if is_float else jnp.int32
    wi_m = valid.astype(jnp.int32)
    any_valid = jnp.any(wi_m > 0)
    wf_m = wi_m.astype(jnp.float32)
    n_m = jnp.sum(wf_m)
    n_u = jnp.float32(ref.shape[1] * ref.shape[2])

    def band_stats(a2, r2, wf, wi, n):
        a = a2.astype(work_dt)
        r = r2.astype(work_dt)
        af = a.astype(jnp.float32)
        rf = r.astype(jnp.float32)
        c_a = jnp.sum(af * wf) / jnp.maximum(n, 1.0)
        c_r = jnp.sum(rf * wf) / jnp.maximum(n, 1.0)
        ac = (af - c_a) * wf
        rc = (rf - c_r) * wf
        d = (a - r) * wi.astype(work_dt)
        df = d.astype(jnp.float32)
        return (c_a, c_r, jnp.sum(ac), jnp.sum(rc), jnp.sum(ac * ac),
                jnp.sum(rc * rc), jnp.sum(ac * rc), jnp.sum(df * df),
                jnp.max(jnp.abs(d)),
                jnp.max(jnp.maximum(jnp.abs(a), jnp.abs(r))
                        * wi.astype(work_dt)))

    def per_band(ar):
        a2, r2 = ar
        m = band_stats(a2, r2, wf_m, wi_m, n_m)
        u = band_stats(a2, r2, jnp.ones_like(wf_m), jnp.ones_like(wi_m),
                       n_u)
        return m, u

    keys = ("c_a", "c_r", "sum_ac", "sum_rc", "sum_ac2", "sum_rc2",
            "sum_acrc", "sse", "maxerr", "max_abs_obs")
    m_leaves, u_leaves = jax.lax.map(per_band, (ref, tst))
    masked = dict(zip(keys, m_leaves))
    masked["n"] = n_m
    # empty strip mask -> identically-zero masked contribution
    masked = {k: jnp.where(any_valid, v, jnp.zeros_like(v))
              for k, v in masked.items()}
    unmasked = dict(zip(keys, u_leaves))
    unmasked["n"] = n_u
    return masked, unmasked


def merge_quality_stats(parts: list) -> Dict[str, np.ndarray]:
    """Combine per-strip quality_stats into whole-image stats, exactly
    (float64 pairwise/streamed Chan-Golub-LeVeque moment combination).

    Output feeds assemble_quality unchanged: the merged dict uses the
    combined means as the centers (sum_ac == sum_rc == 0), centered second
    moments as sum_*2, and the centered cross moment as sum_acrc."""
    parts = [p for p in parts if p is not None]
    if not parts:
        raise ValueError("no stats to merge")
    first = parts[0]
    Bn = len(np.asarray(first["c_a"]))
    n = 0.0
    mu_a = np.zeros(Bn)
    mu_r = np.zeros(Bn)
    m2_a = np.zeros(Bn)
    m2_r = np.zeros(Bn)
    cov = np.zeros(Bn)
    sse = np.zeros(Bn)
    maxerr = np.zeros(Bn)
    maxobs = np.zeros(Bn)
    for p in parts:
        nj = float(np.asarray(p["n"], np.float64))
        if nj <= 0:
            continue
        c_a = np.asarray(p["c_a"], np.float64)
        c_r = np.asarray(p["c_r"], np.float64)
        s_a = np.asarray(p["sum_ac"], np.float64)
        s_r = np.asarray(p["sum_rc"], np.float64)
        mj_a = c_a + s_a / nj
        mj_r = c_r + s_r / nj
        M2j_a = np.asarray(p["sum_ac2"], np.float64) - s_a * s_a / nj
        M2j_r = np.asarray(p["sum_rc2"], np.float64) - s_r * s_r / nj
        Cj = np.asarray(p["sum_acrc"], np.float64) - s_a * s_r / nj
        nt = n + nj
        da = mj_a - mu_a
        dr = mj_r - mu_r
        w = n * nj / nt
        m2_a += M2j_a + da * da * w
        m2_r += M2j_r + dr * dr * w
        cov += Cj + da * dr * w
        mu_a += da * nj / nt
        mu_r += dr * nj / nt
        n = nt
        sse += np.asarray(p["sse"], np.float64)
        maxerr = np.maximum(maxerr, np.asarray(p["maxerr"], np.float64))
        maxobs = np.maximum(maxobs, np.asarray(p["max_abs_obs"], np.float64))
    return {
        "n": np.float64(n), "c_a": mu_a, "c_r": mu_r,
        "sum_ac": np.zeros(Bn), "sum_rc": np.zeros(Bn),
        "sum_ac2": m2_a, "sum_rc2": m2_r, "sum_acrc": cov,
        "sse": sse, "maxerr": maxerr, "max_abs_obs": maxobs,
    }
