# -*- coding: utf-8 -*-
"""Sweep runner: the central benchmark harness.

tpukit's redesign of reference tools/run_codec.py:374-670. The reference
spends its time in per-(tile, rate, rep) subprocesses and numpy passes;
here the whole sweep is restructured around the device:

  * each tile cube is uploaded to HBM ONCE and closed over by the metric
    programs (the reference re-reads + re-copies it per (rate, rep),
    run_codec.py:472-529);
  * the rate ladder goes through ``Codec.sweep_rates``, which transform
    codecs override to amortize the device DWT across every rate point;
  * reconstructions from device codecs STAY on device (fetched only when
    recon.tif artifacts are requested), and all (rate × rep) metric
    reductions run as one vmapped device program per tile with a single
    stacked fetch — HONEST reps by default: every rep runs its own
    metric lane (identical content uploads once per group);
    ``dedupe_reps`` opts into one shared lane per rate;
  * quicklooks are generated from the in-memory arrays (same file
    contract as the reference's path-based flow, quicklooks.py:76-207).

The CSV outputs, directory layout, link model, resume semantics, and
quicklook artifacts match the reference contract:

  * outdir/<tile_id>/<rate_slug>/rep_XX/ with recon.tif, bit/, quicklook
    TIFs (reference :474-483)
  * resume: existing recon.tif is reused, wrapper timing zeroed (:489-492)
  * metrics.csv + metrics_mean.csv (csvio module)
  * link/E2E time accounting (:540-559)
"""

from __future__ import annotations

import math
import sys
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from tpukit.codecs.base import Codec, RateSpec
from tpukit.io import tiff
from tpukit.io.bitdepth import effective_data_range
from tpukit.io.manifest import guess_mask_path, load_indices
from tpukit.metrics.link import link_for_case
from tpukit.sweep import csvio
from tpukit.sweep.proc import MemorySampler


def log(s: str):
    print(s, flush=True, file=sys.stderr)


def rate_slug(rate_key: Optional[str], r) -> str:
    """'norate' or '<key>_<value-with-p>' (reference run_codec.py:474)."""
    if rate_key is None or rate_key == "none":
        return "norate"
    return str(rate_key).replace(" ", "") + "_" + str(r).replace(".", "p")


@dataclass
class SweepConfig:
    indices: Path
    codec: Codec
    codec_label: str
    outdir: Path
    rate_key: str = "none"
    rates: Optional[Sequence] = None
    reps: int = 1
    keep_bitstream: bool = False
    write_artifacts: bool = True          # recon.tif + quicklooks on disk
    quicklooks: bool = True
    ql_rgb: bool = False
    ql_err_global: int = 255
    ql_err_zoom: Optional[int] = None
    case: Optional[str] = None
    asset: Optional[str] = None
    link_mbps: Optional[float] = None
    link_eff: Optional[float] = None
    csv_decimal: str = ","
    # per-run CSV path override (reference run_codec.py:402: --single-csv;
    # metrics_mean.csv is written next to it)
    single_csv: Optional[Path] = None
    codec_opts: Dict[str, object] = field(default_factory=dict)
    # "dp" or "dp,sp": shard the (rates × reps) metric ladder over a
    # device mesh (tpukit/parallel/mesh.py) of the default device's
    # platform (SURVEY §2.3 item 3).
    mesh: Optional[str] = None
    # scene streaming: explicit rows-per-strip, or None for automatic
    # (items over stream_auto_bytes stream when the codec is strip-exact);
    # see sweep/streaming.py
    stream_rows: Optional[int] = None
    stream_auto_bytes: int = 1 << 30
    # rep semantics. False (default, the reference's workload definition,
    # run_codec.py:472-475): every rep re-executes the codec rate points
    # and its own metric lane, so per-rep timings are independent and the
    # *_iqr aggregates are meaningful. True: deterministic-output
    # deduplication — reps of an identical point reuse the first rep's
    # (streams, recon, timings) and all fresh reps of a rate share one
    # metric lane (faster; *_iqr structurally zero). Either way artifact
    # FILES are identical, and rep replicas are written as hardlinks
    # (content is a pure function of (cube, recon) for every codec here).
    dedupe_reps: bool = False


def _build_mesh(spec: str):
    import jax
    from tpukit.parallel.mesh import make_mesh

    parts = [int(v) for v in str(spec).split(",") if v != ""]
    dp = parts[0]
    sp = parts[1] if len(parts) > 1 else 1
    n = dp * sp
    # one PLATFORM for the whole mesh: the default device's (test sessions
    # pin jax_default_device to the virtual CPU backend). Mixing platforms
    # across mesh sizes would compare f32 results across hardware, so a
    # short platform is an error, never a silent move to another one.
    dflt = jax.config.jax_default_device
    platform = dflt.platform if dflt is not None else jax.default_backend()
    devices = jax.devices(platform)
    if len(devices) < n:
        raise ValueError(f"--mesh {spec} needs {n} {platform} devices, "
                         f"have {len(devices)}")
    return make_mesh(devices[:n], dp=dp, sp=sp)


def _normalize_rates(rate_key: str, rates) -> List:
    if rate_key == "none":
        return [None]
    out = []
    for r in (rates or []):
        if isinstance(r, float) or isinstance(r, np.floating):
            # API callers pass real floats (the CLI passes strings);
            # integral floats collapse to int so run-dir slugs match the
            # CLI's, fractional ones MUST stay fractional
            out.append(int(r) if float(r).is_integer() else float(r))
        elif isinstance(r, (int, np.integer)):
            out.append(int(r))
        else:
            try:
                if isinstance(r, str) and ("." in r or "e" in r.lower()):
                    out.append(float(r))
                else:
                    out.append(int(r))
            except (TypeError, ValueError):
                out.append(float(r))
    return out


def resume_recon(run_dir: Path, write_artifacts: bool, log,
                 load: bool = False, cache: Dict | None = None):
    """Shared resume probe for the batched and streaming paths
    (reference run_codec.py:489-492 semantics): a (tile, rate, rep) run
    is reused iff artifacts are on AND its recon.tif both exists and
    parses as a TIFF — an interrupted writer can leave a headerless/
    IFD-less file behind, which must re-encode, not wedge every retry.
    Returns ``(reused, recon_or_None, bs_bytes_or_None)``; with
    ``load=True`` the recon cube is read (deduped across hardlinked rep
    replicas via the inode cache, so resuming R reps of a deterministic
    codec holds ONE copy, not R)."""
    recon_path = run_dir / "recon.tif"
    if not (write_artifacts and recon_path.exists()):
        return False, None, None
    recon = None
    try:
        with tiff.open(recon_path) as rds:
            if load:
                st = recon_path.stat()
                key = (st.st_dev, st.st_ino)
                recon = None if cache is None else cache.get(key)
                if recon is None:
                    recon = rds.read()
                    if cache is not None:
                        cache[key] = recon
    except Exception as e:
        log(f"[WARN] Ignoring unreadable reconstruction "
            f"{recon_path} ({e}); re-encoding")
        return False, None, None
    log(f"[SKIP] Reusing reconstruction: {recon_path}")
    bs_bytes = None
    bit_dir = run_dir / "bit"
    if bit_dir.exists():
        bs_bytes = sum(p.stat().st_size for p in bit_dir.rglob("*")
                       if p.is_file())
    return True, recon, bs_bytes


def _pick_rgb_order(ds: tiff.Dataset, case_key: str) -> List[int]:
    """Case B picks RGB bands nearest λ 665/560/490 nm from band
    descriptions (reference run_codec.py:220-229); Case A uses [3,2,1]."""
    if case_key not in ("caseb", "b"):
        return [3, 2, 1]
    import re
    lams = []
    for d in (ds.descriptions or ()):
        m = re.search(r"lambda_nm\s*=\s*([0-9.]+)", d or "")
        lams.append(float(m.group(1)) if m else np.nan)
    arr = np.asarray(lams, float)
    if arr.size == 0 or not np.isfinite(arr).any():
        return [3, 2, 1]
    def nb(t):
        return int(np.nanargmin(np.abs(arr - t))) + 1
    return [nb(665.0), nb(560.0), nb(490.0)]


@dataclass
class _Job:
    """One (rate, rep) execution slot of the sweep."""
    ri: int
    rep: int
    run_dir: Path
    reused: bool = False
    meta: Dict[str, object] = field(default_factory=dict)
    t_wrap: float = 0.0
    bs_bytes: Optional[int] = None
    recon: object = None        # np.ndarray (host) or jax.Array (device)
    bitstreams: Optional[Dict[str, bytes]] = None
    met_index: int = -1         # lane in the tile's metric stack
    art_index: int = -1         # artifact-content group (hardlink sharing)


def hbm_peak_bytes() -> Optional[int]:
    """Accelerator HBM peak of this process from device.memory_stats()
    (None when the backend exposes no stats, e.g. CPU) — the device
    analog of the reference's psutil peak-RSS poll
    (proc_metrics.py:93-106)."""
    try:
        import jax
        ms = jax.local_devices()[0].memory_stats()
        v = (ms or {}).get("peak_bytes_in_use")
        return int(v) if v else None
    except Exception:
        return None


def _metric_chunk(B: int, H: int, W: int) -> int:
    """Recon lanes per metric launch, bounding f32 working set ≈ 2 GiB."""
    per_lane = B * H * W * 4 * 8  # ~8 f32 temporaries per lane worst case
    return max(1, int((2 << 30) // max(per_lane, 1)))


from functools import lru_cache


@lru_cache(maxsize=None)
def _ql_ladder_fn():
    """Device quicklook-error-map ladder: per lane, recon-side validity +
    max|Δ|-across-bands + uint8 transfer via a host-built LUT (bit-exact to
    viz.quicklooks.error_max8_from_arrays at fixed caps). Fetch cost per
    lane is C (H, W) uint8 maps — the validity masks are NOT downloaded;
    the artifact phase rederives them from the recon it fetches anyway
    (same integer formula, so bit-exact)."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnames=("has_nodata",))
    def ql_ladder(ref, recons, src_valid, nodata, lut, has_nodata: bool):
        def one(t):
            if has_nodata:
                rec_ok = jnp.all(t != nodata, axis=0)
            else:
                rec_ok = jnp.ones(t.shape[-2:], bool)
            v = src_valid & rec_ok
            err = jnp.max(jnp.abs(t.astype(jnp.int32) - ref.astype(jnp.int32)),
                          axis=0)
            err = jnp.where(v, err, 0)
            return lut[:, jnp.clip(err, 0, lut.shape[1] - 1)]   # (C, H, W)
        return jax.vmap(one)(recons)

    return ql_ladder


_STACK_LANES = None


def _stack_lanes_jit(jax, jnp):
    """Lazily-jitted lane stacker (one compiled program per lane count)."""
    global _STACK_LANES
    if _STACK_LANES is None:
        def stack_lanes(*xs):
            return jnp.stack(xs)
        _STACK_LANES = jax.jit(stack_lanes)
    return _STACK_LANES


def _device_pass_dispatch(jax, jnp, ref_dev, vm_dev, sam_vm_dev, lanes,
                          chunk, nod_val, has_nodata, is_caseb,
                          quality_stats_ladder, spectral_stats_ladder,
                          src_valid=None, ql_caps=(), want_recon=False,
                          ref_host=None, lane_groups=None):
    """Launch the single-device ladder — metrics (+ quicklook error maps +
    recon stacks when artifacts are requested) as one vmapped launch set
    per chunk — and START the device->host copies (copy_to_host_async).
    Nothing here blocks on the device: the returned chunk states are
    consumed by :func:`_device_pass_finalize`, so a caller can overlap the
    transfers with the next tile's codec phase (the reference computes
    each pair serially on host and re-reads files per rep,
    run_codec.py:472-529).

    ``lane_groups`` (optional, parallel to ``lanes``): lanes sharing a
    group id carry byte-identical content (the same invariant the
    hardlinked artifact replicas rely on — honest reps of a
    deterministic codec). Each group's bytes are UPLOADED once and the
    stack is assembled on device; the metric/quicklook programs still
    execute once per lane, so rep metrics remain independent executions
    — only the redundant host->device transfer is elided."""
    # nod_val is a numpy scalar; the jitted ladders device_put it at call
    # time. An eager jnp.asarray here would compile a tiny
    # convert_element_type program on the default backend.
    nod = nod_val
    want_ql = bool(ql_caps) and bool(lanes) and not jnp.issubdtype(
        lanes[0].dtype, jnp.floating)
    if want_ql:
        from tpukit.viz.quicklooks import err8_lut
        lut_dev = jnp.asarray(np.stack([err8_lut(c) for c in ql_caps]))
        sv_dev = jnp.asarray(src_valid)
        ql_fn = _ql_ladder_fn()

    def lane_dev(x):
        # a host recon bit-identical to the reference (verified-lossless
        # codecs) reuses the already-uploaded ref instead of re-shipping
        # the same bytes over the host link
        if (isinstance(x, np.ndarray) and ref_host is not None
                and x.shape == ref_host.shape and x.dtype == ref_host.dtype
                and np.array_equal(x, ref_host)):
            return ref_dev
        return x

    group_buf: Dict[int, object] = {}

    def staged_lane(i: int):
        x = lanes[i]
        if lane_groups is None:
            return lane_dev(x)
        g = lane_groups[i]
        buf = group_buf.get(g)
        if buf is None:
            buf = lane_dev(x)
            if isinstance(buf, np.ndarray):
                # one explicit transfer per content group; repeated
                # lanes then reference the same device buffer
                buf = jax.device_put(buf)
            group_buf[g] = buf
        return buf

    chunks = []
    for c0 in range(0, len(lanes), chunk):
        batch = lanes[c0:c0 + chunk]
        staged = [staged_lane(c0 + i) for i in range(len(batch))]
        uniq = len({id(s) for s in staged})
        if all(isinstance(x, np.ndarray) for x in staged) \
                and uniq == len(staged):
            # all-host distinct lanes: stage the stack on host and ship
            # it as ONE upload. An eager jnp.stack here compiles
            # broadcast_in_dim + concatenate programs on the default
            # backend and uploads lane by lane.
            stack = jnp.asarray(np.stack(staged))
        else:
            # device-resident and/or group-shared lanes: upload each
            # distinct buffer once (device_put inside the jit) and
            # assemble the stack on device — duplicate-content lanes
            # cost no extra transfer (one jitted program instead of
            # eager stack's broadcast_in_dim + concatenate pair)
            stack = _stack_lanes_jit(jax, jnp)(*staged)
        qs = quality_stats_ladder(ref_dev, stack, vm_dev, nod, has_nodata)
        payload = {"qs": qs}
        if want_ql:
            payload["ql"] = ql_fn(ref_dev, stack, sv_dev, nod, lut_dev,
                                  has_nodata)
        # fetch only DEVICE-resident recons; host-array lanes (in-place
        # codecs) must not round-trip their cubes over the host link
        fetch_ix = ([i for i, x in enumerate(batch)
                     if not isinstance(x, np.ndarray)]
                    if want_recon else [])
        if fetch_ix:
            payload["recon"] = [batch[i] for i in fetch_ix]
        ss_err = None
        if is_caseb:
            # warn-and-continue on SAM/SID/LMSE failure (§5.3 policy,
            # reference run_codec.py:523-531); execution-time failures are
            # caught again at finalize
            try:
                payload["ss"] = spectral_stats_ladder(ref_dev, stack,
                                                      sam_vm_dev)
            except Exception as e:
                ss_err = e
        for leaf in jax.tree_util.tree_leaves(payload):
            try:
                leaf.copy_to_host_async()
            except Exception:
                pass        # fetch still happens (blocking) at finalize
        chunks.append({"payload": payload, "batch": batch,
                       "fetch_ix": fetch_ix, "ss_err": ss_err})
    return chunks


def _device_pass_finalize(jax, chunks, data_range, is_caseb,
                          assemble_quality_many, assemble_spectral_many,
                          want_recon=False):
    """Block on the chunk transfers started by :func:`_device_pass_dispatch`
    and assemble (met_rows, lane_art); lane_art[i] is a per-lane dict with
    host 'recon', 'e8' (C,H,W uint8), 'ql_valid', 'rec_ok' (entries None
    when not requested)."""
    met_rows: List[Dict[str, float]] = []
    lane_art: List[Dict[str, object]] = []
    for ch in chunks:
        payload = ch["payload"]
        batch = ch["batch"]
        sams = None
        try:
            host = jax.device_get(payload)
        except Exception as e:
            if is_caseb and "ss" in payload:
                log(f"[WARN] SAM/SID/LMSE failed: {e}")
                host = jax.device_get(
                    {k: v for k, v in payload.items() if k != "ss"})
            else:
                raise
        if is_caseb:
            if "ss" in host:
                sams = assemble_spectral_many(host["ss"])
            elif ch["ss_err"] is not None:
                log(f"[WARN] SAM/SID/LMSE failed: {ch['ss_err']}")
        if sams is None:
            sams = [{"sam_deg": float("nan"), "sid": float("nan"),
                     "lmse": float("nan")} for _ in range(len(batch))]
        mets = assemble_quality_many(host["qs"], float(data_range))
        for m, s in zip(mets, sams):
            m.update(s)
        met_rows.extend(mets)
        fetched = dict(zip(ch["fetch_ix"], host.get("recon", [])))
        want_ql = "ql" in host
        for i in range(len(batch)):
            recon_h = fetched.get(i, batch[i]) if want_recon else None
            lane_art.append({
                "recon": recon_h,
                "e8": host["ql"][i] if want_ql else None,
                # masks rederived host-side from the fetched recon
                "ql_valid": None,
                "rec_ok": None,
            })
    return met_rows, lane_art


def _link_tree(src: Path, dst: Path):
    """Replicate a finished run_dir as hardlinks (artifact content is
    identical across reps of a deterministic codec; a byte copy per rep
    would triple the sweep's disk traffic)."""
    import os
    import shutil
    dst.mkdir(parents=True, exist_ok=True)
    for p in src.iterdir():
        q = dst / p.name
        if p.is_dir():
            _link_tree(p, q)
        else:
            q.unlink(missing_ok=True)
            try:
                os.link(p, q)
            except OSError:
                shutil.copyfile(p, q)


def build_csv_row(*, case_name, asset_name, codec_label, rk, r, tile_id,
                  W: int, H: int, B: int, container_bytes: int,
                  raw16_bytes: int, link, t_wrap: float, meta: Dict,
                  bs_bytes, met: Dict) -> Dict[str, object]:
    """One metrics.csv row from a finished (tile, rate, rep) job — shared
    by the batched and streaming paths (schema: reference
    run_codec.py:568-585)."""
    row: Dict[str, object] = {
        "case": case_name, "asset": asset_name,
        "codec": codec_label,
        "rate_key": (rk or ""),
        "rate_value": ("" if rk is None else r),
        "tile_id": tile_id,
        "width": W, "height": H, "bands": B,
        "in_bytes": container_bytes,
        "link_mbps": link.mbps, "link_eff": link.eff,
        "t_wrap_s": t_wrap,
    }
    for k in ("bitstream_bytes", "cr", "bpp", "t_comp_s",
              "t_dec_s", "mem_comp_peak_mb", "mem_dec_peak_mb",
              "encoder", "nearlossless_eps", "near",
              "mem_comp_peak_bytes", "mem_dec_peak_bytes"):
        if k in meta and meta[k] is not None:
            row[k] = meta[k]
    if bs_bytes and bs_bytes > 0:
        row["bitstream_bytes"] = int(bs_bytes)
        row["bpp"] = (bs_bytes * 8.0) / (W * H * B)
        row["cr"] = raw16_bytes / bs_bytes
        row["t_link_tile_s"] = link.t_link_s(bs_bytes)
        row["t_e2e_tile_s"] = link.t_e2e_s(
            bs_bytes, meta.get("t_comp_s"), meta.get("t_dec_s"), t_wrap)
    row.update(met)
    return row


def _write_artifacts_phase(cfg: "SweepConfig", jobs: Dict[tuple, "_Job"],
                           lanes: List[object], lane_art, ql_caps: List[int],
                           *, cube: np.ndarray, geo, nodata, has_nodata: bool,
                           src_mask: np.ndarray, src_valid: np.ndarray,
                           rgb_order: List[int], descriptions,
                           mask_passthrough: bool):
    """Artifacts + quicklooks from in-memory data: one threaded render per
    lane, hardlinked replicas for the other reps (a deterministic codec's
    artifact content is a pure function of (cube, recon) — only the phase-1
    timings differ per rep, and those live in the CSV, not in artifacts).
    Same file contract as the reference's path-based flow
    (run_codec.py:474-520, quicklooks.py:76-207)."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    from tpukit.viz import quicklooks as ql

    B, H, W = cube.shape
    rgb_ix = [i - 1 for i in rgb_order]
    ql_params = None
    if cfg.quicklooks and cfg.ql_rgb and B >= 3:
        ql_params = ql.stretch_params_from_arrays(
            cube[rgb_ix].astype(np.float32), src_valid)

    def lane_host(idx: int) -> Dict[str, object]:
        """Host-side artifact inputs for one lane; fills anything the
        device pass didn't provide (mesh mode, float cubes)."""
        art = lane_art[idx] if lane_art is not None else None
        if art is None or art.get("recon") is None:
            art = {"recon": np.asarray(lanes[idx]), "e8": None,
                   "ql_valid": None, "rec_ok": None}
        if cfg.quicklooks and ql_caps and art.get("e8") is None:
            recon_host = art["recon"]
            rec_ok = (np.all(recon_host != nodata, axis=0) if has_nodata
                      else np.ones((H, W), bool))
            v = src_valid & rec_ok
            e8s = [ql.error_max8_from_arrays(cube, recon_host, v, cap)[0]
                   for cap in ql_caps]
            art.update({"e8": np.stack(e8s), "ql_valid": v, "rec_ok": rec_ok})
        return art

    # group jobs by artifact CONTENT (per-rate for fresh jobs, per-array
    # for resumed ones): one render + N-1 hardlink replicas. Distinct
    # from the metric-lane grouping — honest reps run one metric lane
    # per (rate, rep) but their artifact bytes are still identical.
    by_lane: Dict[int, List[_Job]] = {}
    for (_ri, _rep), job in sorted(jobs.items()):
        by_lane.setdefault(job.art_index, []).append(job)

    def render(job: "_Job"):
        art = lane_host(job.met_index)
        recon_host = np.asarray(art["recon"])
        run_dir = job.run_dir
        run_dir.mkdir(parents=True, exist_ok=True)
        if not job.reused:
            tiff.write_geotiff(
                run_dir / "recon.tif", recon_host, nodata=nodata, geo=geo,
                descriptions=descriptions,
                # validity-mask passthrough (ccsds123_wrap.py:279-283)
                mask=(src_mask if mask_passthrough else None))
            import shutil
            bit_dir = run_dir / "bit"
            # fresh encode owns the dir: drop stale files from an
            # interrupted earlier run so resume's byte sum stays exact —
            # also when this run keeps no bitstreams (a stale bit/ next
            # to a fresh recon would corrupt a later resume's byte sum)
            shutil.rmtree(bit_dir, ignore_errors=True)
            if cfg.keep_bitstream and job.bitstreams:
                bit_dir.mkdir(parents=True, exist_ok=True)
                for name, data in job.bitstreams.items():
                    (bit_dir / name).write_bytes(data)
                job.bitstreams = None
        # quicklooks (reference run_codec.py:511-520 — regenerated on every
        # pass, including resumed reconstructions)
        if cfg.quicklooks:
            try:
                rec_ok = art.get("rec_ok")
                if rec_ok is None and (ql_params is not None
                                       or art.get("e8") is not None):
                    # rederive from the fetched recon (bit-exact to the
                    # device formula — integer compares)
                    rec_ok = (np.all(recon_host != nodata, axis=0)
                              if has_nodata else np.ones((H, W), bool))
                if ql_params is not None:
                    ql.write_rgb_8bit_arrays(
                        cube[rgb_ix], run_dir / "baseline_RGB8.tif",
                        ql_params, geo=geo, mask=src_mask)
                    ql.write_rgb_8bit_arrays(
                        recon_host[rgb_ix], run_dir / "recon_RGB8.tif",
                        ql_params, geo=geo,
                        mask=np.asarray(rec_ok, np.uint8) * 255)
                if art.get("e8") is not None:
                    v = art.get("ql_valid")
                    if v is None:
                        v = src_valid & rec_ok
                    v = np.asarray(v)
                    for cap, e8 in zip(ql_caps, np.asarray(art["e8"])):
                        ql._write_err_tif(
                            run_dir / f"recon_ERR8_0_{int(cap)}.tif",
                            np.asarray(e8), v, geo)
            except Exception as e:
                log(f"[WARN] Quicklooks failed in {run_dir}: {e}")
        job.recon = None

    # reused jobs always render individually: their run_dirs already hold
    # arbitrary on-disk state (recon, bit/, older quicklooks) that a
    # replica hardlink pass must never mix with another rep's files —
    # only fresh jobs (identical content by construction) become replicas
    primaries = [js[0] for js in by_lane.values()] + \
        [j for js in by_lane.values() for j in js[1:] if j.reused]
    replicas = [(js[0], j) for js in by_lane.values()
                for j in js[1:] if not j.reused]
    nthread = min(8, os.cpu_count() or 1, max(1, len(primaries)))
    if nthread > 1:
        with ThreadPoolExecutor(max_workers=nthread) as pool:
            list(pool.map(render, primaries))
    else:
        for j in primaries:
            render(j)
    for src_job, dst_job in replicas:
        # replica dirs may hold stale bit/ files (differently named, so
        # _link_tree's same-name unlink would miss them) from an
        # interrupted earlier run — the fresh replica owns the dir
        import shutil
        shutil.rmtree(dst_job.run_dir / "bit", ignore_errors=True)
        _link_tree(src_job.run_dir, dst_job.run_dir)
        dst_job.bitstreams = None
        dst_job.recon = None


def run_sweep(cfg: SweepConfig) -> Dict[str, object]:
    import os
    import time as _time
    import jax
    import jax.numpy as jnp
    _timing = bool(os.environ.get("TPUKIT_TIMING"))
    from tpukit.metrics.quality import (assemble_quality_many,
                                        quality_stats_ladder)
    from tpukit.metrics.spectral import (assemble_spectral_many,
                                         spectral_stats_ladder)

    outdir = Path(cfg.outdir).resolve()
    outdir.mkdir(parents=True, exist_ok=True)

    case_name, asset_name, items = load_indices(Path(cfg.indices))
    if cfg.case:
        case_name = cfg.case
    if cfg.asset:
        asset_name = cfg.asset
    case_key = str(case_name).lower()
    is_caseb = case_key in ("caseb", "b")

    link = link_for_case(case_name, cfg.link_mbps, cfg.link_eff)
    rates = _normalize_rates(cfg.rate_key, cfg.rates)
    rk = None if cfg.rate_key == "none" else cfg.rate_key
    rows: List[dict] = []
    mesh_obj = _build_mesh(cfg.mesh) if cfg.mesh else None

    # Thread-free tile overlap: each tile's phase-2 programs AND their
    # device->host copies are launched (async) right after its codec
    # phase; the tile is finalized — blocking fetch, artifacts, CSV rows —
    # only after the NEXT tile's codec phase has run, so the copies stream
    # behind that host/codec work. At most one tile is deferred, rows stay
    # in item order, and everything runs on the main thread.
    _pending_finish: List = []

    def _flush_pending():
        while _pending_finish:
            rows.extend(_pending_finish.pop(0)())

    try:
        for item in items:
            tile_id = item["tile_id"]
            src_path: Path = item["path"]
            if not Path(src_path).exists():
                raise FileNotFoundError(f"Missing {src_path}")
            ds = tiff.open(src_path)
            W, H, B = ds.width, ds.height, ds.count
            dtype_name = ds.dtypes[0]

            # scene-scale items stream in bounded host memory (strip-exact
            # codecs only; reference wrappers window scenes into 512² tiles,
            # ccsds121_wrap.py:170-219)
            from tpukit.sweep.streaming import stream_plan, sweep_item_streaming
            itemsize = 2 if dtype_name in ("uint16", "int16") else 1
            rows_blk = stream_plan(cfg.codec, H, W, B, itemsize,
                                   cfg.stream_rows, cfg.stream_auto_bytes)
            if rows_blk is not None:
                log(f"[STREAM] {tile_id}: {H}x{W}x{B} in {rows_blk}-row strips")
                _flush_pending()
                rows.extend(sweep_item_streaming(
                    cfg, ds, item, rates, rk, is_caseb, link, rows_blk,
                    case_name=case_name, asset_name=asset_name))
                ds.close()
                continue

            cube = ds.read()
            src_mask = ds.dataset_mask()
            nodata = ds.nodata
            geo = ds.geo
            rgb_order = _pick_rgb_order(ds, case_key)
            data_range = effective_data_range(cube, dtype_name)

            # user validity mask (explicit in manifest or <stem>_mask sibling)
            mask_path = item.get("mask") or guess_mask_path(src_path)
            valid_mask = None
            if mask_path and Path(mask_path).exists():
                try:
                    with tiff.open(mask_path) as m:
                        mv = m.read(1) > 0
                    if mv.shape == (H, W):
                        valid_mask = mv
                    else:
                        warnings.warn(f"Mask {mask_path} shape mismatch; ignored.")
                except Exception:
                    warnings.warn(f"Failed to read mask {mask_path}; ignored.")

            bytes_per_sample = 2 if dtype_name in ("uint16", "int16") else 1
            container_bytes = int(W * H * B * bytes_per_sample)
            raw16_bytes = int(W * H * B * 16 // 8)

            # reference-side validity components (reference run_codec.py:249-263):
            # dataset mask ∧ (every REF band != nodata) ∧ user mask. The
            # recon-side nodata exclusion is folded per lane on device.
            has_nodata = nodata is not None and math.isfinite(nodata)
            vm_base = src_mask > 0
            if has_nodata:
                vm_base = vm_base & np.all(cube != nodata, axis=0)
            if valid_mask is not None:
                vm_base = vm_base & valid_mask
            sam_vm = valid_mask if valid_mask is not None else (src_mask > 0)

            # one upload per tile; every metric program closes over these.
            # In mesh mode the inputs are device_put onto the mesh sharding
            # instead (never committed to the default backend first).
            if mesh_obj is None:
                ref_dev = jnp.asarray(cube)
                vm_dev = jnp.asarray(vm_base)
                sam_vm_dev = jnp.asarray(sam_vm) if is_caseb else None

            # ---- phase 1: execute the ladder (codec work) -------------------
            _t1 = _time.perf_counter()
            jobs: Dict[tuple, _Job] = {}
            # per-tile scratch shared across reps (e.g. ccsds121's device
            # encode plan — identical for identical input, so reps reuse it)
            tile_plan_cache: Dict[tuple, object] = {}
            resume_cache: Dict[tuple, np.ndarray] = {}
            for rep in range(cfg.reps):
                fresh_ix: List[int] = []
                for ri, r in enumerate(rates):
                    run_dir = (outdir / tile_id / rate_slug(rk, r)
                               / f"rep_{rep+1:02d}")
                    job = _Job(ri=ri, rep=rep, run_dir=run_dir)
                    # resume: reuse recon, zero wrapper timing (reference
                    # run_codec.py:489-492); hardlinked rep replicas share
                    # one host cube via the inode cache
                    reused, recon, bs = resume_recon(
                        run_dir, cfg.write_artifacts, log, load=True,
                        cache=resume_cache)
                    if reused:
                        job.recon = recon
                        job.reused = True
                        if bs is not None:
                            job.bs_bytes = bs
                    else:
                        fresh_ix.append(ri)
                    jobs[(ri, rep)] = job

                if fresh_ix:
                    specs = [RateSpec.of(rk, rates[ri]) for ri in fresh_ix]
                    # dataset context for codecs that honor it (ccsds123's
                    # nodata fast paths, reference ccsds123_wrap.py:175-229)
                    ctx = dict(cfg.codec_opts)
                    ctx.setdefault("nodata", nodata)
                    ctx.setdefault("dataset_mask", src_mask)
                    # rep semantics for codecs with point-level reuse
                    # (j2k's ladder/point caches honor this; plan-LEVEL
                    # analysis reuse stays on either way)
                    ctx.setdefault("dedupe_reps", cfg.dedupe_reps)
                    if mesh_obj is None:
                        # HBM-resident cube: codecs with device fast paths
                        # (ccsds121's parallel plan) reuse the metric upload
                        ctx.setdefault("device_cube", ref_dev)
                        ctx.setdefault("device_plan_cache", tile_plan_cache)
                    else:
                        # codec-phase sharding: codecs with mesh ladders
                        # (j2k quality ladder, ccsds122 BPE budgets) run
                        # their rate ladders over dp×sp instead of the
                        # default backend. The per-tile plan cache applies
                        # here too (ccsds121's flat stream + encode plan,
                        # j2k's tier-1 plans) so reps reuse deterministic
                        # work exactly like the single-device path
                        # (advisor r3).
                        ctx.setdefault("mesh", mesh_obj)
                        ctx.setdefault("device_plan_cache", tile_plan_cache)
                    _tr = _time.perf_counter()
                    with MemorySampler() as ms:
                        results = cfg.codec.sweep_rates(
                            cube, dtype_name, specs,
                            keep_bitstream=cfg.keep_bitstream, **ctx)
                    if _timing:
                        log(f"[TIMING] {tile_id} rep {rep}: sweep_rates "
                            f"{_time.perf_counter() - _tr:.2f}s "
                            f"(codec t_comp+t_dec "
                            f"{sum(r.t_comp_s + r.t_dec_s for r in results):.2f}s)")
                    for ri, res in zip(fresh_ix, results):
                        if res.mem_comp_peak_bytes is None:
                            res.mem_comp_peak_bytes = ms.phase_peak_bytes("comp")
                        if res.mem_dec_peak_bytes is None:
                            res.mem_dec_peak_bytes = ms.phase_peak_bytes("dec")
                        job = jobs[(ri, rep)]
                        job.recon = res.recon
                        job.meta = res.to_meta()
                        job.t_wrap = res.t_comp_s + res.t_dec_s
                        job.bs_bytes = res.bitstream_bytes
                        job.bitstreams = res.bitstreams

            # ---- lane plan ---------------------------------------------------
            # Honest reps (default): every fresh (rate, rep) job runs its
            # own metric lane — the reference computes metrics per rep
            # (run_codec.py:522-529) and the aggregate IQRs are over real
            # executions. --dedupe-reps: deterministic codecs produce
            # identical recons across reps, so fresh reps share one lane
            # per rate. Either way resumed recons (arbitrary on-disk
            # content) key on array identity, and ARTIFACT content groups
            # stay per-rate (identical bytes, hardlinked replicas).
            lane_of: Dict[tuple, int] = {}
            art_of: Dict[tuple, int] = {}
            lanes: List[object] = []
            lane_groups: List[int] = []   # content group per lane
            for (ri, rep), job in sorted(jobs.items()):
                content_key = (("reused", id(job.recon)) if job.reused
                               else ("fresh", ri))
                key = (content_key if (cfg.dedupe_reps or job.reused)
                       else ("fresh", ri, rep))
                job.art_index = art_of.setdefault(content_key,
                                                  len(art_of))
                if key not in lane_of:
                    lane_of[key] = len(lanes)
                    lanes.append(job.recon)
                    lane_groups.append(job.art_index)
                job.met_index = lane_of[key]
            # honest reps of a deterministic codec: lanes within a
            # content group are byte-identical (the hardlinked-artifact
            # invariant) — the device pass uploads each group's bytes
            # once while still executing every lane's metric programs
            share_groups = (lane_groups
                            if len(set(lane_groups)) < len(lanes)
                            else None)

            _t2 = _time.perf_counter()
            # ---- phase 2: device ladder — metrics + quicklook error maps +
            # batched recon fetch, ONE stacked transfer per chunk -------------
            chunk = _metric_chunk(B, H, W)
            met_rows: List[Dict[str, float]] = []
            nod_val = np.float32(nodata if has_nodata else 0.0)
            src_valid = src_mask > 0
            if has_nodata:
                src_valid = src_valid & (cube[0] != nodata)
            ql_caps: List[int] = []
            if cfg.write_artifacts and cfg.quicklooks:
                ql_caps.append(int(cfg.ql_err_global))
                if cfg.ql_err_zoom is not None:
                    ql_caps.append(int(cfg.ql_err_zoom))
            lane_art = None

            if mesh_obj is not None:
                # Mesh mode: per-device ROUND-ROBIN dispatch of identical
                # single-lane programs — every lane's metrics (and its
                # quicklook error maps, artifact parity with the
                # single-device pass) run the SAME compiled executable
                # regardless of the device count, so `--mesh N` CSVs and
                # artifacts are bit-identical for any N. (A
                # GSPMD-partitioned lane ladder changes the per-device
                # program SHAPE with dp — and f32 reduction tiling with
                # it; lanes are independent, so explicit data parallelism
                # over the mesh devices costs zero collectives and keeps
                # determinism. Integer ladders are immune and the library
                # GSPMD steps remain in parallel/mesh.py.)
                devs = list(mesh_obj.devices.ravel())
                want_ql = (cfg.write_artifacts and bool(ql_caps)
                           and bool(lanes)
                           and not np.issubdtype(np.dtype(str(
                               lanes[0].dtype)), np.floating))
                if want_ql:
                    from tpukit.viz.quicklooks import err8_lut
                    lut_np = np.stack([err8_lut(c) for c in ql_caps])
                    ql_fn = _ql_ladder_fn()
                if cfg.write_artifacts:
                    lane_art = []
                per_dev: Dict[object, dict] = {}
                group_rec: Dict[tuple, object] = {}
                pend = []
                for i, lane in enumerate(lanes):
                    d = devs[i % len(devs)]
                    ctx_d = per_dev.get(d)
                    if ctx_d is None:
                        ctx_d = per_dev[d] = {
                            "ref": jax.device_put(cube, d),
                            "vm": jax.device_put(vm_base, d),
                            "sam": (jax.device_put(sam_vm, d)
                                    if is_caseb else None),
                            "nod": jax.device_put(nod_val, d),
                            "sv": (jax.device_put(src_valid, d)
                                   if want_ql else None),
                            "lut": (jax.device_put(lut_np, d)
                                    if want_ql else None),
                        }
                    lane_np = np.asarray(lane)
                    # lead axis added on HOST: [None] on a device array
                    # compiles an eager broadcast_in_dim program.
                    # Honest-rep
                    # lanes of one content group (byte-identical by the
                    # hardlink invariant) share one upload per device;
                    # their metric programs still run per lane.
                    gkey = (share_groups[i] if share_groups is not None
                            else i, id(d))
                    rec = group_rec.get(gkey)
                    if rec is None:
                        rec = jax.device_put(lane_np[None], d)  # (1,B,H,W)
                        group_rec[gkey] = rec
                    qs = quality_stats_ladder(ctx_d["ref"], rec,
                                              ctx_d["vm"], ctx_d["nod"],
                                              has_nodata)
                    ss = None
                    ss_err = None
                    if is_caseb:
                        try:
                            ss = spectral_stats_ladder(ctx_d["ref"], rec,
                                                       ctx_d["sam"])
                        except Exception as e:
                            ss_err = e
                    e8 = (ql_fn(ctx_d["ref"], rec, ctx_d["sv"],
                                ctx_d["nod"], ctx_d["lut"], has_nodata)
                          if want_ql else None)
                    pend.append((lane_np, qs, ss, ss_err, e8))
                for lane_np, qs, ss, ss_err, e8 in pend:
                    met = assemble_quality_many(jax.device_get(qs),
                                                float(data_range))[0]
                    sam = {"sam_deg": float("nan"), "sid": float("nan"),
                           "lmse": float("nan")}
                    if is_caseb and ss is not None:
                        try:
                            sam = assemble_spectral_many(
                                jax.device_get(ss))[0]
                        except Exception as e:
                            ss_err = e
                    if ss_err is not None:
                        log(f"[WARN] SAM/SID/LMSE failed: {ss_err}")
                    met.update(sam)
                    met_rows.append(met)
                    if cfg.write_artifacts:
                        lane_art.append(
                            {"recon": lane_np,
                             "e8": (np.asarray(e8)[0]
                                    if e8 is not None else None),
                             "ql_valid": None, "rec_ok": None})
            else:
                chunks_state = _device_pass_dispatch(
                    jax, jnp, ref_dev, vm_dev, sam_vm_dev, lanes, chunk,
                    nod_val, has_nodata, is_caseb,
                    quality_stats_ladder, spectral_stats_ladder,
                    src_valid=src_valid, ql_caps=tuple(ql_caps),
                    want_recon=cfg.write_artifacts, ref_host=cube,
                    lane_groups=share_groups)

            descriptions = ds.descriptions
            ds.close()

            # ---- phases 3-4 as this tile's deferred finish ------------------
            def _finish(*, tile_id=tile_id, jobs=jobs, lanes=lanes,
                        lane_art=lane_art, met_rows=met_rows,
                        chunks_state=(None if mesh_obj is not None
                                      else chunks_state),
                        cube=cube, geo=geo, nodata=nodata,
                        has_nodata=has_nodata, src_mask=src_mask,
                        src_valid=src_valid, ql_caps=ql_caps,
                        rgb_order=rgb_order, descriptions=descriptions,
                        data_range=data_range, W=W, H=H, B=B,
                        container_bytes=container_bytes,
                        raw16_bytes=raw16_bytes, _t1=_t1,
                        _t2=_t2) -> List[dict]:
                if chunks_state is not None:
                    met_rows, lane_art = _device_pass_finalize(
                        jax, chunks_state, data_range, is_caseb,
                        assemble_quality_many, assemble_spectral_many,
                        want_recon=cfg.write_artifacts)
                _t3 = _time.perf_counter()
                # artifacts + quicklooks (host IO, threaded;
                # reference run_codec.py:474-520)
                if cfg.write_artifacts:
                    _write_artifacts_phase(
                        cfg, jobs, lanes, lane_art, ql_caps, cube=cube,
                        geo=geo, nodata=nodata, has_nodata=has_nodata,
                        src_mask=src_mask, src_valid=src_valid,
                        rgb_order=rgb_order, descriptions=descriptions,
                        mask_passthrough=getattr(cfg.codec, "mask_passthrough",
                                                 False))
                _t4 = _time.perf_counter()
                if _timing:
                    log(f"[TIMING] {tile_id}: codec {_t2-_t1:.2f}s device "
                        f"{_t3-_t2:.2f}s artifacts {_t4-_t3:.2f}s")
                # phase-breakdown hook (bench/SCALING): append one JSON
                # line per tile. codec_s = host codec phase (C++ coding,
                # truncation, stream decode); device_s = device metric/
                # quicklook ladders INCLUDING the un-overlapped part of
                # their transfers; artifacts_s = host artifact IO.
                pj = os.environ.get("TPUKIT_PHASE_JSON")
                if pj:
                    import json as _json
                    try:
                        with open(pj, "a") as f:
                            f.write(_json.dumps(
                                {"tile": tile_id,
                                 "codec_s": round(_t2 - _t1, 3),
                                 "device_s": round(_t3 - _t2, 3),
                                 "artifacts_s": round(_t4 - _t3, 3)})
                                + "\n")
                    except OSError:
                        pass
                # rows in canonical (rate outer, rep inner) order
                hbm = hbm_peak_bytes()
                item_rows: List[dict] = []
                for ri, r in enumerate(rates):
                    for rep in range(cfg.reps):
                        job = jobs[(ri, rep)]
                        row = build_csv_row(
                            case_name=case_name, asset_name=asset_name,
                            codec_label=cfg.codec_label, rk=rk, r=r,
                            tile_id=tile_id, W=W, H=H, B=B,
                            container_bytes=container_bytes,
                            raw16_bytes=raw16_bytes, link=link,
                            t_wrap=job.t_wrap, meta=job.meta,
                            bs_bytes=job.bs_bytes,
                            met=met_rows[job.met_index])
                        if hbm:
                            row["hbm_peak_bytes"] = hbm
                            row["hbm_peak_mb"] = round(hbm / (1 << 20), 2)
                        item_rows.append(row)
                return item_rows

            # the PREVIOUS tile finalizes now — its copies streamed behind
            # this tile's codec phase
            _flush_pending()
            defer = (mesh_obj is None
                     and sum(int(getattr(x, "nbytes", 0) or 0)
                             for x in lanes) <= (1 << 30))
            if defer:
                _pending_finish.append(_finish)
            else:                      # mesh mode / oversized ladder: inline
                rows.extend(_finish())

    except BaseException:
        # fail-fast (reference run_codec.py:494-495) — but a tile
        # whose codec work already finished keeps its artifacts
        try:
            _flush_pending()
        except Exception:
            pass
        raise
    _flush_pending()

    single_csv = (Path(cfg.single_csv).resolve() if cfg.single_csv
                  else outdir / "metrics.csv")
    single_csv.parent.mkdir(parents=True, exist_ok=True)
    metrics_csv = csvio.write_metrics_csv(single_csv, rows, cfg.csv_decimal)
    log(f"[OK] Wrote CSV: {metrics_csv.as_posix()} ({len(rows)} rows)")
    mean_csv = None
    if cfg.reps > 1 and rows:
        mean_csv = csvio.write_mean_csv(
            single_csv.with_name("metrics_mean.csv"), rows, cfg.csv_decimal)
        log(f"[OK] Wrote aggregated CSV: {mean_csv.as_posix()}")
    return {"rows": rows, "metrics_csv": metrics_csv, "mean_csv": mean_csv}
