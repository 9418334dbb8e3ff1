# -*- coding: utf-8 -*-
"""First-use XLA program budget for the canonical sweep paths.

Every DISTINCT compiled program dispatched to the default backend costs
a compile (or a compile-cache load) in every fresh process — round-4
profiling found iteration-0 overheads that scaled with the count of
eager mini-op programs (convert_element_type, broadcast_in_dim,
concatenate, dynamic_slice, ...) leaking out of the dispatch path. These
tests pin the property that the canonical sweeps compile NO anonymous
eager mini-ops: every program is an intentional, named jit (ladders,
chunk stats, the fused flat-stream build), so the budget can only grow
through deliberate changes.

Runs the sweep in a SUBPROCESS with a fresh compile cache:
jax_log_compiles only logs cache MISSES, so an in-process test would go
vacuous once other tests have compiled the same mini-ops.
"""

import os
import re
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

# named programs the canonical paths are ALLOWED to compile
_ALLOWED = {
    # case A (j2k ebcot): ladders + local-CPU pricing chain
    "quality_stats_ladder", "ql_ladder", "dwt2", "idwt2",
    "_device_ladder_sizes",
    # case B (ccsds121): ladders + device encode plan
    "spectral_stats_ladder", "chunk_stats", "_chunk_stats_slice",
    "_stack_tables", "_flat", "stack_lanes",
}


def _run_and_collect(body: str, extra_env: dict = None):
    """Run a sweep snippet in a subprocess with jax_log_compiles and
    return {program_name: count}."""
    script = textwrap.dedent("""
        import os, sys, tempfile
        from pathlib import Path
        import numpy as np
        sys.path.insert(0, %r)
        import jax
        import tpukit
        from tpukit.hostinfo import local_cpu_device
        jax.config.update("jax_default_device", local_cpu_device())
        jax.config.update("jax_log_compiles", True)
        from tpukit.cli.main import run_codec_main
        from tpukit.io import tiff, write_manifest
        rng = np.random.default_rng(7)
        work = Path(tempfile.mkdtemp(prefix="pb_"))
    """ % str(Path(__file__).resolve().parent.parent)) + textwrap.dedent(body)
    with tempfile.TemporaryDirectory(prefix="pb_cache_") as cache:
        env = dict(os.environ)
        env["JAX_COMPILATION_CACHE_DIR"] = cache
        env.update(extra_env or {})
        r = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=560)
    assert r.returncode == 0, r.stderr[-2000:]
    counts: dict = {}
    for m in re.finditer(r"Compiling jit\(([^)]+)\)", r.stderr):
        counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    assert counts, "no compile logs captured — log plumbing broke"
    return counts


def _check_budget(counts: dict):
    stray = {k: v for k, v in counts.items() if k not in _ALLOWED}
    assert not stray, (f"unbudgeted eager programs compiled: {stray} — an "
                       f"eager op leaked into the sweep path")


def test_casea_j2k_program_budget():
    counts = _run_and_collect("""
        gy, gx = np.mgrid[0:64, 0:64]
        t = (((40 + 3 * gy + 2 * gx) % 4096).astype(np.uint16) << 4)
        p = work / "t.tif"
        tiff.write_geotiff(p, np.stack([t, t >> 1]), blockxsize=32,
                           blockysize=32)
        idx = work / "i.json"
        write_manifest(idx, "caseA", "tile_64",
                       [{"tile_id": "T", "path": p}])
        run_codec_main(["--indices", str(idx), "--codec", "j2k",
                        "--rate-key", "quality", "--rates", "10", "40",
                        "--reps", "2", "--outdir", str(work / "r"),
                        "--keep-bitstream"])
    """)
    _check_budget(counts)


def test_caseb_ccsds121_program_budget():
    counts = _run_and_collect("""
        from tpukit.codecs.registry import create
        from tpukit.sweep.runner import SweepConfig, run_sweep
        base = rng.integers(200, 1800, (64, 64)).astype(np.int32)
        cube = (base[None] + rng.integers(-9, 9, (12, 64, 64))) \\
            .astype(np.int16)
        cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)
        p = work / "t.tif"
        tiff.write_geotiff(p, cube)
        idx = work / "i.json"
        write_manifest(idx, "caseB", "tile_64",
                       [{"tile_id": "T", "path": p}])
        # plan_chunk shrunk so every 12k-sample tile stream exercises the
        # device-plan path (_flat + _chunk_stats_slice + _stack_tables);
        # tile=32 over a 64x64 cube gives FOUR tile positions, pinning
        # that the fused flat-stream program traces its offsets (one
        # program per tile SHAPE, not per position)
        codec = create("ccsds121", tile=32, interleave="bip",
                       preproc="none", nbit=16, plan_chunk=4096)
        run_sweep(SweepConfig(indices=idx, codec=codec,
                              codec_label="ccsds121", outdir=work / "r",
                              rate_key="none", reps=2))
    """)
    _check_budget(counts)
    # the device-plan path actually engaged (chunked program + batched
    # table fetch), so the budget covers the canonical program set
    assert "_flat" in counts and "_stack_tables" in counts
    # four tile positions share ONE fused flat-stream program
    assert counts["_flat"] == 1, counts


def test_mesh_program_budget():
    """The mesh metric path (round-robin single-lane dispatch) must
    compile the same named-program set as the single-device path — its
    per-device context building and lane staging go through device_put,
    never eager ops."""
    counts = _run_and_collect("""
        gy, gx = np.mgrid[0:64, 0:64]
        t = (((40 + 3 * gy + 2 * gx) % 4096).astype(np.uint16) << 4)
        p = work / "t.tif"
        tiff.write_geotiff(p, np.stack([t, t >> 1]), blockxsize=32,
                           blockysize=32)
        idx = work / "i.json"
        write_manifest(idx, "caseA", "tile_64",
                       [{"tile_id": "T", "path": p}])
        run_codec_main(["--indices", str(idx), "--codec", "j2k",
                        "--rate-key", "quality", "--rates", "10", "40",
                        "--reps", "1", "--outdir", str(work / "r"),
                        "--keep-bitstream", "--mesh", "2"])
    """, extra_env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    _check_budget(counts)
