# -*- coding: utf-8 -*-
"""Process measurement from /proc (sweep/proc.py): RSS/USS readers, the
in-process sampler, and the subprocess launcher's environment."""

import sys

from tpukit.sweep import proc


def test_rss_and_uss_readers():
    rss = proc.rss_bytes()
    uss = proc.uss_bytes()
    assert rss > 10 << 20          # a Python process with numpy + jax
    assert 0 < uss <= rss


def test_memory_sampler_sees_allocation_per_phase():
    import numpy as np

    with proc.MemorySampler(interval_s=0.001) as ms:
        with proc.mem_phase("comp"):
            big = np.ones(64 << 20, np.uint8)     # 64 MiB, touched
            ms.sample_now()
            del big
    assert ms.peak_bytes >= 64 << 20
    assert ms.phase_peak_bytes("comp") >= 64 << 20
    assert ms.phase_peak_bytes("dec") == ms.peak_bytes   # no samples


def test_run_and_measure_child_env_and_tree_peak(monkeypatch):
    """Children never get the parent's accelerator platform, and the peak
    covers the child's memory."""
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    code = ("import os, time; b = bytearray(96 << 20); "
            "print(os.environ['JAX_PLATFORMS'], "
            "os.environ['OMP_NUM_THREADS']); time.sleep(0.3)")
    elapsed, peak, out, err, rc = proc.run_and_measure(
        [sys.executable, "-c", code], poll_interval=0.01)
    assert rc == 0, err
    assert out.split() == ["cpu", "1"]
    assert peak is not None and peak >= 96 << 20
    assert elapsed > 0.3
