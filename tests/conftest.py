# -*- coding: utf-8 -*-
"""Test configuration: run JAX on a virtual 8-device CPU mesh so the
multi-chip sharding paths compile and execute without an accelerator.

The default device is pinned to the CPU as well (parts of the code, e.g.
sweep._build_mesh, key off it), so a session that also enables the GPU
platform — ``JAX_PLATFORMS=cpu,cuda`` for the card-only tier in
tests/test_gpu_smoke.py — still runs every other test on the CPU.
"""

import os

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_default_device", jax.devices("cpu")[0])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without one "
                   "(python chip_smoke.py runs these checks on the card)")


def _raise_max_map_count(target: int = 262144) -> None:
    """One pytest process JIT-loads every XLA:CPU executable the suite
    compiles — including one mini-executable per eager op shape, times 8
    virtual devices — at ~3 mappings each. Measured: the full suite needs
    >65530 maps, the kernel's default vm.max_map_count, and crossing the
    ceiling segfaults inside XLA's executable load (mmap failure surfaces
    as a strlen on a garbage pointer). Raise the knob when we can (CI box
    runs as root); otherwise the suite must be run in parts."""
    path = "/proc/sys/vm/max_map_count"
    try:
        with open(path) as f:
            cur = int(f.read().strip())
        if cur < target:
            with open(path, "w") as f:
                f.write(str(target))
    except (OSError, PermissionError, ValueError):
        import warnings
        warnings.warn("could not raise vm.max_map_count; a full-suite run "
                      "may exhaust memory maps (see conftest)")


_raise_max_map_count()

# Persistent, CPU-feature-fingerprinted compile cache for the suite (or
# JAX_COMPILATION_CACHE_DIR verbatim when set). Two reasons: (a) one
# pytest process jit-compiles ~300 programs, and the accumulated
# in-process LLVM/JIT state has produced late-suite compile segfaults —
# loading previously compiled executables sidesteps most of that; (b) on
# migratable VMs, cache entries from another boot's CPU feature set can
# SIGILL when loaded, so the fingerprint keeps them unreachable instead.
if os.environ.get("TPUKIT_TEST_JAX_CACHE", "1") != "0":
    from tpukit.hostinfo import configure_jax_compile_cache, \
        cpu_feature_fingerprint

    configure_jax_compile_cache(
        None if os.environ.get("JAX_COMPILATION_CACHE_DIR")
        else os.path.join(os.path.dirname(__file__), "..",
                          ".jax_cache_tests", cpu_feature_fingerprint()))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def tile_caseA(rng):
    """Small Case A-like tile: 4-band uint16, 12-in-16 packed."""
    x = rng.integers(0, 4096, size=(4, 64, 64), dtype=np.uint16)
    return (x << 4).astype(np.uint16)


@pytest.fixture
def tile_caseB(rng):
    """Small Case B-like cube: 12-band int16, 14-in-16 packed (2 zero LSBs)."""
    x = rng.integers(-2048, 2047, size=(12, 32, 32)).astype(np.int16)
    return ((x.view(np.uint16) >> 2) << 2).view(np.int16)
