# -*- coding: utf-8 -*-
"""Host plumbing for JAX: the persistent compile cache and the local CPU
platform.

The compile cache lives where ``JAX_COMPILATION_CACHE_DIR`` says, or at
the fixed ``<checkout>/.jax_cache``: the directory is part of what a
cache hit needs, so it never moves between runs. The CPU-feature
fingerprint keys only the test suite's CPU cache (tests/conftest.py):
on migratable VMs an XLA:CPU executable compiled under another boot's
CPU feature set can SIGILL when loaded.
"""

from __future__ import annotations

import hashlib
import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_feature_fingerprint() -> str:
    """Short stable hash of the CPU feature set visible to this boot
    (x86 'flags', aarch64 'Features', ppc 'cpu'/'model' lines — the first
    matching key of the first core)."""
    prio = {"flags": 0, "features": 1, "cpu": 2, "model name": 3}
    best = None          # (priority, normalized value)
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip().lower()
                p = prio.get(key)
                if p is not None and (best is None or p < best[0]):
                    best = (p, " ".join(sorted(set(line.split(":", 1)[1]
                                                   .split()))))
                    if p == 0:
                        break
    except OSError:
        pass
    if best is None:
        import platform
        best = (9, f"{platform.machine()} {platform.processor()}")
    return hashlib.sha256(best[1].encode()).hexdigest()[:12]


def ensure_cpu_platform() -> None:
    """Make the local CPU platform available ALONGSIDE an explicitly
    pinned accelerator platform (e.g. JAX_PLATFORMS=cuda). Must run
    before the first backend initialization.

    Why: budget-only computations (the ebcot quality→size pricing) run on
    the local CPU backend so they are deterministic across device
    topologies. The default backend is unchanged — the first platform in
    the list keeps priority."""
    import jax

    plats = (getattr(jax.config, "jax_platforms", None)
             or os.environ.get("JAX_PLATFORMS") or "")
    if plats and "cpu" not in plats.split(","):
        try:
            jax.config.update("jax_platforms", plats + ",cpu")
        except Exception:
            pass        # backends already initialized; leave as is


def local_cpu_device():
    """The first local CPU device, or None when the CPU platform is
    unavailable (backends initialized before any ensure_cpu_platform
    call, exotic builds). Self-healing: re-runs ensure_cpu_platform
    first (idempotent, config-only) so callers in processes that
    imported jax after tpukit still get the local platform."""
    import jax

    ensure_cpu_platform()
    try:
        return jax.devices("cpu")[0]
    except Exception:
        return None


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` verbatim when set, else the fixed
    ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def configure_jax_compile_cache(path: str | None = None) -> str:
    """Point jax's persistent compile cache at ``path`` (default:
    :func:`compile_cache_dir`) with no size/time thresholds. One shared
    implementation for the CLI, the bench, chip_smoke.py and the test
    session."""
    import jax

    d = path or compile_cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return d
