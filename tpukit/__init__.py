"""tpukit — satellite image-compression benchmarking framework on JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
pipeline (Angela0110/Image-compression-analysis): baseline preparation for
Sentinel-2 (Case A) and EnMAP (Case B) products, in-framework codecs
(CCSDS-121/122/123, JPEG-LS, JPEG 2000-style, PNG), fused device metrics
(PSNR/SSIM/SAM/SID/LMSE), rate sweeps, CSV contracts, quicklooks and
rate-distortion figures.

Unlike the reference — which shells out to external native binaries per tile
per band (reference tools/run_codec.py:485-501) — every codec here is an
in-framework component: prediction/transform/entropy-cost stages run on the
accelerator via JAX over device-resident (bands, H, W) tile stacks, and the
exact variable-length bitstream packing runs in a small C++ runtime
(tpukit/native) loaded through ctypes.
"""

__version__ = "0.1.0"

# Keep the LOCAL CPU platform reachable alongside a pinned accelerator
# platform (JAX_PLATFORMS=cuda) from the moment tpukit is imported:
# budget-only device programs (the ebcot quality→size pricing) run on the
# CPU backend for topology-independent determinism. This only appends to
# the platform list and must happen before the first backend
# initialization. ONLY when jax is already imported — a bare `import
# tpukit` for non-jax tooling (CLI --help, io/viz consumers) must stay
# jax-free; paths that import jax later are covered because
# hostinfo.local_cpu_device re-runs ensure_cpu_platform itself.
import sys as _sys

if "jax" in _sys.modules:
    try:  # config-only: never initializes a backend, never raises upward
        from tpukit.hostinfo import ensure_cpu_platform as _ensure_cpu

        _ensure_cpu()
        del _ensure_cpu
    except Exception:  # pragma: no cover - config frozen
        pass
del _sys
