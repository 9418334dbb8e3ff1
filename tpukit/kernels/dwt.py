# -*- coding: utf-8 -*-
"""2-D multilevel discrete wavelet transforms (lifting) on device.

Device building block for the transform codecs. The reference obtains
its DWTs from inside external binaries (OpenJPEG's 5/3 & 9/7 for JPEG 2000
via GDAL — reference tools/codecs/j2k/j2k_wrap.py:79-105 — and the BPE's
three-level 9/7 for CCSDS-122 — tools/codecs/ccsds122/ccsds122_wrap.py:110-133).
Here they are jittable lifting schemes over ``(..., H, W)`` arrays:

  * ``dwt53`` / ``idwt53`` — reversible integer CDF 5/3 (JPEG 2000
    lossless filter), exact integer round-trip
  * ``dwt97`` / ``idwt97`` — irreversible CDF 9/7 (JPEG 2000 lossy filter)
  * ``dwt97m`` / ``idwt97m`` — integer 9/7M approximation (the reversible
    transform used by CCSDS-122 bit-plane coding)

All use whole-point symmetric extension and operate on even-sized axes
(framework tiles are powers of two). Multilevel variants return the
canonical subband layout packed in-place: [LL | HL; LH; HH] per level.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp


def _split(x, axis):
    even = jax.lax.slice_in_dim(x, 0, x.shape[axis], 2, axis)
    odd = jax.lax.slice_in_dim(x, 1, x.shape[axis], 2, axis)
    return even, odd


def _sym_r(a, axis):
    """a shifted left by one with symmetric (mirror) right edge: a[i+1],
    last = a[-1] mirrored -> a[n-2]? For lifting we need neighbor at i+1
    with extension a[n] := a[n-1] convention of JPEG 2000 (whole-sample
    symmetric: x[n] = x[n-2] for even-length split arrays)."""
    n = a.shape[axis]
    shifted = jax.lax.slice_in_dim(a, 1, n, 1, axis)
    last = jax.lax.slice_in_dim(a, n - 1, n, 1, axis)
    return jnp.concatenate([shifted, last], axis=axis)


def _sym_l(a, axis):
    """a shifted right by one with symmetric left edge: a[i-1], first = a[0]."""
    n = a.shape[axis]
    shifted = jax.lax.slice_in_dim(a, 0, n - 1, 1, axis)
    first = jax.lax.slice_in_dim(a, 0, 1, 1, axis)
    return jnp.concatenate([first, shifted], axis=axis)


def _interleave_general(even, odd, axis):
    axis = axis % even.ndim
    shape = list(even.shape)
    shape[axis] *= 2
    out_idx_even = jnp.arange(even.shape[axis]) * 2
    out = jnp.zeros(shape, even.dtype)
    out = jnp.moveaxis(out, axis, 0)
    e = jnp.moveaxis(even, axis, 0)
    o = jnp.moveaxis(odd, axis, 0)
    out = out.at[0::2].set(e).at[1::2].set(o)
    return jnp.moveaxis(out, 0, axis)


# ---------------------------------------------------------------------------
# 1-D lifting steps along an axis
# ---------------------------------------------------------------------------

def _fwd53_1d(x, axis):
    s, d = _split(x, axis)                    # even, odd
    s_r = _sym_r(s, axis)                     # s[i+1] (x[2i+2])
    d = d - ((s + s_r) >> 1)                  # predict
    d_l = _sym_l(d, axis)                     # d[i-1]
    s = s + ((d_l + d + 2) >> 2)              # update
    return s, d


def _inv53_1d(s, d, axis):
    d_l = _sym_l(d, axis)
    s = s - ((d_l + d + 2) >> 2)
    s_r = _sym_r(s, axis)
    d = d + ((s + s_r) >> 1)
    return _interleave_general(s, d, axis)


_A97 = -1.586134342059924
_B97 = -0.052980118572961
_G97 = 0.882911075530934
_D97 = 0.443506852043971
_K97 = 1.230174104914001


def _fwd97_1d(x, axis):
    s, d = _split(x, axis)
    d = d + _A97 * (s + _sym_r(s, axis))
    s = s + _B97 * (_sym_l(d, axis) + d)
    d = d + _G97 * (s + _sym_r(s, axis))
    s = s + _D97 * (_sym_l(d, axis) + d)
    return s * _K97, d / _K97


def _inv97_1d(s, d, axis):
    s = s / _K97
    d = d * _K97
    s = s - _D97 * (_sym_l(d, axis) + d)
    d = d - _G97 * (s + _sym_r(s, axis))
    s = s - _B97 * (_sym_l(d, axis) + d)
    d = d - _A97 * (s + _sym_r(s, axis))
    return _interleave_general(s, d, axis)


def _round_half_up(x):
    return jnp.floor(x + 0.5).astype(jnp.int32)


def _sym_l2(a, axis):
    """a[i-1] with WHOLE-SAMPLE symmetric head: a[-1] := a[1] (the full
    signal's x[-2] = x[2] maps to the even subsequence's s[1] — CCSDS
    122.0-B §3.3 edge extension for the 4-tap predict)."""
    n = a.shape[axis]
    if n == 1:
        return a
    head = jax.lax.slice_in_dim(a, 1, 2, 1, axis)
    rest = jax.lax.slice_in_dim(a, 0, n - 1, 1, axis)
    return jnp.concatenate([head, rest], axis=axis)


def _sym_r2(a, axis):
    """a[i+2] with whole-sample symmetric tail: a[n] := a[n-1] (x[2n] =
    x[2n-2]) and a[n+1] := a[n-2] (x[2n+2] = x[2n-4])."""
    n = a.shape[axis]
    if n == 1:
        return a
    body = jax.lax.slice_in_dim(a, 2, n, 1, axis)
    t1 = jax.lax.slice_in_dim(a, n - 1, n, 1, axis)
    t2 = jax.lax.slice_in_dim(a, n - 2, n - 1, 1, axis)
    return jnp.concatenate([body, t1, t2], axis=axis)


def _fwd97m_1d(x, axis):
    """Integer 9/7M (CCSDS 122.0-B §3.3): 4-tap predict, 2-tap update,
    nonlinear rounding — reversible. Edge neighbors use the standard's
    whole-sample symmetric extension (s[-1]=s[1], s[n]=s[n-1],
    s[n+1]=s[n-2]; d[-1]=d[0])."""
    s, d = _split(x, axis)
    s_r = _sym_r(s, axis)
    s_rr = _sym_r2(s, axis)
    s_l = _sym_l2(s, axis)
    d = d - _round_half_up((9.0 / 16.0) * (s + s_r) - (1.0 / 16.0) * (s_l + s_rr))
    d_l = _sym_l(d, axis)
    s = s - _round_half_up(-0.25 * (d_l + d))
    return s, d


def _inv97m_1d(s, d, axis):
    d_l = _sym_l(d, axis)
    s = s + _round_half_up(-0.25 * (d_l + d))
    s_r = _sym_r(s, axis)
    s_rr = _sym_r2(s, axis)
    s_l = _sym_l2(s, axis)
    d = d + _round_half_up((9.0 / 16.0) * (s + s_r) - (1.0 / 16.0) * (s_l + s_rr))
    return _interleave_general(s, d, axis)


_FWD = {"53": _fwd53_1d, "97": _fwd97_1d, "97m": _fwd97m_1d}
_INV = {"53": _inv53_1d, "97": _inv97_1d, "97m": _inv97m_1d}


# ---------------------------------------------------------------------------
# 2-D multilevel, packed layout
# ---------------------------------------------------------------------------

def _dwt2_once(x, kind):
    f = _FWD[kind]
    sL, sH = f(x, -1)                  # columns
    LL, LH = f(sL, -2)                 # rows of low
    HL, HH = f(sH, -2)
    top = jnp.concatenate([LL, HL], axis=-1)
    bot = jnp.concatenate([LH, HH], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _idwt2_once(c, kind):
    inv = _INV[kind]
    H2 = c.shape[-2] // 2
    W2 = c.shape[-1] // 2
    LL = c[..., :H2, :W2]
    HL = c[..., :H2, W2:]
    LH = c[..., H2:, :W2]
    HH = c[..., H2:, W2:]
    sL = inv(LL, LH, -2)
    sH = inv(HL, HH, -2)
    return inv(sL, sH, -1)


@partial(jax.jit, static_argnames=("kind", "levels"))
def dwt2(x: jax.Array, kind: str = "53", levels: int = 3) -> jax.Array:
    """Multilevel 2-D DWT, packed in place (Mallat layout)."""
    if kind == "53":
        x = x.astype(jnp.int32)
    elif kind == "97m":
        x = x.astype(jnp.int32)
    else:
        x = x.astype(jnp.float32)
    H, W = x.shape[-2], x.shape[-1]
    out = x
    for lv in range(levels):
        h = H >> lv
        w = W >> lv
        sub = out[..., :h, :w]
        sub = _dwt2_once(sub, kind)
        out = out.at[..., :h, :w].set(sub)
    return out


@partial(jax.jit, static_argnames=("kind", "levels"))
def idwt2(c: jax.Array, kind: str = "53", levels: int = 3) -> jax.Array:
    out = c
    H, W = c.shape[-2], c.shape[-1]
    for lv in range(levels - 1, -1, -1):
        h = H >> lv
        w = W >> lv
        sub = out[..., :h, :w]
        sub = _idwt2_once(sub, kind)
        out = out.at[..., :h, :w].set(sub)
    return out


def dwt53(x, levels=3):
    return dwt2(x, "53", levels)


def idwt53(c, levels=3):
    return idwt2(c, "53", levels)


def dwt97(x, levels=3):
    return dwt2(x, "97", levels)


def idwt97(c, levels=3):
    return idwt2(c, "97", levels)


def dwt97m(x, levels=3):
    return dwt2(x, "97m", levels)


def idwt97m(c, levels=3):
    return idwt2(c, "97m", levels)


def subband_slices(H: int, W: int, levels: int) -> List[Tuple[str, int, tuple]]:
    """(name, level, (rowslice, colslice)) for the packed layout; level 0 is
    the finest. LL only at the coarsest level."""
    out = []
    for lv in range(levels):
        h = H >> lv
        w = W >> lv
        h2, w2 = h // 2, w // 2
        out.append((f"HL{lv+1}", lv, (slice(0, h2), slice(w2, w))))
        out.append((f"LH{lv+1}", lv, (slice(h2, h), slice(0, w2))))
        out.append((f"HH{lv+1}", lv, (slice(h2, h), slice(w2, w))))
    out.append((f"LL{levels}", levels - 1,
                (slice(0, H >> levels), slice(0, W >> levels))))
    return out
