"""Stereo-pair brightness normalization (reference src/operations.rs:3-80).

Two variants per op:

* ``*_exact`` — NumPy host implementations with the reference's f64/u64 arithmetic
  (docs/SEMANTICS.md §8); the parity surface. JAX computes in f32 by default, so
  exact parity math stays on host — these are O(N) preprocessing utilities, not hot ops.
* ``normalize_brightness_f32`` — jit-able device version (f32 gains, psum-ready
  means) for use inside device pipelines; documented deviation (<=1 LSB differences
  possible on u16 inputs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _rust_cast_u16(x: np.ndarray) -> np.ndarray:
    """Rust ``as u16`` from f64: truncate toward zero, SATURATE out-of-range,
    NaN -> 0 (numpy's plain astype WRAPS on overflow and is undefined on
    NaN/inf — both found diverging by hypothesis)."""
    out = np.clip(np.trunc(x), 0.0, 65535.0)
    return np.where(np.isnan(x), 0.0, out).astype(np.uint16)


def normalize_brightness_luma16_exact(img1, img2, percent: float) -> np.ndarray:
    """reference src/operations.rs:3-36: integer floor means, f64 gain,
    Rust-cast to u16 (truncating, saturating, NaN -> 0); no-op when
    |1 - gain| < percent. An all-zero img1 gives gain = inf exactly like the
    reference's f64 division (no panic): zero pixels -> NaN -> 0, nonzero ->
    saturate."""
    a = np.asarray(img1, dtype=np.uint16)
    b = np.asarray(img2, dtype=np.uint16)
    fbr = np.float64(int(a.sum(dtype=np.uint64)) // a.size)
    sbr = np.float64(int(b.sum(dtype=np.uint64)) // b.size)
    with np.errstate(divide="ignore", invalid="ignore"):
        diff = sbr / fbr
    if abs(1.0 - diff) < percent:
        return a.copy()
    return _rust_cast_u16(a.astype(np.float64) * diff)


def normalize_brightness_rgb16_exact(img1, img2, percent: float) -> np.ndarray:
    """reference src/operations.rs:38-80: per-channel f64 means and gains; no-op
    only when all three gains are within tolerance."""
    a = np.asarray(img1, dtype=np.uint16)
    b = np.asarray(img2, dtype=np.uint16)
    m1 = a.reshape(-1, 3).astype(np.float64).sum(axis=0) / (a.size // 3)
    m2 = b.reshape(-1, 3).astype(np.float64).sum(axis=0) / (b.size // 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        diff = m2 / m1
    if np.all(np.abs(1.0 - diff) < percent):
        return a.copy()
    return _rust_cast_u16(a.astype(np.float64) * diff)


@jax.jit
def normalize_brightness_f32(img1, img2, percent: float = 0.0):
    """Device-side gain match: scale img1's channels so its per-channel means equal
    img2's. Works on u8/u16, any [..., C] or [...] layout; returns img1's dtype.
    The means reduce with ``jnp.mean`` and ride ``psum`` when the inputs are
    sharded."""
    a = jnp.asarray(img1)
    b = jnp.asarray(img2)
    ch_axes = tuple(range(a.ndim - 1)) if a.ndim >= 3 else None
    m1 = jnp.mean(a.astype(jnp.float32), axis=ch_axes)
    m2 = jnp.mean(b.astype(jnp.float32), axis=ch_axes)
    gain = m2 / jnp.maximum(m1, 1e-6)
    apply = jnp.any(jnp.abs(1.0 - gain) >= percent)
    scaled = a.astype(jnp.float32) * gain
    info = jnp.iinfo(a.dtype)
    scaled = jnp.clip(scaled, info.min, info.max).astype(a.dtype)
    return jnp.where(apply, scaled, a)
