"""Separable image resampling (image-rs 0.23.14 ``imageops::resize`` semantics).

The reference Gaussian-resizes depth/mask planes through image-rs
(reference src/depth_image.rs:130-134,146-153; src/mask_image.rs:39-43,84-90,152-158).
We reconstruct its two-pass sampler (docs/SEMANTICS.md §5) with one normative
deviation: weights are quantized to Q15 fixed point and accumulated in int32, so the
result is **bit-identical across NumPy and every XLA backend** (float accumulation
order is backend-dependent; integer addition is not). Weights are computed host-side
in f64; tap windows are static, so the JAX path is shape-static and jit-friendly.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_Q = 15  # fixed-point fraction bits; sum of weights per output == 1 << _Q
_MAX_TAPS = 1 << 8  # int32 accumulator headroom: 255 * 2^15 * 256 < 2^31


# --------------------------------------------------------------------------
# Filter kernels (host-side, f64). Constant factors cancel after normalization.
# --------------------------------------------------------------------------
def gaussian_kernel(sigma: float) -> Callable[[float], float]:
    def k(x: float) -> float:
        return math.exp(-(x * x) / (2.0 * sigma * sigma)) / (math.sqrt(2 * math.pi) * sigma)

    return k


def triangle_kernel(x: float) -> float:
    return max(0.0, 1.0 - abs(x))


def catmullrom_kernel(x: float) -> float:
    a = abs(x)
    if a < 1.0:
        return (9.0 * a**3 - 15.0 * a**2 + 6.0) / 6.0
    if a < 2.0:
        return (-3.0 * a**3 + 15.0 * a**2 - 24.0 * a + 12.0) / 6.0
    return 0.0


def lanczos3_kernel(x: float) -> float:
    if x == 0.0:
        return 1.0
    a = abs(x)
    if a >= 3.0:
        return 0.0
    px = math.pi * x
    return 3.0 * math.sin(px) * math.sin(px / 3.0) / (px * px)


FILTERS: dict[str, Tuple[Callable[[float], float], float]] = {
    # name -> (kernel, support); Gaussian matches image-rs FilterType::Gaussian
    # (sigma 1.0, support 3.0).
    "gaussian": (gaussian_kernel(1.0), 3.0),
    "triangle": (triangle_kernel, 1.0),
    "catmullrom": (catmullrom_kernel, 2.0),
    "lanczos3": (lanczos3_kernel, 3.0),
}


@lru_cache(maxsize=256)
def _pass_weights(
    n_in: int, n_out: int, filter_name: str, sigma: float | None
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output tap indices and Q15 weights for one resampling pass.

    Mirrors image-rs vertical/horizontal_sample tap selection
    (docs/SEMANTICS.md §5): returns (idx s32[n_out, T], w s32[n_out, T]); padding
    taps have weight 0 and index 0.
    """
    if sigma is not None:
        # blur path: gaussian(sigma), support 2*sigma, same-size
        kernel, support = gaussian_kernel(max(sigma, 1e-6)), 2.0 * max(sigma, 0.0)
        support = max(support, 1e-3)
    else:
        kernel, support = FILTERS[filter_name]
    ratio = n_in / n_out
    sratio = max(ratio, 1.0)
    src_support = support * sratio

    lefts = np.empty(n_out, dtype=np.int64)
    rights = np.empty(n_out, dtype=np.int64)
    centers = np.empty(n_out, dtype=np.float64)
    for o in range(n_out):
        c = (o + 0.5) * ratio
        left = int(np.clip(math.floor(c - src_support), 0, n_in - 1))
        right = int(np.clip(math.ceil(c + src_support), left + 1, n_in))
        lefts[o], rights[o], centers[o] = left, right, c - 0.5
    taps = int((rights - lefts).max())
    if taps > _MAX_TAPS:
        raise ValueError(
            f"resample {n_in}->{n_out}: {taps} taps exceeds {_MAX_TAPS}; "
            "pre-halve extreme downscales"
        )
    idx = np.zeros((n_out, taps), dtype=np.int32)
    wq = np.zeros((n_out, taps), dtype=np.int32)
    one = 1 << _Q
    for o in range(n_out):
        l, r, c = int(lefts[o]), int(rights[o]), centers[o]
        xs = np.arange(l, r, dtype=np.float64)
        ws = np.array([kernel((i - c) / sratio) for i in xs], dtype=np.float64)
        s = ws.sum()
        if s == 0.0:
            ws = np.ones_like(ws) / len(ws)
        else:
            ws = ws / s
        q = np.round(ws * one).astype(np.int64)
        # absorb the rounding residue into the largest-|w| tap so sums are exact
        q[np.argmax(np.abs(q))] += one - q.sum()
        idx[o, : r - l] = xs.astype(np.int32)
        wq[o, : r - l] = q.astype(np.int32)
    return idx, wq


def _resample_axis0(img: jnp.ndarray, idx: np.ndarray, wq: np.ndarray) -> jnp.ndarray:
    """One pass along axis 0. img int32[n_in, ...] -> int32[n_out, ...].

    Result is floor(sum_t w*x / 2^Q) clamped to [0, 255] (image-rs clamps to the
    channel max then truncates).
    """
    taps = idx.shape[1]
    idx_j = jnp.asarray(idx)
    wq_j = jnp.asarray(wq)
    extra = img.ndim - 1
    acc = jnp.zeros((idx.shape[0],) + img.shape[1:], dtype=jnp.int32)
    for t in range(taps):  # static, small tap count; XLA fuses the gathers
        w = wq_j[:, t].reshape((-1,) + (1,) * extra)
        acc = acc + w * jnp.take(img, idx_j[:, t], axis=0)
    return jnp.clip(acc >> _Q, 0, 255)


def resample_exact(
    img: jnp.ndarray,
    out_h: int,
    out_w: int,
    filter_name: str = "gaussian",
    sigma: float | None = None,
) -> jnp.ndarray:
    """image-rs ``resize_exact``: vertical pass, then horizontal pass.

    ``img`` u8[H, W] or u8[H, W, C]; returns the same rank at (out_h, out_w).
    ``sigma`` switches to the blur kernel (gaussian(sigma), support 2*sigma).
    """
    h, w = int(img.shape[0]), int(img.shape[1])
    vidx, vw = _pass_weights(h, out_h, filter_name, sigma)
    hidx, hw_ = _pass_weights(w, out_w, filter_name, sigma)
    x = jnp.asarray(img).astype(jnp.int32)
    x = _resample_axis0(x, vidx, vw)
    x = jnp.swapaxes(x, 0, 1)
    x = _resample_axis0(x, hidx, hw_)
    x = jnp.swapaxes(x, 0, 1)
    return x.astype(jnp.uint8)


def resize_dimensions(
    width: int, height: int, nwidth: int, nheight: int, fill: bool = False
) -> Tuple[int, int]:
    """Aspect-preserving target size (image-rs ``resize_dimensions``),
    docs/SEMANTICS.md §5. Returns (width, height)."""
    ratio = width * nheight
    nratio = nwidth * height
    use_width = (nratio > ratio) if fill else (nratio <= ratio)
    if use_width:
        intermediate = max(1, (height * nwidth) // width)
        return nwidth, intermediate
    intermediate = max(1, (width * nheight) // height)
    return intermediate, nheight


def resize_u8(
    img: jnp.ndarray, height: int, width: int, filter_name: str = "gaussian"
) -> jnp.ndarray:
    """image-rs ``DynamicImage::resize`` (aspect-preserving) on a u8 array."""
    h, w = int(img.shape[0]), int(img.shape[1])
    tw, th = resize_dimensions(w, h, width, height)
    return resample_exact(img, th, tw, filter_name)


@partial(jax.jit, static_argnames=("sigma",))
def blur_u8(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """image-rs ``blur``: same-size gaussian(sigma) resample, support 2*sigma
    (sigma <= 0 treated as 1.0, matching image-rs)."""
    sigma = 1.0 if sigma <= 0.0 else float(sigma)
    return resample_exact(img, int(img.shape[0]), int(img.shape[1]), sigma=sigma)
