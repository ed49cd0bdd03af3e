"""Mask algebra and masked-image ops (reference src/mask_image.rs).

Pure ``jnp`` elementwise ops — XLA fuses these into single elementwise passes. All
semantics follow docs/SEMANTICS.md §6: truth is **exact equality with 255**
(reference src/mask_image.rs:103,162,185,208), so resized gray masks behave as
"not true" exactly like the reference (quirk Q6).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

MASK_TRUE = np.uint8(255)
MASK_FALSE = np.uint8(0)


def conform(mask, dims: Tuple[int, int], rebinarize: bool = False):
    """Lenient mask sizing (reference ``load_mask`` src/mask_image.rs:31-44):
    Gaussian-resize on mismatch. Deviation: the resample targets the exact frame
    dims (the reference's aspect-preserving resize can yield a mask smaller than
    the image, leaving the container size-inconsistent); ``rebinarize``
    re-thresholds at 128 (defined deviation escaping quirk Q6's gray-pixel trap;
    default off for parity)."""
    from stepth.ops import resize as resize_ops

    mask = jnp.asarray(mask, dtype=jnp.uint8)
    if (int(mask.shape[0]), int(mask.shape[1])) != tuple(dims):
        mask = resize_ops.resample_exact(mask, dims[0], dims[1], "gaussian")
    if rebinarize:
        mask = jnp.where(mask >= 128, MASK_TRUE, MASK_FALSE)
    return mask


@jax.jit
def mask_and(a, b):
    """reference src/mask_image.rs:147-168 (operands must already be conformed)."""
    t = (a == MASK_TRUE) & (b == MASK_TRUE)
    return jnp.where(t, MASK_TRUE, MASK_FALSE)


@jax.jit
def mask_or(a, b):
    """reference src/mask_image.rs:170-191."""
    t = (a == MASK_TRUE) | (b == MASK_TRUE)
    return jnp.where(t, MASK_TRUE, MASK_FALSE)


@jax.jit
def mask_not(a):
    """Bitwise 255-complement — NOT a boolean not: gray stays gray
    (reference src/mask_image.rs:193-195)."""
    return (MASK_TRUE - jnp.asarray(a, dtype=jnp.uint8)).astype(jnp.uint8)


def reset(dims: Tuple[int, int]):
    """All-true mask (reference src/mask_image.rs:201-203)."""
    return jnp.full(tuple(dims), MASK_TRUE, dtype=jnp.uint8)


@jax.jit
def apply(image, mask):
    """Zero RGBA where mask == MASK_FALSE **exactly** (reference
    src/mask_image.rs:205-213); gray mask pixels leave the image untouched."""
    image = jnp.asarray(image, dtype=jnp.uint8)
    keep = (mask != MASK_FALSE)[..., None]
    return jnp.where(keep, image, jnp.uint8(0))


@jax.jit
def highlight(image, mask):
    """Where TRUE: r*2 (clamped), g/2, b/2 (reference src/mask_image.rs:57-73).
    The reference's f32 round trip is exact integer math for u8 (*2 and *0.5 are
    exact in f32), so this integer version is bit-identical."""
    image = jnp.asarray(image, dtype=jnp.uint8)
    t = mask == MASK_TRUE
    r = jnp.minimum(image[..., 0].astype(jnp.int32) * 2, 255).astype(jnp.uint8)
    g = (image[..., 1] // 2).astype(jnp.uint8)
    b = (image[..., 2] // 2).astype(jnp.uint8)
    hi = jnp.stack([r, g, b, image[..., 3]], axis=-1)
    return jnp.where(t[..., None], hi, image)


def image_replace(image, mask, other, start_yx: Tuple[int, int] = (0, 0)):
    """Copy ``other`` into ``image`` where mask == TRUE, reading ``other`` at
    **absolute** coordinates (quirk Q4, reference src/mask_image.rs:99-109).
    Out-of-bounds absolute reads (start != (0,0) with a small ``other``) panic in
    the reference; we clamp the region to valid reads (documented deviation)."""
    image = jnp.asarray(image, dtype=jnp.uint8)
    other = jnp.asarray(other, dtype=jnp.uint8)
    h, w = int(image.shape[0]), int(image.shape[1])
    oh, ow = int(other.shape[0]), int(other.shape[1])
    sy, sx = int(start_yx[0]), int(start_yx[1])
    y0, y1 = sy, min(sy + oh, h, oh)
    x0, x1 = sx, min(sx + ow, w, ow)
    if y1 <= y0 or x1 <= x0:
        return image
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    region = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
    # pad/crop other to image's shape for the absolute-coordinate read
    src = jnp.zeros_like(image)
    copy_h, copy_w = min(h, oh), min(w, ow)
    src = src.at[:copy_h, :copy_w].set(other[:copy_h, :copy_w])
    take = (region & (mask == MASK_TRUE))[..., None]
    return jnp.where(take, src, image)
