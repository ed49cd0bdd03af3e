"""Depth-plane utilities (reference src/depth_image.rs:51-63,225-245)."""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from stepth.ops.mask import MASK_FALSE, MASK_TRUE


@jax.jit
def invert(depth):
    """depth <- 255 - depth (reference src/depth_image.rs:225-227)."""
    return (jnp.uint8(255) - jnp.asarray(depth, dtype=jnp.uint8)).astype(jnp.uint8)


@jax.jit
def highlight_depth(image, depth):
    """rgb *= depth/255*2, clamped, truncating f32 cast
    (reference src/depth_image.rs:51-63); alpha unchanged."""
    image = jnp.asarray(image, dtype=jnp.uint8)
    mult = depth.astype(jnp.float32) / 255.0 * 2.0
    rgb = image[..., :3].astype(jnp.float32) * mult[..., None]
    rgb = jnp.clip(rgb, 0.0, 255.0).astype(jnp.uint8)
    return jnp.concatenate([rgb, image[..., 3:]], axis=-1)


def slice_mask(depth, lo: Optional[int], hi: Optional[int]):
    """Mask TRUE where lo <= depth <= hi (reference src/depth_image.rs:229-245;
    None bounds default to 0/255 per :230-231)."""
    lo = 0 if lo is None else int(lo)
    hi = 255 if hi is None else int(hi)
    return _slice_mask_jit(jnp.asarray(depth, dtype=jnp.uint8), lo, hi)


@jax.jit
def _slice_mask_jit(depth, lo, hi):
    inside = (depth >= lo) & (depth <= hi)
    return jnp.where(inside, MASK_TRUE, MASK_FALSE)
