"""Whole-image adjustments (image-rs colorops semantics, reconstructed).

Used by the masked adjustment ops (reference src/mask_image.rs:111-141), which run
an image-rs whole-image op and then ``image_replace`` it under the mask.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@jax.jit
def brighten(image, value: jnp.int32):
    """Saturating add on color channels, alpha unchanged (image-rs
    ``brighten``; reference call src/mask_image.rs:111-117)."""
    image = jnp.asarray(image, dtype=jnp.uint8)
    rgb = jnp.clip(image[..., :3].astype(jnp.int32) + value, 0, 255).astype(jnp.uint8)
    return jnp.concatenate([rgb, image[..., 3:]], axis=-1)


@jax.jit
def contrast(image, c: jnp.float32):
    """image-rs ``adjust_contrast``: percent = ((100+c)/100)^2,
    d = clamp(((v/255 - 0.5)*percent + 0.5)*255), truncating cast; alpha unchanged
    (reference call src/mask_image.rs:119-125)."""
    image = jnp.asarray(image, dtype=jnp.uint8)
    percent = ((100.0 + c) / 100.0) ** 2
    v = image[..., :3].astype(jnp.float32) / 255.0
    d = ((v - 0.5) * percent + 0.5) * 255.0
    rgb = jnp.clip(d, 0.0, 255.0).astype(jnp.uint8)
    return jnp.concatenate([rgb, image[..., 3:]], axis=-1)


@partial(jax.jit, static_argnames=("sigma",))
def blur(image, sigma: float):
    """image-rs ``blur``: same-size gaussian(sigma) resample over all channels
    (reference call src/mask_image.rs:135-141)."""
    from stepth.ops import resize as resize_ops

    return resize_ops.blur_u8(jnp.asarray(image, dtype=jnp.uint8), float(sigma))


@partial(jax.jit, static_argnames=("sigma", "threshold"))
def unsharpen(image, sigma: float, threshold: int):
    """image-rs ``unsharpen``: sharpened = orig + (orig - blur(sigma)) where
    |orig - blurred| > threshold, clamped; all channels
    (reference call src/mask_image.rs:127-133)."""
    image = jnp.asarray(image, dtype=jnp.uint8)
    blurred = blur(image, float(sigma))
    a = image.astype(jnp.int32)
    diff = a - blurred.astype(jnp.int32)
    sharp = jnp.clip(a + diff, 0, 255)
    out = jnp.where(jnp.abs(diff) > threshold, sharp, a)
    return out.astype(jnp.uint8)
