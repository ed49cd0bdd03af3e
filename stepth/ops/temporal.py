"""Temporal ops over stereo video (BASELINE.md config 4).

Batched/temporal recasts of the single-image ops: the reference processes one
image at a time (its containers hold a single RGBA+Luma pair); video is the
greenfield extension — time is just a leading axis, so every op is a vmap or a
small scan, and batches shard over the mesh ``data`` axis unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from stepth.core.frame import MASK_FALSE, MASK_TRUE


def temporal_median_depth(depths: jax.Array, window: int = 3) -> jax.Array:
    """Sliding temporal median over u8/f32 depth video [T, H, W] (odd window;
    edges use clamped windows of the same size — replicated ends)."""
    t = depths.shape[0]
    r = window // 2
    padded = jnp.concatenate(
        [jnp.repeat(depths[:1], r, 0), depths, jnp.repeat(depths[-1:], r, 0)], 0
    )
    stack = jnp.stack([padded[k : k + t] for k in range(window)], axis=0)
    return jnp.median(stack, axis=0).astype(depths.dtype)


def ema_depth(depths: jax.Array, alpha: float = 0.5) -> jax.Array:
    """Exponential moving average along time (f32 out), as a ``lax.scan``."""
    x = depths.astype(jnp.float32)

    def step(carry, frame):
        out = alpha * frame + (1.0 - alpha) * carry
        return out, out

    _, out = jax.lax.scan(step, x[0], x[1:])
    return jnp.concatenate([x[:1], out], axis=0)


def mask_stabilize(masks: jax.Array, window: int = 3, min_votes: int = 2) -> jax.Array:
    """Temporal vote filter over boolean u8 masks [T, H, W]: a pixel is TRUE
    when ≥ ``min_votes`` of the ``window`` neighboring frames are TRUE — removes
    single-frame flicker (AND/OR generalization of the reference's mask algebra,
    reference src/mask_image.rs:147-191, lifted over time)."""
    t = masks.shape[0]
    r = window // 2
    b = (masks == MASK_TRUE).astype(jnp.int32)
    padded = jnp.concatenate(
        [jnp.repeat(b[:1], r, 0), b, jnp.repeat(b[-1:], r, 0)], 0
    )
    votes = sum(padded[k : k + t] for k in range(window))
    return jnp.where(votes >= min_votes, MASK_TRUE, MASK_FALSE).astype(jnp.uint8)


def mask_and_video(a: jax.Array, b: jax.Array) -> jax.Array:
    """Frame-wise mask AND over [T, H, W] (exact-equality semantics,
    docs/SEMANTICS.md §6)."""
    both = (a == MASK_TRUE) & (b == MASK_TRUE)
    return jnp.where(both, MASK_TRUE, MASK_FALSE).astype(jnp.uint8)


def mask_or_video(a: jax.Array, b: jax.Array) -> jax.Array:
    either = (a == MASK_TRUE) | (b == MASK_TRUE)
    return jnp.where(either, MASK_TRUE, MASK_FALSE).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("threshold",))
def motion_mask(depths: jax.Array, threshold: float = 4.0) -> jax.Array:
    """Mask of pixels whose depth changed more than ``threshold`` between
    consecutive frames; frame 0 is all-FALSE. [T, H, W] u8 out."""
    d = depths.astype(jnp.float32)
    delta = jnp.abs(d[1:] - d[:-1])
    moving = jnp.concatenate(
        [jnp.zeros_like(d[:1], dtype=bool), delta > threshold], axis=0
    )
    return jnp.where(moving, MASK_TRUE, MASK_FALSE).astype(jnp.uint8)
