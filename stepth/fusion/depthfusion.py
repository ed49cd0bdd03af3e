"""Multi-keyframe depth fusion (greenfield; BASELINE.md config 5).

Fuses ``K`` posed depth maps into a reference view: each source depth map is
unprojected to world, transformed into the reference camera, and **forward
splatted** with a z-buffer (``segment_min`` over flattened pixel indices — one
XLA scatter); per-view warped depths are then blended where they agree
within a relative tolerance, yielding a fused depth and a support-count
confidence map. Everything is static-shape and jit-able; a batch of keyframes
is one vmap.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from stepth.fusion import geometry as geo

_FAR = np.float32(1e9)  # numpy, not jnp: avoid backend init at import


class FusedDepth(NamedTuple):
    depth: jax.Array  # f32[H, W]; 0 where nothing fused
    confidence: jax.Array  # f32[H, W]; number of agreeing views


def warp_depth_to_ref(
    src_depth: jax.Array,  # f32[H, W] metric depth in the source view
    src_pose: jax.Array,  # f32[6] world→source
    ref_pose: jax.Array,  # f32[6] world→reference
    intrinsics: jax.Array,  # f32[4]
) -> jax.Array:
    """Forward-splat a source depth map into the reference view.

    Returns f32[H, W] of reference-frame depths (``0`` where no source pixel
    lands). Collisions keep the nearest surface (z-buffer min)."""
    h, w = src_depth.shape
    ys, xs = jnp.mgrid[0:h, 0:w]
    uv = jnp.stack([xs, ys], axis=-1).astype(jnp.float32).reshape(-1, 2)
    z = src_depth.reshape(-1)

    pts_src = geo.unproject(uv, z, intrinsics)
    src_to_ref = geo.compose(ref_pose, geo.inverse(src_pose))
    pts_ref = geo.transform(src_to_ref[None], pts_src)
    uv_ref = geo.project(pts_ref, intrinsics)
    z_ref = pts_ref[..., 2]

    px = jnp.round(uv_ref[..., 0]).astype(jnp.int32)
    py = jnp.round(uv_ref[..., 1]).astype(jnp.int32)
    valid = (z > 1e-3) & (z_ref > 1e-3) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    idx = jnp.where(valid, py * w + px, h * w)  # invalid → overflow bucket
    z_scatter = jnp.where(valid, z_ref, _FAR)

    zbuf = jax.ops.segment_min(z_scatter, idx, num_segments=h * w + 1)[: h * w]
    return jnp.where(zbuf >= _FAR, 0.0, zbuf).reshape(h, w)


@partial(jax.jit, static_argnames=("rel_tol",))
def fuse_depths(
    depths: jax.Array,  # f32[K, H, W] source metric depths
    poses: jax.Array,  # f32[K, 6] world→source
    ref_pose: jax.Array,  # f32[6]
    intrinsics: jax.Array,  # f32[4]
    rel_tol: float = 0.02,
) -> FusedDepth:
    """Warp every source view into the reference camera and blend.

    Consensus rule: take the minimum (nearest) warped depth as the anchor, then
    average all views within ``rel_tol`` (relative) of it; confidence is the
    number of agreeing views."""
    warped = jax.vmap(warp_depth_to_ref, in_axes=(0, 0, None, None))(
        depths, poses, ref_pose, intrinsics
    )  # [K, H, W]
    has = warped > 0.0
    anchor = jnp.min(jnp.where(has, warped, _FAR), axis=0)  # nearest surface
    agree = has & (jnp.abs(warped - anchor[None]) <= rel_tol * anchor[None])
    count = jnp.sum(agree, axis=0).astype(jnp.float32)
    fused = jnp.where(
        count > 0, jnp.sum(jnp.where(agree, warped, 0.0), axis=0) / jnp.maximum(count, 1.0), 0.0
    )
    return FusedDepth(depth=fused, confidence=count)
