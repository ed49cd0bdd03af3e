"""Stereo rectification (calibrated, pinhole): map a general two-view rig to
the row-aligned geometry every matcher in :mod:`stepth.match` assumes.

Greenfield convenience — the reference pipeline matches unrectified views by
brute-force ring search (reference src/helpers.rs:9-54); the production
matchers here search along epipolar lines, which requires them horizontal.

Algorithm: Fusiello/Trucco/Verri's compact rectification. Given
``x_cam2 = R · x_cam1 + T`` and intrinsics K1/K2, build one rectified frame
whose x-axis is the baseline; each view's rectifying homography is
``H_i = (K_new · R_new) · (K_i · R_i)⁻¹`` (R_1 = I, R_2 = R). Outputs are
inverse sample maps (output pixel → source pixel) for bilinear remapping, so
warping is a single gather pass — precompute the maps once per rig, remap
per frame.

``remap_bilinear`` is ``map_coordinates`` (one fused XLA gather per plane).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

# Sample maps are pixel coordinates: float32 products stay float32 (TF32 would
# move a 1080p map by about a pixel).
_HI = jax.lax.Precision.HIGHEST


class RectifyMaps(NamedTuple):
    """Inverse sample maps and the rectified-rig constants."""

    map_left: jax.Array  # f32[H, W, 2] — (x, y) source coords in the left image
    map_right: jax.Array  # f32[H, W, 2]
    focal: jax.Array  # scalar — rectified focal (px)
    baseline: jax.Array  # scalar — rectified baseline (world units)
    K_new: jax.Array  # f32[3, 3] shared rectified intrinsics


def _normalize(v):
    return v / jnp.linalg.norm(v)


def distort_normalized(xn, dist) -> jax.Array:
    """Brown–Conrady forward distortion on normalized coords ``xn`` [..., 2];
    ``dist`` = (k1, k2, p1, p2[, k3]). The rectification maps need only this
    forward model (output pixel → distorted source pixel) — no iterative
    undistortion anywhere."""
    d = jnp.asarray(dist, jnp.float32).reshape(-1)
    k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
    k3 = d[4] if d.shape[0] > 4 else jnp.float32(0.0)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def rectify_maps(
    K1,
    K2,
    R,
    T,
    image_shape: Tuple[int, int],
    K_new: Optional[jax.Array] = None,
    dist1=None,
    dist2=None,
) -> RectifyMaps:
    """Rectification maps for a calibrated rig.

    ``K1``/``K2``: f32[3,3] pinhole intrinsics. ``R`` f32[3,3], ``T`` f32[3]:
    the relative pose, ``x_cam2 = R · x_cam1 + T``. ``image_shape``: (H, W) of
    the rectified output. ``K_new``: shared rectified intrinsics (defaults to
    K1 with zero skew). ``dist1``/``dist2``: optional Brown–Conrady lens
    distortion (k1, k2, p1, p2[, k3]) per source camera — folded into the
    sample maps (rectify + undistort in the same single remap).

    After ``remap_bilinear(left, maps.map_left)`` / (right, map_right), a
    world point projects to the same row in both outputs (the epipolar
    property — tested analytically in tests/test_rectify.py), with disparity
    ``d = focal · baseline / Z_rect``.
    """
    K1 = jnp.asarray(K1, jnp.float32)
    K2 = jnp.asarray(K2, jnp.float32)
    R = jnp.asarray(R, jnp.float32)
    T = jnp.asarray(T, jnp.float32).reshape(3)
    h, w = image_shape

    # optical centers in cam1's frame: c1 = 0, c2 = −Rᵀ T
    c2 = -jnp.matmul(R.T, T, precision=_HI)
    # rectified axes (rows of R_new): x along the baseline, y ⟂ old z, z = x×y
    v1 = _normalize(c2)
    old_z = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    v2 = _normalize(jnp.cross(old_z, v1))
    v3 = jnp.cross(v1, v2)
    R_new = jnp.stack([v1, v2, v3])

    if K_new is None:
        K_new = K1.at[0, 1].set(0.0)
    K_new = jnp.asarray(K_new, jnp.float32)

    # output pixel → rectified-frame ray → source-camera ray → (distort) → px
    A_new_inv = jnp.linalg.inv(jnp.matmul(K_new, R_new, precision=_HI))

    xx, yy = jnp.meshgrid(
        jnp.arange(w, dtype=jnp.float32), jnp.arange(h, dtype=jnp.float32)
    )
    ones = jnp.ones_like(xx)
    p = jnp.stack([xx, yy, ones], axis=-1)  # [H, W, 3]

    def src_map(Ki, Ri, dist):
        q = jnp.einsum(
            "ij,hwj->hwi", jnp.matmul(Ri, A_new_inv, precision=_HI), p,
            precision=_HI,
        )
        xn = q[..., :2] / q[..., 2:3]
        if dist is not None:
            xn = distort_normalized(xn, dist)
        uvw = jnp.einsum(
            "ij,hwj->hwi",
            Ki,
            jnp.concatenate([xn, jnp.ones_like(xn[..., :1])], axis=-1),
            precision=_HI,
        )
        return uvw[..., :2]

    eye = jnp.eye(3, dtype=jnp.float32)
    return RectifyMaps(
        map_left=src_map(K1, eye, dist1),
        map_right=src_map(K2, R, dist2),
        focal=K_new[0, 0],
        baseline=jnp.linalg.norm(c2),
        K_new=K_new,
    )


def remap_bilinear(img, map_xy, fill: float = 0.0) -> jax.Array:
    """Bilinear sample ``img`` ([H,W] or [H,W,C]) at ``map_xy`` [H',W',2]
    (x, y source coordinates); out-of-image samples get ``fill``."""
    from jax.scipy.ndimage import map_coordinates

    img = jnp.asarray(img, jnp.float32)
    x = map_xy[..., 0]
    y = map_xy[..., 1]
    h, w = img.shape[0], img.shape[1]
    inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)

    def one(plane):
        out = map_coordinates(plane, [y, x], order=1, mode="nearest")
        return jnp.where(inb, out, fill)

    if img.ndim == 2:
        return one(img)
    return jnp.stack([one(img[..., c]) for c in range(img.shape[-1])], axis=-1)


def rectify_pair(left, right, maps: RectifyMaps):
    """Warp both views into the rectified frame (bilinear)."""
    return (
        remap_bilinear(left, maps.map_left),
        remap_bilinear(right, maps.map_right),
    )


def project_rectified(pts_cam1, maps: RectifyMaps, R, T):
    """Project cam1-frame points through both *rectified* cameras; returns
    (uv1, uv2) f32[...,2]. Row coordinates are equal by construction — the
    test oracle for the epipolar property."""
    R = jnp.asarray(R, jnp.float32)
    T = jnp.asarray(T, jnp.float32).reshape(3)
    c2 = -jnp.matmul(R.T, T, precision=_HI)
    v1 = _normalize(c2)
    old_z = jnp.asarray([0.0, 0.0, 1.0], jnp.float32)
    v2 = _normalize(jnp.cross(old_z, v1))
    v3 = jnp.cross(v1, v2)
    R_new = jnp.stack([v1, v2, v3])

    def proj(x):
        q = jnp.einsum("ij,...j->...i", maps.K_new, x, precision=_HI)
        return q[..., :2] / q[..., 2:3]

    x1 = jnp.einsum("ij,...j->...i", R_new, pts_cam1, precision=_HI)
    x2 = jnp.einsum("ij,...j->...i", R_new, pts_cam1 - c2, precision=_HI)
    return proj(x1), proj(x2)
