"""SE(3) / pinhole camera geometry for the fusion layer.

Greenfield (the reference has no multi-frame machinery — SURVEY.md §5/§7 step 6):
minimal, fully-vectorized rigid-transform and projection math used by depth
fusion, the pose graph, and bundle adjustment. Conventions:

* rotations as axis-angle 3-vectors (``so3``), poses as ``[rx, ry, rz, tx, ty, tz]``
  6-vectors (``se3``); ``T(x) = R x + t`` maps *world* points into *camera* frame;
* pinhole intrinsics ``(fx, fy, cx, cy)``; pixel = ``(fx X/Z + cx, fy Y/Z + cy)``;
* everything is f32, batched along leading axes, and jit/vmap-safe (series
  fallbacks near θ=0 keep gradients finite).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat operator: w[...,3] → skew matrix [...,3,3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], -1),
            jnp.stack([wz, z, -wx], -1),
            jnp.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _matmul3(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched 3×3 product as a broadcast-multiply-sum (exact f32
    elementwise; `@` under default precision may run in a reduced-precision
    matrix unit — TF32 on a GPU)."""
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues: axis-angle [...,3] → rotation matrix [...,3,3]."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2 + _EPS)
    K = hat(w)
    K2 = _matmul3(K, K)
    # sin θ/θ and (1-cos θ)/θ² with series fallback near 0
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a * K + b * K2


def log_so3(R: jax.Array) -> jax.Array:
    """Rotation matrix [...,3,3] → axis-angle [...,3] (θ ∈ [0, π))."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = jnp.clip((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    sin = jnp.sin(theta)
    scale = jnp.where(theta[..., None] < 1e-6, 0.5, theta[..., None] / (2.0 * sin[..., None] + _EPS))
    return w * scale


def exp_se3(xi: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """se3 6-vector [...,6] → (R [...,3,3], t [...,3]).

    Uses the first-order pose convention t = translation part directly (not the
    full SE(3) exponential V-matrix): poses are parameters, not velocities, so
    the simple (R, t) split keeps Jacobians cheap; composition/log below are
    consistent with this convention.
    """
    return exp_so3(xi[..., :3]), xi[..., 3:]


def se3_from_Rt(R: jax.Array, t: jax.Array) -> jax.Array:
    return jnp.concatenate([log_so3(R), t], axis=-1)


def _rotate(R: jax.Array, v: jax.Array) -> jax.Array:
    """R·v as a broadcast-multiply-sum. An einsum under default precision
    may run in a reduced-precision matrix unit (TF32 on a GPU); the broadcast
    form is exact f32."""
    return jnp.sum(R * v[..., None, :], axis=-1)


def transform(xi: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply pose ``xi`` [...,6] to points [...,3]: R·p + t."""
    R, t = exp_se3(xi)
    return _rotate(R, pts) + t


def compose(xi_a: jax.Array, xi_b: jax.Array) -> jax.Array:
    """Pose of (a ∘ b): first apply b, then a."""
    Ra, ta = exp_se3(xi_a)
    Rb, tb = exp_se3(xi_b)
    R = _matmul3(Ra, Rb)
    t = _rotate(Ra, tb) + ta
    return se3_from_Rt(R, t)


def inverse(xi: jax.Array) -> jax.Array:
    R, t = exp_se3(xi)
    Rt = jnp.swapaxes(R, -1, -2)
    return se3_from_Rt(Rt, -_rotate(Rt, t))


def relative(xi_a: jax.Array, xi_b: jax.Array) -> jax.Array:
    """T_a^{-1} ∘ T_b."""
    return compose(inverse(xi_a), xi_b)


def project(pts_cam: jax.Array, intrinsics: jax.Array) -> jax.Array:
    """Camera-frame points [...,3] → pixels [...,2]; intrinsics [...,4]
    = (fx, fy, cx, cy). Z is clamped away from 0 to keep gradients finite."""
    fx, fy, cx, cy = (
        intrinsics[..., 0],
        intrinsics[..., 1],
        intrinsics[..., 2],
        intrinsics[..., 3],
    )
    z = jnp.where(jnp.abs(pts_cam[..., 2]) < 1e-6, 1e-6, pts_cam[..., 2])
    return jnp.stack(
        [fx * pts_cam[..., 0] / z + cx, fy * pts_cam[..., 1] / z + cy], -1
    )


def unproject(uv: jax.Array, depth: jax.Array, intrinsics: jax.Array) -> jax.Array:
    """Pixels [...,2] + depth [...] → camera-frame points [...,3]."""
    fx, fy, cx, cy = (
        intrinsics[..., 0],
        intrinsics[..., 1],
        intrinsics[..., 2],
        intrinsics[..., 3],
    )
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return jnp.stack([x, y, depth], -1)


def disparity_to_depth(disp: jax.Array, focal: float, baseline: float) -> jax.Array:
    """Stereo disparity → metric depth: Z = f·B/d (invalid/zero disparity → 0)."""
    d = jnp.asarray(disp)
    return jnp.where(d > 1e-3, focal * baseline / jnp.maximum(d, 1e-3), 0.0)


def depth_to_points(depth: jax.Array, intrinsics: jax.Array) -> jax.Array:
    """Depth image [H, W] → camera-frame point image [H, W, 3] (pinhole
    back-projection of every pixel center; pair with
    :func:`stepth.core.io.save_ply` for export). Greenfield convenience —
    the reference stops at the 2-D depth map (src/depth_image.rs:91-136)."""
    h, w = depth.shape
    u = jnp.arange(w, dtype=jnp.float32)[None, :].repeat(h, axis=0)
    v = jnp.arange(h, dtype=jnp.float32)[:, None].repeat(w, axis=1)
    return unproject(jnp.stack([u, v], -1), depth, intrinsics)
