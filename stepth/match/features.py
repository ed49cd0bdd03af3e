"""Sparse features: Harris corners, normalized patch descriptors, and
mutual-nearest matching — the correspondence front end for
:mod:`stepth.fusion.epipolar` (images → matched pixels → relative pose →
rectification → the dense matchers).

Harris is separable convolutions + elementwise (fused by XLA);
descriptor matching is one [N, N] matmul. Patch extraction gathers at
corner locations — N is small (hundreds), so the gather cost is negligible
next to any dense stage. All shapes static: ``max_corners`` corners are
always returned, padded with score −inf / validity False.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Corners(NamedTuple):
    xy: jax.Array  # f32[N, 2] (x, y), padded entries 0
    score: jax.Array  # f32[N], −inf on padding
    valid: jax.Array  # bool[N]


def _box3(x):
    for ax in (0, 1):
        x = (
            x
            + jnp.roll(x, 1, axis=ax).at[(0,) if ax == 0 else (slice(None), 0)].set(0)
            + jnp.roll(x, -1, axis=ax).at[(-1,) if ax == 0 else (slice(None), -1)].set(0)
        )
    return x


@functools.partial(jax.jit, static_argnames=("max_corners", "nms_radius"))
def harris_corners(
    img,
    max_corners: int = 512,
    k: float = 0.04,
    nms_radius: int = 4,
    border: int = 8,
) -> Corners:
    """Harris corner response + max-pool non-maximum suppression + top-k.
    ``img`` f32[H, W] (grayscale). Returns exactly ``max_corners`` entries
    (static shape), weakest-first padding marked invalid."""
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape
    dy, dx = jnp.gradient(img)
    ixx = _box3(dx * dx)
    iyy = _box3(dy * dy)
    ixy = _box3(dx * dy)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    resp = det - k * tr * tr

    # NMS: keep pixels equal to their neighborhood max
    win = 2 * nms_radius + 1
    pooled = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (win, win), (1, 1), "SAME"
    )
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    inb = (
        (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    )
    cand = jnp.where((resp == pooled) & inb, resp, -jnp.inf)

    flat = cand.reshape(-1)
    score, idx = jax.lax.top_k(flat, max_corners)
    yi = idx // w
    xi = idx % w
    valid = jnp.isfinite(score)

    # subpixel localization: 1-D parabola through the response along each
    # axis at the peak (reduces the ±0.5 px quantization that dominates
    # downstream pose error)
    def parab(cm1, c0, cp1):
        denom = cm1 - 2.0 * c0 + cp1
        d = jnp.where(jnp.abs(denom) > 1e-12, (cm1 - cp1) / (2.0 * denom), 0.0)
        return jnp.clip(d, -0.5, 0.5)

    yc = jnp.clip(yi, 1, h - 2)
    xc = jnp.clip(xi, 1, w - 2)
    dx = parab(resp[yc, xc - 1], resp[yc, xc], resp[yc, xc + 1])
    dy = parab(resp[yc - 1, xc], resp[yc, xc], resp[yc + 1, xc])
    xs = xi.astype(jnp.float32) + dx
    ys = yi.astype(jnp.float32) + dy
    xy = jnp.where(valid[:, None], jnp.stack([xs, ys], -1), 0.0)
    return Corners(xy=xy, score=score, valid=valid)


@functools.partial(jax.jit, static_argnames=("size",))
def describe_patches(img, xy, size: int = 8):
    """Mean/variance-normalized ``(2·size+1)²`` patch descriptors at integer
    corner locations; f32[N, (2s+1)²], unit-norm rows."""
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape
    s = size
    oy, ox = jnp.meshgrid(
        jnp.arange(-s, s + 1), jnp.arange(-s, s + 1), indexing="ij"
    )

    def one(p):
        cy = jnp.clip(p[1].astype(jnp.int32), s, h - 1 - s)
        cx = jnp.clip(p[0].astype(jnp.int32), s, w - 1 - s)
        patch = img[cy + oy, cx + ox].reshape(-1)
        patch = patch - jnp.mean(patch)
        return patch / jnp.maximum(jnp.linalg.norm(patch), 1e-6)

    return jax.vmap(one)(xy)


@functools.partial(jax.jit, static_argnames=())
def match_descriptors(d1, d2, valid1, valid2, min_similarity: float = 0.7):
    """Mutual-nearest-neighbor matching by cosine similarity (descriptors are
    unit-norm, so one [N, N] matmul). Returns (idx2_for_each_1 i32[N],
    matched bool[N])."""
    sim = jnp.matmul(d1, d2.T, precision=jax.lax.Precision.HIGHEST)
    sim = jnp.where(valid1[:, None] & valid2[None, :], sim, -jnp.inf)
    best12 = jnp.argmax(sim, axis=1)
    best21 = jnp.argmax(sim, axis=0)
    s12 = jnp.max(sim, axis=1)
    mutual = jnp.arange(d1.shape[0]) == best21[best12]
    matched = mutual & (s12 >= min_similarity) & valid1
    return best12, matched


def match_pair_features(
    left,
    right,
    max_corners: int = 512,
    patch_size: int = 8,
    min_similarity: float = 0.7,
):
    """Images → matched pixel correspondences: Harris + normalized patches +
    mutual NN. Returns (uv1 f32[M, 2], uv2 f32[M, 2]) as NumPy-backed jnp
    arrays with data-dependent M (host-side compaction — this is the sparse
    front end, not a jit region)."""
    from stepth.match import dense

    lg = dense.grayscale(jnp.asarray(left, jnp.float32))
    rg = dense.grayscale(jnp.asarray(right, jnp.float32))
    c1 = harris_corners(lg, max_corners=max_corners)
    c2 = harris_corners(rg, max_corners=max_corners)
    d1 = describe_patches(lg, c1.xy, size=patch_size)
    d2 = describe_patches(rg, c2.xy, size=patch_size)
    idx2, ok = match_descriptors(d1, d2, c1.valid, c2.valid, min_similarity)
    import numpy as np

    ok_np = np.asarray(ok)
    return (
        jnp.asarray(np.asarray(c1.xy)[ok_np]),
        jnp.asarray(np.asarray(c2.xy)[np.asarray(idx2)[ok_np]]),
    )
