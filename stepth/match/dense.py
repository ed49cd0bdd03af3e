"""Dense rectified-stereo matcher — the exhaustive-search fast path.

This is the performance recast of the reference's depth engine (SURVEY.md §7
step 4): the reference's per-block expanding ring search over brightness
(reference src/helpers.rs:9-54 driving src/depth_image.rs:111-123) becomes a
dense cost volume over ``D`` horizontal disparity shifts, aggregated over a box
window, with winner-take-all selection. The disparity axis is innermost,
aggregation is two separable cumulative sums (integral images — O(1) per
window instead of O(w²)), and the whole pipeline is one XLA program with
static shapes.

Pipeline:  grayscale/census → cost volume → box aggregation → WTA (+subpixel)
           → left-right consistency → invalid fill → median filter.

The parity path (stepth/match/parity.py) remains the bit-exact twin of the
reference; this module is what a production user runs on rectified pairs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from stepth.config import MatchConfig

# numpy scalar, NOT jnp: a module-level jnp constant would initialize the XLA
# backend at import time, which breaks `jax.distributed.initialize` (it must
# run before any backend init — see tools/multiproc_worker.py).
_INVALID = np.float32(-1.0)


class MatchResult(NamedTuple):
    """Disparity output of the dense matcher."""

    disparity: jax.Array  # f32[H, W]; -1 where invalid
    valid: jax.Array  # bool[H, W]
    cost: jax.Array  # f32[H, W] winning aggregated cost (diagnostics)


def grayscale(rgb) -> jax.Array:
    """Rec.709 luma in f32 (matches docs/SEMANTICS.md §2 weighting)."""
    rgb = jnp.asarray(rgb)
    if rgb.ndim == 2:
        return rgb.astype(jnp.float32)
    rgb = rgb[..., :3].astype(jnp.float32)
    # explicit weighted sum, NOT `@`: a dot under default precision may run
    # in a reduced-precision matrix unit (TF32 on a GPU); this stays exact f32.
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )


def census_transform(gray: jax.Array, window: int = 7) -> jax.Array:
    """Census bit-string per pixel, packed into uint32 planes.

    Each neighbor comparison (center > neighbor) contributes one bit. For a
    ``window``×``window`` support there are ``window²-1`` bits, packed into
    ``ceil(bits/32)`` uint32 planes → u32[H, W, P]. Pure elementwise work; replaces the
    reference's raw-brightness predicate with an illumination-robust descriptor.
    """
    h, w = gray.shape
    r = window // 2
    padded = jnp.pad(gray, r, mode="edge")
    bits = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            nb = jax.lax.dynamic_slice(padded, (dy + r, dx + r), (h, w))
            bits.append(gray > nb)
    planes = []
    for p in range(0, len(bits), 32):
        acc = jnp.zeros((h, w), dtype=jnp.uint32)
        for i, b in enumerate(bits[p : p + 32]):
            acc = acc | (b.astype(jnp.uint32) << jnp.uint32(i))
        planes.append(acc)
    return jnp.stack(planes, axis=-1)


def _shift_right_image(img: jax.Array, num_disparities: int) -> jax.Array:
    """Stack of ``D`` left-shifted copies of the right image: out[..., d] is the
    right image sampled at ``x - d`` (edge-replicated out of range), disparity
    innermost."""
    d = num_disparities
    pad_width = [(d - 1, 0)] + [(0, 0)] * (img.ndim - 1)
    padded = jnp.pad(jnp.moveaxis(img, 1, 0), pad_width, mode="edge")
    # padded axis 0 is now x with offset d-1: sample x-d = padded[x + (d-1) - d]
    shifted = [jnp.moveaxis(padded[d - 1 - k : padded.shape[0] - k], 0, 1) for k in range(d)]
    return jnp.stack(shifted, axis=-1)  # [..., W?, D] — disparity last


def cost_volume(left_gray, right_gray, cfg: MatchConfig) -> jax.Array:
    """Per-pixel matching cost f32[H, W, D] (smaller = better)."""
    d = cfg.num_disparities
    if cfg.cost == "census":
        cl = census_transform(left_gray, cfg.census_window)  # u32[H, W, P]
        cr = census_transform(right_gray, cfg.census_window)
        crs = _shift_right_image(cr, d)  # u32[H, W, P, D]
        ham = jax.lax.population_count(cl[..., None] ^ crs)  # u32
        return jnp.sum(ham, axis=2).astype(jnp.float32)  # [H, W, D]
    rs = _shift_right_image(right_gray, d)  # [H, W, D]
    diff = left_gray[..., None] - rs
    if cfg.cost == "ssd":
        return diff * diff
    return jnp.abs(diff)


def box_aggregate(cost: jax.Array, window: int) -> jax.Array:
    """Box-window sum over the spatial dims of [H, W, D] via two cumulative sums
    (integral image, O(1) per window). Out-of-image contributions are zero
    (clipped windows are *not* renormalized: the per-pixel window population is
    identical across the disparity axis, so WTA argmin, parabolic subpixel, and
    uniqueness ratios are unaffected — and zero-padding makes the tile-sharded
    path seam-exact with a plain halo exchange)."""
    if window <= 1:
        return cost
    r = window // 2
    h, w = cost.shape[0], cost.shape[1]

    def _axis_boxsum(x, axis, n):
        ii = jnp.cumsum(x, axis=axis, dtype=jnp.float32)
        zeros = jnp.zeros_like(jax.lax.slice_in_dim(ii, 0, 1, axis=axis))
        ii = jnp.concatenate([zeros, ii], axis=axis)  # ii[i] = sum of first i
        idx = jnp.arange(n)
        hi = jnp.minimum(idx + r + 1, n)
        lo = jnp.maximum(idx - r, 0)
        return jnp.take(ii, hi, axis=axis) - jnp.take(ii, lo, axis=axis)

    out = _axis_boxsum(cost.astype(jnp.float32), 0, h)
    out = _axis_boxsum(out, 1, w)
    return out


def wta(agg: jax.Array, subpixel: bool = True, uniqueness: Optional[float] = None):
    """Winner-take-all over the disparity axis with optional parabolic subpixel
    refinement and uniqueness-ratio validity."""
    d = agg.shape[-1]
    best = jnp.argmin(agg, axis=-1)  # i32[H, W]
    cbest = jnp.min(agg, axis=-1)
    disp = best.astype(jnp.float32)
    if subpixel and d >= 3:
        bm = jnp.clip(best, 1, d - 2)
        cm1 = jnp.take_along_axis(agg, (bm - 1)[..., None], axis=-1)[..., 0]
        c0 = jnp.take_along_axis(agg, bm[..., None], axis=-1)[..., 0]
        cp1 = jnp.take_along_axis(agg, (bm + 1)[..., None], axis=-1)[..., 0]
        denom = cm1 - 2.0 * c0 + cp1
        delta = jnp.where(jnp.abs(denom) > 1e-6, (cm1 - cp1) / (2.0 * denom), 0.0)
        delta = jnp.clip(delta, -0.5, 0.5)
        interior = (best >= 1) & (best <= d - 2)
        disp = jnp.where(interior, bm.astype(jnp.float32) + delta, disp)
    valid = jnp.ones(best.shape, dtype=bool)
    if uniqueness is not None:
        masked = jnp.where(
            jnp.abs(jnp.arange(d) - best[..., None]) <= 1, jnp.inf, agg
        )
        second = jnp.min(masked, axis=-1)
        valid = valid & (cbest * (1.0 + uniqueness) <= second)
    return disp, valid, cbest


def right_disparity_from_volume(agg: jax.Array) -> jax.Array:
    """Right-view disparity reusing the left cost volume:
    costR(y, x, d) = costL(y, x + d, d) — per disparity a static left-shift
    of one volume slice, merged by a running min/argmin (no stacked [H, W, D]
    copy). Ascending k with a strict `<` keeps the first minimum, exactly
    jnp.argmin's tie-break."""
    h, w, d = agg.shape
    best = jnp.full((h, w), jnp.inf, agg.dtype)
    bestd = jnp.zeros((h, w), jnp.float32)
    for k in range(d):
        kk = min(k, w)  # disparities beyond the width are fully out of bounds
        shifted = jnp.pad(
            agg[:, kk:, k], ((0, 0), (0, kk)), constant_values=jnp.inf
        )
        upd = shifted < best
        best = jnp.where(upd, shifted, best)
        bestd = jnp.where(upd, jnp.float32(k), bestd)
    return bestd


def lr_consistency(
    disp_l: jax.Array, disp_r: jax.Array, threshold: float, num_disparities: Optional[int] = None
) -> jax.Array:
    """Validity mask: |dL(x) − dR(x − dL(x))| ≤ threshold, with the right
    column ``round(x − dL)`` clamped to the image and required to lie within
    ``num_disparities`` (default: the width) of ``x``."""
    h, w = disp_l.shape
    if num_disparities is None:
        num_disparities = int(w)
    x = jnp.arange(w, dtype=jnp.float32)[None, :]
    xr = jnp.clip(jnp.round(x - disp_l), 0.0, float(w - 1))  # target column per pixel
    dr = jnp.take_along_axis(disp_r, xr.astype(jnp.int32), axis=1)
    reach = (xr <= x) & (xr >= jnp.maximum(x - (num_disparities - 1), 0.0))
    return reach & (jnp.abs(disp_l - dr) <= threshold)


def fill_invalid(disp: jax.Array, valid: jax.Array) -> jax.Array:
    """Fill invalid pixels with the nearer (smaller) of the nearest valid
    disparities to the left and right along the scanline — the standard
    occlusion fill, as two associative scans (no serial loop)."""
    w = disp.shape[1]

    def scan_fill(d, v, reverse):
        def combine(a, b):
            # carry the most recent valid value in scan direction
            val_a, has_a = a
            val_b, has_b = b
            return jnp.where(has_b, val_b, val_a), has_a | has_b

        vals = jnp.where(v, disp, 0.0)
        filled, has = jax.lax.associative_scan(
            combine, (vals, v), axis=1, reverse=reverse
        )
        return jnp.where(has, filled, jnp.inf)

    left_fill = scan_fill(disp, valid, reverse=False)
    right_fill = scan_fill(disp, valid, reverse=True)
    fill = jnp.minimum(left_fill, right_fill)
    fill = jnp.where(jnp.isfinite(fill), fill, 0.0)
    return jnp.where(valid, disp, fill)


# the 19-comparator median-of-9 sorting network (Smith); pairs (lo, hi)
_MEDIAN9_NET = (
    (1, 2), (4, 5), (7, 8),
    (0, 1), (3, 4), (6, 7),
    (1, 2), (4, 5), (7, 8),
    (0, 3), (5, 8), (4, 7),
    (3, 6), (1, 4), (2, 5),
    (4, 7), (4, 2), (6, 4),
    (4, 2),
)


def median3(disp: jax.Array) -> jax.Array:
    """3×3 median filter (edge-replicated borders) through the 19-exchange
    median-of-9 network: elementwise min/max that XLA fuses into one pass,
    the same value a full sort of the 9-neighborhood selects."""
    h, w = disp.shape
    padded = jnp.pad(disp, 1, mode="edge")
    p = [
        jax.lax.dynamic_slice(padded, (dy, dx), (h, w))
        for dy in range(3)
        for dx in range(3)
    ]
    for a, b in _MEDIAN9_NET:
        p[a], p[b] = jnp.minimum(p[a], p[b]), jnp.maximum(p[a], p[b])
    return p[4]


@partial(jax.jit, static_argnames=("cfg",))
def match_pair(left, right, cfg: MatchConfig = MatchConfig()) -> MatchResult:
    """Full dense matcher on a rectified pair (RGB or gray, any u8/float)."""
    lg = grayscale(left)
    rg = grayscale(right)
    vol = cost_volume(lg, rg, cfg)
    agg = box_aggregate(vol, cfg.window)
    disp, valid, cbest = wta(agg, cfg.subpixel, cfg.uniqueness)
    if cfg.lr_threshold is not None:
        disp_r = right_disparity_from_volume(agg)
        valid = valid & lr_consistency(disp, disp_r, cfg.lr_threshold, cfg.num_disparities)
    disp = fill_invalid(disp, valid)
    disp = median3(disp)
    return MatchResult(disparity=disp, valid=valid, cost=cbest)


def disparity_to_depth_u8(disp: jax.Array, num_disparities: int) -> jax.Array:
    """Scale disparity to the reference's u8 depth convention (larger = closer,
    reference src/depth_image.rs:118-129): linear to [0, 255]."""
    d = jnp.clip(disp, 0.0, float(num_disparities - 1))
    return jnp.round(d * (255.0 / float(num_disparities - 1))).astype(jnp.uint8)
