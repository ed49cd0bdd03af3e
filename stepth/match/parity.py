"""Device-side parity pipeline: the reference's depth-from-additional flow
(reference src/depth_image.rs:91-136) as one jit-able JAX program, bit-exact
against the NumPy oracle (stepth/oracle/).

Design (SURVEY.md §7 step 4, "hard parts"): the reference's data-dependent
recursion (disage subdivision) and early-exit ring search become

* **subdivision**: per-level block statistics over *static* product grids
  (level-k boundaries are ``floor(i*n/2^k)``, data-independent), computed with
  segment reductions; a pixel's leaf level is the first homogeneous level — a
  static unrolled loop over at most ~log2(H*W) levels;
* **matching**: every pixel carries its leaf's (value, seed); the expanding ring
  search becomes a two-phase scan with the exact first-match priority encoded as
  an integer key (quirk Q8 rank): phase A evaluates a dense square window up to
  ``phase_a_radius`` in one pass; phase B continues ring-by-ring in a
  ``lax.while_loop`` that stops when every pixel has matched or proven
  out-of-bounds — the dense analog of the reference's early exits.

Everything is static-shape; no host syncs inside the pipeline.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from stepth.oracle.subdivision import default_max_splits, level_geometry

_BIG = np.int32(1 << 30)  # numpy, not jnp: avoid backend init at import


class LeafMaps(NamedTuple):
    """Per-pixel leaf-block description (device arrays [H, W])."""

    value: jax.Array  # i32[H, W, 3]
    seed_x: jax.Array  # i32[H, W]
    seed_y: jax.Array  # i32[H, W]
    level: jax.Array  # i32[H, W]


@partial(jax.jit, static_argnames=("min_splits", "max_splits"))
def subdivide(rgb, precision, min_splits: int = 16, max_splits: Optional[int] = None) -> LeafMaps:
    """JAX twin of oracle.subdivision.subdivide (docs/SEMANTICS.md §2)."""
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    if max_splits is None:
        max_splits = default_max_splits(h, w)
    eff_min = min(min_splits, max_splits)
    width_first = w >= h
    img = jnp.asarray(rgb).astype(jnp.int32)
    prec = jnp.asarray(precision, dtype=jnp.int32).reshape(3)

    level = jnp.full((h, w), -1, dtype=jnp.int32)
    value = jnp.zeros((h, w, 3), dtype=jnp.int32)
    seed_x = jnp.zeros((h, w), dtype=jnp.int32)
    seed_y = jnp.zeros((h, w), dtype=jnp.int32)

    for d in range(eff_min, max_splits + 1):
        rb, cb, row_ids, col_ids = level_geometry(h, w, d, width_first)  # static numpy
        nr, nc = len(rb) - 1, len(cb) - 1
        rid = jnp.asarray(row_ids, dtype=jnp.int32)
        cid = jnp.asarray(col_ids, dtype=jnp.int32)

        def seg2(op, x, mode):
            # reduce rows then cols with the given segment op
            a = op(x, rid, num_segments=nr, indices_are_sorted=True)
            a = jnp.swapaxes(a, 0, 1)
            a = op(a, cid, num_segments=nc, indices_are_sorted=True)
            return jnp.swapaxes(a, 0, 1)  # [nr, nc, ...]

        bmin = seg2(jax.ops.segment_min, img, "min")
        bmax = seg2(jax.ops.segment_max, img, "max")
        bsum = seg2(jax.ops.segment_sum, img, "sum")
        homog = ((bmax - bmin) <= prec).all(axis=-1)  # [nr, nc]

        rsz = np.diff(rb).astype(np.int64)
        csz = np.diff(cb).astype(np.int64)
        area = jnp.asarray((rsz[:, None] * csz[None, :]).astype(np.int32))
        bmean = bsum // area[..., None]
        # quirk Q1 seeds (reference src/depth_image.rs:114-117), static per block
        sx_b = jnp.asarray(((cb[:-1] + csz) // 2).astype(np.int32))  # (x0 + bw) // 2
        sy_b = jnp.asarray(((rb[:-1] + rsz) // 2).astype(np.int32))

        hpix = homog[rid][:, cid]
        newly = (level < 0) & (hpix | (d == max_splits))
        level = jnp.where(newly, d, level)
        vpix = bmean[rid][:, cid]
        value = jnp.where(newly[..., None], vpix, value)
        seed_x = jnp.where(newly, sx_b[cid][None, :], seed_x)
        seed_y = jnp.where(newly, sy_b[rid][:, None], seed_y)

    return LeafMaps(value=value, seed_x=seed_x, seed_y=seed_y, level=level)


def _ring_rank_np(dy: int, dx: int) -> int:
    """Scan-order rank of an offset within its Chebyshev ring (quirk Q8):
    row +r, row -r, col +r, col -r; within a segment, ascending sweep.
    Corners take their earliest visit."""
    r = max(abs(dy), abs(dx))
    width = 2 * r + 1
    ranks = []
    if dy == r:
        ranks.append(0 * width + (dx + r))
    if dy == -r:
        ranks.append(1 * width + (dx + r))
    if dx == r:
        ranks.append(2 * width + (dy + r))
    if dx == -r:
        ranks.append(3 * width + (dy + r))
    return min(ranks)


def _phase_a_offsets(radius: int, max_radius: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All offsets with Chebyshev radius <= ``radius`` with global priority keys
    key = r * (4*(2*max_radius+1)) + ring_rank (monotone across rings)."""
    stride = 4 * (2 * max_radius + 1)
    dys, dxs, keys = [], [], []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r = max(abs(dy), abs(dx))
            dys.append(dy)
            dxs.append(dx)
            keys.append(r * stride + _ring_rank_np(dy, dx))
    order = np.argsort(keys)
    return (
        np.asarray(dys, np.int32)[order],
        np.asarray(dxs, np.int32)[order],
        np.asarray(keys, np.int32)[order],
    )


def _isqrt(d2: jax.Array) -> jax.Array:
    """Exact floor(sqrt) for int32 inputs < 2^20 via f32 sqrt + one correction."""
    s = jnp.sqrt(d2.astype(jnp.float32)).astype(jnp.int32)
    s = s - (s * s > d2).astype(jnp.int32)
    s = s + ((s + 1) * (s + 1) <= d2).astype(jnp.int32)
    return s


def _probe(py, px, rank_key, best, cy, cx, val, add_flat, prec, ah, aw):
    """Evaluate one offset position for every pixel; keep the min key."""
    best_key, best_dy, best_dx = best
    inb = (py >= 0) & (py < ah) & (px >= 0) & (px < aw)
    idx = jnp.clip(py, 0, ah - 1) * aw + jnp.clip(px, 0, aw - 1)
    cand = add_flat[idx]
    ok = inb & (jnp.abs(cand - val) < prec).all(axis=-1)
    upd = ok & (rank_key < best_key)
    return (
        jnp.where(upd, rank_key, best_key),
        jnp.where(upd, py - cy, best_dy),
        jnp.where(upd, px - cx, best_dx),
    )


@partial(jax.jit, static_argnames=("max_radius", "phase_a_radius", "ah", "aw"))
def _phase_a(leaf, add_flat, prec, max_radius, phase_a_radius, ah, aw):
    n = leaf.seed_x.size
    cx = leaf.seed_x.reshape(-1)
    cy = leaf.seed_y.reshape(-1)
    val = leaf.value.reshape(-1, 3)
    r_hi = max_radius - 1
    ra = min(phase_a_radius, r_hi)
    dys, dxs, keys = _phase_a_offsets(ra, max_radius)
    dys_j, dxs_j, keys_j = jnp.asarray(dys), jnp.asarray(dxs), jnp.asarray(keys)

    def body_a(k, best):
        return _probe(
            cy + dys_j[k], cx + dxs_j[k], keys_j[k], best,
            cy, cx, val, add_flat, prec, ah, aw,
        )

    init = (jnp.full((n,), _BIG), jnp.zeros((n,), jnp.int32), jnp.zeros((n,), jnp.int32))
    best_key, best_dy, best_dx = jax.lax.fori_loop(0, len(dys), body_a, init)
    matched = best_key < _BIG
    # per-pixel last ring with any in-bounds point (docs/SEMANTICS.md §3)
    r_out = jnp.maximum(jnp.maximum(cy, ah - 1 - cy), jnp.maximum(cx, aw - 1 - cx))
    return matched, best_dy, best_dx, r_out


@partial(jax.jit, static_argnames=("rings", "width_bound", "r_hi", "ah", "aw"))
def _phase_b_block(r0, state, leaf, add_flat, prec, rings, width_bound, r_hi, ah, aw):
    """``rings`` consecutive search rings starting at traced radius ``r0``.

    Identical per-ring merge semantics to a monolithic while_loop; chunking
    keeps each dispatch under a fixed work budget and lets the host early-exit
    between blocks (the reference's per-block early-out,
    src/helpers.rs:49-51, amortized). ``width_bound`` is a static (bucketed)
    bound on 2·r+1 within the block, so small rings don't sweep the full
    509-probe row."""
    cx = leaf.seed_x.reshape(-1)
    cy = leaf.seed_y.reshape(-1)
    val = leaf.value.reshape(-1, 3)
    n = cx.size

    def body_ring(i, st):
        matched, bdy, bdx = st
        r = r0 + i
        width = 2 * r + 1
        ok_r = r <= r_hi

        def body_t(t, best):
            tv = t - r  # sweep coordinate in [-r, r]; mask t > 2r
            ok_t = ok_r & (t < width)
            key0 = jnp.where(ok_t, 0 * width + t, _BIG)
            key1 = jnp.where(ok_t, 1 * width + t, _BIG)
            key2 = jnp.where(ok_t, 2 * width + t, _BIG)
            key3 = jnp.where(ok_t, 3 * width + t, _BIG)
            args = (cy, cx, val, add_flat, prec, ah, aw)
            best = _probe(cy + r, cx + tv, key0, best, *args)  # row y+r
            best = _probe(cy - r, cx + tv, key1, best, *args)  # row y-r
            best = _probe(cy + tv, cx + r, key2, best, *args)  # col x+r
            best = _probe(cy + tv, cx - r, key3, best, *args)  # col x-r
            return best

        ring_init = (
            jnp.full((n,), _BIG),
            jnp.zeros((n,), jnp.int32),
            jnp.zeros((n,), jnp.int32),
        )
        rk, rdy, rdx = jax.lax.fori_loop(0, width_bound, body_t, ring_init)
        newly = (~matched) & (rk < _BIG)
        return matched | newly, jnp.where(newly, rdy, bdy), jnp.where(newly, rdx, bdx)

    return jax.lax.fori_loop(0, rings, body_ring, state)


# per-dispatch probe budget (ring-width × pixels × 4 sides); ~a few seconds
# of device time — far under the remote watchdog that kills long dispatches
_PHASE_B_WORK = 1.5e9


def _phase_b_plan(r: int, r_hi: int, n: int):
    """(rings, width_bound) for the block starting at ring ``r``: as many
    rings as fit the work budget (power-of-two, ≤32, so the jit cache stays
    small), and the smallest power-of-two width bucket ≥ the block's widest
    ring."""
    rings = max(1, int(_PHASE_B_WORK // (4 * (2 * r + 1) * max(n, 1))))
    rings = min(32, 1 << (rings.bit_length() - 1))
    r_end = min(r + rings - 1, r_hi)
    width_bound = 64
    while width_bound < 2 * r_end + 1:
        width_bound *= 2
    return rings, width_bound


def match_distance(
    leaf: LeafMaps,
    add_rgb,
    precision,
    max_radius: int = 255,
    phase_a_radius: int = 16,
):
    """Raw per-pixel matched distance map (quirk Q2: wrapped to u8), the dense
    equivalent of HOT LOOPs 1-2 (reference src/depth_image.rs:111-123,
    src/helpers.rs:9-54).

    Host-driven: phase A (dense window) is one dispatch; phase B sweeps the
    remaining rings in work-budgeted blocks with an early-exit readback
    between blocks — see :func:`_phase_b_block` for why."""
    h, w = int(leaf.seed_x.shape[0]), int(leaf.seed_x.shape[1])
    add = jnp.asarray(add_rgb).astype(jnp.int32)
    ah, aw = int(add.shape[0]), int(add.shape[1])
    add_flat = add.reshape(-1, 3)
    prec = jnp.asarray(precision, dtype=jnp.int32).reshape(3)

    r_hi = max_radius - 1  # rings are 0..max_radius-1 (src/helpers.rs:26)
    ra = min(phase_a_radius, r_hi)

    matched, best_dy, best_dx, r_out = _phase_a(
        leaf, add_flat, prec, max_radius, phase_a_radius, ah, aw
    )
    state = (matched, best_dy, best_dx)
    r = ra + 1
    n = h * w
    while r <= r_hi:
        # the original while_loop's condition, evaluated between blocks
        if not bool(jnp.any((~state[0]) & (r <= r_out))):
            break
        rings, width_bound = _phase_b_plan(r, r_hi, n)
        state = _phase_b_block(
            jnp.int32(r), state, leaf, add_flat, prec,
            rings, width_bound, r_hi, ah, aw,
        )
        r += rings
    matched, best_dy, best_dx = state

    d2 = best_dy * best_dy + best_dx * best_dx
    dist = _isqrt(d2)
    dist = jnp.where(matched, dist, 0)  # unwrap_or(u32::MIN) at :120
    return (dist & 0xFF).astype(jnp.uint8).reshape(h, w)  # quirk Q2


@partial(jax.jit, static_argnames=("h", "w"))
def _normalize_and_resample(raw, h, w):
    from stepth.ops.resize import resample_exact

    m = jnp.max(raw).astype(jnp.int32)
    norm = jnp.where(
        m > 0, (raw.astype(jnp.int32) * 255) // jnp.maximum(m, 1), 0
    ).astype(jnp.uint8)
    # collect(): norm is already painted at full res; gray -> luma is identity
    return resample_exact(norm, h, w, "gaussian")


def depth_from_additional(
    main_rgb,
    add_rgb,
    precision,
    min_splits: int = 16,
    max_splits: Optional[int] = None,
    max_radius: int = 255,
    phase_a_radius: int = 16,
):
    """Full parity pipeline: subdivision -> match -> max-normalize (quirk Q3
    guarded) -> same-size Gaussian resample (reference src/depth_image.rs:91-136).
    Returns depth u8[H, W]; bit-identical to
    oracle.pipeline.depth_from_additional_oracle.

    Host-driven (not one jit): the ring search dispatches in bounded blocks
    with a host early-exit between them — see :func:`match_distance`."""
    main_rgb = jnp.asarray(main_rgb)
    h, w = int(main_rgb.shape[0]), int(main_rgb.shape[1])
    prec = jnp.asarray(precision, dtype=jnp.int32).reshape(3)
    leaf = subdivide(main_rgb, prec, min_splits=min_splits, max_splits=max_splits)
    raw = match_distance(
        leaf, add_rgb, prec, max_radius=max_radius, phase_a_radius=phase_a_radius
    )
    return _normalize_and_resample(raw, h, w)
