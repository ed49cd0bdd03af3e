"""Coarse-to-fine hierarchical matcher.

A recast of disage's adaptive subdivision (reference src/depth_image.rs:104-109
and SURVEY.md §2.1 C7): instead of data-dependent recursive splits, a fixed-depth
image pyramid. The coarsest level runs a full matcher (exhaustive WTA,
:mod:`stepth.match.dense`, or SGM, :mod:`stepth.match.sgm`) over a small
disparity range; each finer level refines the 2×-upsampled estimate within
per-tile search windows — so per-level work is O(H·W·(2R+1)) instead of
O(H·W·D), and the sharding halo is bounded by the box window instead of the
full search range (SURVEY.md §7 "hard parts").

The refine-level contract (shared by the ``jnp`` reference below and the
Pallas kernel in :mod:`stepth.match.refine_triton`):

* The image is cut into (``tile_rows`` × 128) tiles. Each tile gets a window
  plan from :func:`tile_windows_from_prior`: up to ``K`` window bases and the
  number ``nw`` to run. Window ``k`` searches ``s = base_k + o`` for
  ``o = −R..R``.
* Per tile, costs live on a 256-column cost region starting ``M`` columns left
  of the tile (``M = round_up(2·(window//2), 8)``), with the rows of the tile
  plus ``window//2`` rows each side. Costs are ``sad``, ``ssd`` or ``census``
  (Hamming distance of u32 census planes computed on the edge-extended
  image). A candidate whose right sample falls outside the image costs 1e6;
  cost at out-of-image pixels (real rows/cols, or global rows outside
  ``[0, g_h)`` for row shards) is zero. Box sums never cross a base change:
  they are taken inside the tile's own region, vertically then horizontally
  (the horizontal sum wraps around the 256-column region, which only touches
  the right-view candidates at the region's outer columns), in a fixed
  summation order (two-stage 3×3 for ``window=9``, sequential otherwise).
* Windows run in plan order and offsets ascend; the first strictly smaller
  cost wins. Subpixel fitting pairs offsets only inside one window.
* ``lr=True`` also returns the right-view disparity: ``costR(u, s) =
  costL(u+s, s)`` with the minimum taken over every tile window that covers
  ``u`` (first win in (column tile, window, offset) order), −1e6 where none
  does.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp

from stepth.config import MatchConfig, PyramidConfig
from stepth.match import dense

_TW = 128  # tile width: one window plan per (tile_rows × 128) tile
_CW = 256  # cost-region width per tile
_BIG = 1e30
_BAD = 1e6  # cost of a candidate whose right sample leaves the image
_NO_MATCH = -1e6  # right-view disparity where no window covered the column


def downsample2(gray: jax.Array) -> jax.Array:
    """2×2 average pool (odd trailing row/col dropped) via strided adds."""
    h, w = gray.shape
    h2, w2 = h // 2, w // 2
    g = gray[: h2 * 2, : w2 * 2]
    v = g[0::2] + g[1::2]
    return (v[:, 0::2] + v[:, 1::2]) * 0.25


def upsample2_disparity(disp: jax.Array, h: int, w: int) -> jax.Array:
    """Nearest-neighbor 2× upsample of a disparity map to (h, w); disparity
    values double because pixel coordinates double."""
    up = jnp.repeat(jnp.repeat(disp, 2, axis=0), 2, axis=1) * 2.0
    # pad/crop to the exact target dims (odd sizes)
    up = up[:h, :w]
    ph, pw = h - up.shape[0], w - up.shape[1]
    if ph or pw:
        up = jnp.pad(up, ((0, ph), (0, pw)), mode="edge")
    return up


def tile_windows_from_prior(
    prior, tile_rows: int, max_base: int, radius: int, max_windows: int
):
    """Adaptive per-tile search-window plan: ``(bases, nw)`` with ``bases``
    i32[nr, nc, K] window-base disparities and ``nw`` i32[nr, nc] the number
    to run. ``prior`` is f32[hp, wp] with ``hp % tile_rows == 0`` and
    ``wp % 128 == 0``.

    Tiles whose prior spread fits one ``mean ± radius`` window get ``nw=1,
    bases[0]=round(mean)``. For tiles spanning a disparity discontinuity, the
    coverage targets are the tile's 8×8-subtile prior means — the actual
    disparity mass, robust to per-pixel prior noise — and window bases are a
    greedy interval cover of those targets: repeatedly center a ``± radius``
    window on the lowest uncovered group (optimal for interval covering). A
    bimodal depth-edge tile therefore gets one window per surface mode, and
    an extreme unimodal ramp gets windows tiled across its span, up to the
    ``max_windows`` cap.

    ``K`` is ``max_windows`` clamped to ``ceil((max_base+1)/(2·radius+1))``
    — the greedy cover of targets in ``[0, max_base]`` never needs more,
    because consecutive greedy centers are > 2·radius apart — and at least 2
    (a second, never-run slot when the cap is 1)."""
    hp, wp = prior.shape
    nr, nc = hp // tile_rows, wp // _TW
    t = prior.reshape(nr, tile_rows, nc, _TW)
    mean = t.mean(axis=(1, 3))
    b_mean = jnp.clip(jnp.round(mean), 0, max_base).astype(jnp.int32)
    max_windows = min(max_windows, -(-(max_base + 1) // (2 * radius + 1)))
    if max_windows <= 1:
        bases = jnp.broadcast_to(b_mean[..., None], (*b_mean.shape, 2))
        return bases, jnp.ones_like(b_mean)
    pooled = jax.lax.reduce_window(
        prior, 0.0, jax.lax.add, (8, 8), (8, 8), "VALID"
    ) * (1.0 / 64.0)
    sub = pooled.reshape(nr, tile_rows // 8, nc, _TW // 8)
    sub = sub.transpose(0, 2, 1, 3).reshape(nr, nc, -1)  # [nr, nc, n_sub]
    pmin = sub.min(axis=-1)
    pmax = sub.max(axis=-1)
    blo_c = jnp.minimum(jnp.clip(jnp.floor(pmin), 0, max_base), b_mean)
    bhi_c = jnp.maximum(jnp.clip(jnp.ceil(pmax), 0, max_base), b_mean)
    one = (b_mean - blo_c <= radius) & (bhi_c - b_mean <= radius)

    big = jnp.float32(1e30)
    uncov = jnp.full(sub.shape, True)
    bases = []
    nw = jnp.zeros(b_mean.shape, jnp.int32)
    for _ in range(max_windows):
        v = jnp.where(uncov, sub, big).min(axis=-1)  # lowest uncovered target
        any_u = v < big
        # center the window on the uncovered group reachable from v
        vhi = jnp.where(uncov & (sub <= v[..., None] + 2 * radius), sub, -big)
        vhi = jnp.maximum(vhi.max(axis=-1), v)
        c = jnp.clip(jnp.round((v + vhi) * 0.5), 0, max_base).astype(jnp.int32)
        bases.append(c)
        nw = nw + any_u.astype(jnp.int32)
        uncov = uncov & (sub > c[..., None].astype(jnp.float32) + radius)
    bases = jnp.stack(bases, axis=-1)  # [nr, nc, K]
    # smooth tiles: one window at the rounded tile mean
    bases = jnp.where(one[..., None], b_mean[..., None], bases)
    nw = jnp.where(one, 1, jnp.maximum(nw, 1))
    return bases, nw


class RefineGeometry(NamedTuple):
    """Static layout of one refine level (see the module docstring)."""

    h: int  # real rows
    w: int  # real cols
    th: int  # tile rows
    hp: int  # rows padded to a tile multiple
    wp: int  # cols padded to a tile multiple
    rbox: int  # box-window radius
    m: int  # cost-region margin left of the tile
    pad_l: int  # source columns left of image column 0
    radius: int
    window: int
    squared: bool  # ssd

    @property
    def nr(self) -> int:
        return self.hp // self.th

    @property
    def nc(self) -> int:
        return self.wp // _TW


def refine_geometry(
    h: int, w: int, cfg: MatchConfig, radius: int, max_base: int, tile_rows: int
) -> RefineGeometry:
    if cfg.cost not in ("sad", "ssd", "census"):
        raise NotImplementedError(f"refine: cost {cfg.cost!r} unsupported")
    rbox = cfg.window // 2
    m = -(-2 * rbox // 8) * 8
    if m + _TW + 2 * rbox > _CW:
        raise ValueError(f"window {cfg.window} too wide for the {_CW} cost region")
    th = -(-tile_rows // 8) * 8
    return RefineGeometry(
        h=h, w=w, th=th, hp=-(-h // th) * th, wp=-(-w // _TW) * _TW, rbox=rbox,
        m=m, pad_l=m + max_base + radius, radius=radius, window=cfg.window,
        squared=cfg.cost == "ssd",
    )


def refine_sources(gray: jax.Array, cfg: MatchConfig, geo: RefineGeometry):
    """Edge-extended matching source for one view: rows ``[−rbox, hp+rbox)``
    and columns ``[−pad_l, wp+_CW−m+radius)`` of the image. Gray f32
    [rows, cols] for sad/ssd; u32 census planes [P, rows, cols] for census
    (the census of the edge-extended image, so out-of-image samples see the
    same descriptors whatever the padding)."""
    pad_r = geo.wp - geo.w + _CW - geo.m + geo.radius
    src = jnp.pad(
        gray.astype(jnp.float32),
        ((geo.rbox, geo.hp - geo.h + geo.rbox), (geo.pad_l, pad_r)),
        mode="edge",
    )
    if cfg.cost == "census":
        return jnp.moveaxis(dense.census_transform(src, cfg.census_window), -1, 0)
    return src


def box_sum(cost: jax.Array, window: int, axis: int, wrap: bool) -> jax.Array:
    """Box sum along ``axis`` in the contract's summation order. ``wrap``:
    circular (the horizontal region sum); otherwise the output drops
    ``window//2`` entries at each end (the vertical halo)."""
    rbox = window // 2
    n = cost.shape[axis]

    def shifted(x, j, lo, hi):  # x[i + j] for every output i (i in [lo, n-hi))
        if wrap:
            return jnp.roll(x, -j, axis=axis)
        return jax.lax.slice_in_dim(x, lo + j, x.shape[axis] - hi + j, axis=axis)

    if window == 9:  # two-stage 3×3
        y = shifted(cost, 0, 1, 1) + shifted(cost, -1, 1, 1) + shifted(cost, 1, 1, 1)
        return shifted(y, 0, 3, 3) + shifted(y, -3, 3, 3) + shifted(y, 3, 3, 3)
    z = jnp.zeros_like(shifted(cost, 0, rbox, rbox))
    for j in range(-rbox, rbox + 1):
        z = z + shifted(cost, j, rbox, rbox)
    return z


def _gather_rows_cols(src, rows, cols):
    """src[..., rows, cols] for broadcastable index arrays."""
    if src.ndim == 3:
        return src[:, rows, cols]
    return src[rows, cols]


def refine_tiles_reference(
    src_l, src_r, bases, nw, geo: RefineGeometry, g_row0=0, g_h=None,
    lr: bool = False, subpixel: bool = True,
):
    """Plain ``jnp`` refine of every tile (the CPU path and the reference the
    Pallas kernel is checked against). Returns the left disparity f32[hp, wp]
    and, for ``lr``, the per-window right-view minima ``(val, s)``, each
    f32[K, nr, nc, th, 256] (see :func:`merge_right_view`)."""
    if g_h is None:
        g_h = geo.h
    nr, nc, th, m, R = geo.nr, geo.nc, geo.th, geo.m, geo.radius
    K = bases.shape[-1]
    S = th + 2 * geo.rbox
    ti = jnp.arange(nr)[:, None] * th + jnp.arange(S)[None, :]  # source rows
    rows = ti[:, None, :, None]  # [nr, 1, S, 1]
    x = jnp.arange(nc)[:, None] * _TW - m + jnp.arange(_CW)[None, :]  # [nc, CW]
    lblk = _gather_rows_cols(src_l, rows, (x + geo.pad_l)[None, :, None, :])
    lrow = ti - geo.rbox
    grow = g_row0 + lrow
    row_ok = (lrow >= 0) & (lrow < geo.h) & (grow >= 0) & (grow < g_h)
    col_ok = (x >= 0) & (x < geo.w)
    zmask = (row_ok[:, None, :, None] & col_ok[None, :, None, :]).astype(jnp.float32)
    q = jnp.arange(_CW)

    def candidate(s):  # s: i32[nr, nc] -> aggregated cost [nr, nc, th, CW]
        xs = x[None] - s[..., None]  # [nr, nc, CW]
        rblk = _gather_rows_cols(src_r, rows, (xs + geo.pad_l)[:, :, None, :])
        if src_l.ndim == 3:
            ham = jnp.zeros(lblk.shape[1:], jnp.int32)
            for p in range(src_l.shape[0]):
                ham = ham + jax.lax.population_count(lblk[p] ^ rblk[p]).astype(
                    jnp.int32
                )
            cost = ham.astype(jnp.float32)
        else:
            diff = lblk - rblk
            cost = diff * diff if geo.squared else jnp.abs(diff)
        bad = (xs < 0) | (xs >= geo.w)
        cost = jnp.where(bad[:, :, None, :], _BAD, cost) * zmask
        aggv = box_sum(cost, geo.window, axis=2, wrap=False)
        return box_sum(aggv, geo.window, axis=3, wrap=True), bad

    def window(state, k):
        best, bests, oi_s, wbest, cm1, cb, cp1 = state
        run = (k < nw)[..., None, None]
        base = jnp.take(bases, k, axis=2)
        prev = jnp.zeros(best.shape, jnp.float32)
        if lr:
            b_r = jnp.full((nr, nc, th, _CW), _BIG, jnp.float32)
            a_r = jnp.full((nr, nc, th, _CW), _NO_MATCH, jnp.float32)
        for o in range(-R, R + 1):
            s = base + o
            agg, bad = candidate(s)
            aggc = agg[..., m : m + _TW]
            oi = o + R
            upd = (aggc < best) & run
            is_next = ~upd & run & (wbest == k) & (oi_s == oi - 1)
            cm1 = jnp.where(upd, prev, cm1)
            cb = jnp.where(upd, aggc, cb)
            cp1 = jnp.where(is_next, aggc, cp1)
            best = jnp.where(upd, aggc, best)
            bests = jnp.where(upd, s[..., None, None], bests)
            oi_s = jnp.where(upd, oi, oi_s)
            wbest = jnp.where(upd, k, wbest)
            prev = aggc
            if lr:
                # shifting frame: b_r[q] = min_o contrib_o[q − 2R + o + R]
                invalid = (bad | ~col_ok[None])[:, :, None, :]
                contrib = jnp.where(invalid, _BIG, agg)
                b_sh = jnp.roll(b_r, 1, axis=3)
                a_sh = jnp.roll(a_r, 1, axis=3)
                updr = contrib < b_sh
                b_r = jnp.where(updr, contrib, b_sh)
                a_r = jnp.where(updr, s[..., None, None].astype(jnp.float32), a_sh)
        state = (best, bests, oi_s, wbest, cm1, cb, cp1)
        if not lr:
            return state, None
        b_r = jnp.where((q < 2 * R) | ~run, _BIG, b_r)
        return state, (b_r, a_r)

    shape = (nr, nc, th, _TW)
    state0 = (
        jnp.full(shape, _BIG, jnp.float32),
        jnp.zeros(shape, jnp.int32),
        jnp.full(shape, -2, jnp.int32),
        jnp.full(shape, -1, jnp.int32),
        jnp.zeros(shape, jnp.float32),
        jnp.full(shape, _BIG, jnp.float32),
        jnp.full(shape, _BIG, jnp.float32),
    )
    (best, bests, oi_s, _, cm1, cb, cp1), right = jax.lax.scan(
        window, state0, jnp.arange(K)
    )
    disp = _subpixel(bests, oi_s, cm1, cb, cp1, R, geo.w, subpixel)
    disp = disp.transpose(0, 2, 1, 3).reshape(geo.hp, geo.wp)
    return disp, right


def _subpixel(bests, oi, cm1, cb, cp1, R, w, subpixel):
    denom = cm1 - 2.0 * cb + cp1
    delta = jnp.where(jnp.abs(denom) > 1e-6, (cm1 - cp1) / (2.0 * denom), 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    interior = (oi >= 1) & (oi <= 2 * R - 1) & subpixel
    dval = bests.astype(jnp.float32)
    dval = jnp.where(interior, dval + delta, dval)
    return jnp.clip(dval, 0.0, float(w - 1))


def merge_right_view(val, s, bases, nw, geo: RefineGeometry) -> jax.Array:
    """Right-view disparity f32[hp, wp] from per-window minima ``val``/``s``
    f32[K, nr, nc, th, 256]: entry ``q`` of window ``k`` of tile ``(i, jc)``
    is the candidate for right column ``u = jc·128 − m + q − base − R`` on
    row ``i·th + t``. The minimum over all of them wins, the first in
    (column tile, window) order on ties; entries of windows ``k ≥ nw`` are
    ignored (they may hold anything).

    Gathers, not scatters: for each right column the covering tiles are
    ``jc = u//128 + dj`` for a few static ``dj``, so every output reads its
    candidates in order and no two outputs write the same place."""
    K, nr, nc, th, cw = val.shape
    m, R = geo.m, geo.radius
    max_base = geo.pad_l - m - R
    u = jnp.arange(geo.wp)[None, :]
    rows = jnp.arange(geo.hp)[:, None]
    i, t = rows // th, rows % th
    val, s = val.reshape(-1), s.reshape(-1)
    best = jnp.full((geo.hp, geo.wp), _BIG, jnp.float32)
    out = jnp.full((geo.hp, geo.wp), _NO_MATCH, jnp.float32)
    # q = u − jc·128 + m + base + R must land in [0, 256)
    dj_lo = -((255 - m - R) // _TW)
    dj_hi = (_TW - 1 + m + max_base + R) // _TW
    for dj in range(dj_lo, dj_hi + 1):
        jc = u // _TW + dj
        jcc = jnp.clip(jc, 0, nc - 1)
        tile_ok = (jc >= 0) & (jc < nc)
        nw_t = nw[i, jcc]
        for k in range(K):  # unrolled: no per-window host round trip
            q = u - jcc * _TW + m + bases[i, jcc, k] + R
            ok = tile_ok & (k < nw_t) & (q >= 0) & (q < cw)
            idx = (((k * nr + i) * nc + jcc) * th + t) * cw + jnp.clip(q, 0, cw - 1)
            v = jnp.where(ok, val[idx], _BIG)
            upd = v < best
            best = jnp.where(upd, v, best)
            out = jnp.where(upd, s[idx], out)
    return out


def refine_impl() -> str:
    """The refine implementation for this platform: ``"triton"`` (the
    compiled kernel) on a GPU, ``"reference"`` (plain ``jnp``) on the CPU.
    Other platforms have none. The kernel's interpret mode
    (``"interpret"``) runs only when a caller names it."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "reference"
    raise NotImplementedError(f"no refine implementation for platform {platform!r}")


def refine_level(
    left_g,
    right_g,
    prior,
    cfg: MatchConfig,
    radius: int,
    max_base: int,
    tile_rows: int = 64,
    g_row0=0,
    g_h: Optional[int] = None,
    lr: bool = False,
    max_windows: int = 16,
    impl: Optional[str] = None,
):
    """Refine ``prior`` (f32[H, W]) on one level of gray ``left_g/right_g``
    under the module's tile contract; returns f32[H, W], or ``(disp, dR)``
    with ``lr=True``. ``g_row0``/``g_h``: the global row window when the
    inputs are a halo-extended row shard of a larger image. ``max_windows``
    caps the per-tile window plan (1: one base per tile). ``impl`` names the
    implementation (``"triton"``, ``"reference"`` or ``"interpret"``);
    by default :func:`refine_impl` picks it."""
    h, w = left_g.shape
    geo = refine_geometry(h, w, cfg, radius, max_base, tile_rows)
    prior_p = jnp.pad(prior, ((0, geo.hp - h), (0, geo.wp - w)), mode="edge")
    bases, nw = tile_windows_from_prior(prior_p, geo.th, max_base, radius, max_windows)
    src_l = refine_sources(left_g, cfg, geo)
    src_r = refine_sources(right_g, cfg, geo)
    impl = impl or refine_impl()
    if impl == "reference":
        disp, right = refine_tiles_reference(
            src_l, src_r, bases, nw, geo, g_row0, g_h, lr, cfg.subpixel
        )
    else:
        from stepth.match import refine_triton

        disp, right = refine_triton.refine_tiles(
            src_l, src_r, bases, nw, geo, g_row0, g_h, lr, cfg.subpixel,
            interpret=impl == "interpret",
        )
    if not lr:
        return disp[:h, :w]
    d_r = merge_right_view(*right, bases, nw, geo)
    return disp[:h, :w], d_r[:h, :w]


def coarse_config(cfg: MatchConfig, pyr: PyramidConfig) -> MatchConfig:
    """The matcher configuration of the coarsest pyramid level."""
    return MatchConfig(
        num_disparities=pyr.coarsest_disparities,
        window=cfg.window,
        cost=cfg.cost,
        census_window=cfg.census_window,
        subpixel=cfg.subpixel,
        lr_threshold=cfg.lr_threshold,
        uniqueness=cfg.uniqueness,
    )


def coarse_match(left_g, right_g, cfg: MatchConfig, coarse_backend: str, sgm=None):
    """The coarsest level: exhaustive WTA (``"wta"``) or SGM (``"sgm"``)."""
    if coarse_backend == "wta":
        return dense.match_pair(left_g, right_g, cfg)
    if coarse_backend == "sgm":
        from stepth.match import sgm as sgm_mod

        return sgm_mod.match_pair_sgm(
            left_g, right_g, cfg, sgm_mod.SGMConfig() if sgm is None else sgm
        )
    raise ValueError(f"coarse_backend must be 'wta' or 'sgm', got {coarse_backend!r}")


def upsample_valid(valid: jax.Array, h: int, w: int, times: int) -> jax.Array:
    """Nearest-neighbor ×2 upsample of a validity mask, ``times`` times, to
    (h, w)."""
    v = valid
    for _ in range(times):
        v = jnp.repeat(jnp.repeat(v, 2, axis=0), 2, axis=1)
    v = jnp.pad(
        v, ((0, max(0, h - v.shape[0])), (0, max(0, w - v.shape[1]))), mode="edge"
    )
    return v[:h, :w]


def lr_postprocess(disp, disp_r, cfg: MatchConfig, num_disparities: int):
    """Full-resolution LR check, occlusion fill and median."""
    thr = 1.0 if cfg.lr_threshold is None else float(cfg.lr_threshold)
    valid = dense.lr_consistency(disp, disp_r, thr, num_disparities)
    disp = dense.median3(dense.fill_invalid(disp, valid))
    return dense.MatchResult(disparity=disp, valid=valid, cost=jnp.zeros_like(disp))


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "pyr", "coarse_backend", "sgm", "lr_check", "tile_rows"
    ),
)
def match_hierarchical(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    coarse_backend: str = "wta",
    sgm=None,
    lr_check: bool = False,
    tile_rows: int = 64,
) -> dense.MatchResult:
    """Hierarchical dense match of a rectified pair. Same output contract as
    :func:`stepth.match.dense.match_pair`; the effective search range is
    ``coarsest_disparities × 2^(levels-1)``.

    ``coarse_backend="sgm"`` runs the semi-global matcher at the coarsest
    level (knobs via ``sgm``, an :class:`stepth.match.sgm.SGMConfig`): its
    smoother prior survives into the refine levels, so repetitive texture
    and low-contrast regions that alias under exhaustive WTA resolve to the
    coherent surface, and the coarse volume is 4^(levels−1)× smaller than
    full-resolution SGM's.

    ``lr_check=True``: the final refine level also returns its right-view
    disparity, and pixels failing the full-resolution left-right test are
    marked invalid and filled from their scanline neighbors. Otherwise the
    coarse level's LR/uniqueness validity is carried up (nearest-neighbor
    ×2 per level) — coarse-granularity occlusion flagging.

    ``tile_rows`` sets the refine tile height: disparity bases are constant
    per (``tile_rows`` × 128) tile."""
    lg = dense.grayscale(left)
    rg = dense.grayscale(right)
    lefts: List[jax.Array] = [lg]
    rights: List[jax.Array] = [rg]
    for _ in range(pyr.levels - 1):
        lefts.append(downsample2(lefts[-1]))
        rights.append(downsample2(rights[-1]))
    if lr_check and pyr.levels == 1:
        raise ValueError("lr_check needs at least one refine level")

    res = coarse_match(lefts[-1], rights[-1], coarse_config(cfg, pyr), coarse_backend, sgm)
    disp = res.disparity
    max_base = pyr.coarsest_disparities
    disp_r = None
    for lvl in range(pyr.levels - 2, -1, -1):
        h, w = lefts[lvl].shape
        prior = upsample2_disparity(disp, h, w)
        max_base = max_base * 2
        want_lr = lr_check and lvl == 0
        out = refine_level(
            lefts[lvl], rights[lvl], prior, cfg,
            pyr.final_radius if lvl == 0 else pyr.refine_radius, max_base,
            tile_rows, lr=want_lr,
            max_windows=pyr.final_windows if lvl == 0 else pyr.refine_windows,
        )
        disp, disp_r = out if want_lr else (out, None)

    if lr_check:
        return lr_postprocess(disp, disp_r, cfg, max_base)
    disp = dense.median3(disp)
    h, w = disp.shape
    valid = upsample_valid(res.valid, h, w, pyr.levels - 1) & (disp >= 0)
    return dense.MatchResult(disparity=disp, valid=valid, cost=jnp.zeros_like(disp))


def match_temporal(
    lefts,
    rights,
    cfg: MatchConfig = MatchConfig(),
    pyr: PyramidConfig = PyramidConfig(),
    keyframe_interval: int = 8,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    sgm=None,
    tile_rows: int = 64,
) -> dense.MatchResult:
    """Video stereo with temporal seeding, one ``lax.scan`` over the clip.

    ``lefts``/``rights``: stacked frames ``[T, H, W]`` (or ``[T, H, W, 3]``).
    Frame 0 and every ``keyframe_interval``-th frame run the full pyramid;
    every other frame runs ONLY the full-resolution refine level seeded by
    the previous frame's disparity — video disparity rarely moves more than
    the refine radius between frames, and the multi-window plan absorbs
    larger jumps near object boundaries as it absorbs spatial
    discontinuities. Regions whose disparity leaves the seeded window
    self-correct at the next keyframe; ``keyframe_interval=1`` is per-frame
    full pyramids. Returns a stacked :class:`MatchResult`."""
    if lefts.ndim not in (3, 4):
        raise ValueError(f"expected [T,H,W] or [T,H,W,C], got {lefts.shape}")
    if keyframe_interval < 1:
        raise ValueError(f"keyframe_interval must be >= 1, got {keyframe_interval}")
    max_base = pyr.coarsest_disparities << (pyr.levels - 1)

    def full(l, r, _prior):
        return match_hierarchical(
            l, r, cfg, pyr, coarse_backend, sgm, lr_check, tile_rows
        )

    def seeded(l, r, prior):
        out = refine_level(
            dense.grayscale(l), dense.grayscale(r), prior, cfg, pyr.final_radius,
            max_base, tile_rows, lr=lr_check, max_windows=pyr.final_windows,
        )
        if lr_check:
            return lr_postprocess(out[0], out[1], cfg, max_base)
        disp = dense.median3(out)
        return dense.MatchResult(
            disparity=disp, valid=disp >= 0, cost=jnp.zeros_like(disp)
        )

    def step(carry, lr_pair):
        prev, i = carry
        res = jax.lax.cond(
            i % keyframe_interval == 0,
            lambda: full(*lr_pair, prev),
            lambda: seeded(*lr_pair, prev),
        )
        return (res.disparity, i + 1), res

    h, w = lefts.shape[1:3]
    init = (jnp.zeros((h, w), jnp.float32), jnp.int32(0))
    _, out = jax.lax.scan(step, init, (lefts, rights))
    return out
