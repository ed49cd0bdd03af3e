"""Tile-sharded dense matching: ``shard_map`` over a device mesh with halo
exchange via ``ppermute``.

This is the spatial analog of sequence parallelism (SURVEY.md §5 "long-context"
row): image rows are sharded over the mesh ``tile`` axis; window aggregation,
census support, and the median filter need neighbor rows, which arrive as halos
between devices through ``lax.ppermute`` (ring-attention's communication pattern on 2-D
tiles). Batch pairs shard over the ``data`` axis. Global reductions (the
normalization max — reference src/depth_image.rs:124-129 — and brightness means,
src/operations.rs) ride ``psum``/``pmax`` collectives.

Seam exactness: cost contributions outside the real image are zeroed before
aggregation (matching the zero-pad clipping in
:func:`stepth.match.dense.box_aggregate`), and intensity halos at the true
image edges are edge-replicated (matching the unsharded ``pad(mode="edge")``
census/median semantics), so tiled output == untiled output bit-for-bit; tested
in tests/test_parallel.py.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from stepth.config import MatchConfig
from stepth.match import dense


def required_halo(cfg: MatchConfig) -> int:
    """Rows of neighbor context one tile needs: box window radius + census
    support radius (census only) + 1 for the 3×3 median."""
    r = cfg.window // 2
    if cfg.cost == "census":
        r += cfg.census_window // 2
    return r + 1


def halo_exchange_rows(x: jax.Array, halo: int, axis_name: str, edge: str = "zero"):
    """Return ``(top, bottom)`` halo slabs ([halo, ...]) received from the row
    neighbors along ``axis_name``. The first/last shards have no neighbor:
    ``edge="zero"`` leaves zeros, ``edge="replicate"`` repeats the shard's own
    boundary row (the unsharded ``pad(mode="edge")`` semantics)."""
    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    down = [(i, i + 1) for i in range(n - 1)]  # data flows toward larger idx
    up = [(i + 1, i) for i in range(n - 1)]
    top = lax.ppermute(x[-halo:], axis_name, down)  # my bottom rows → next's top
    bot = lax.ppermute(x[:halo], axis_name, up)  # my top rows → prev's bottom
    if edge == "replicate":
        top = jnp.where((idx == 0), jnp.broadcast_to(x[:1], x[:1].shape).repeat(halo, 0), top)
        bot = jnp.where((idx == n - 1), jnp.broadcast_to(x[-1:], x[-1:].shape).repeat(halo, 0), bot)
    return top, bot


def _with_halo(x, halo, axis_name, edge):
    top, bot = halo_exchange_rows(x, halo, axis_name, edge)
    return jnp.concatenate([top, x, bot], axis=0)


def _match_tile(l_blk, r_blk, cfg: MatchConfig, halo: int, h_total: int, axis_name: str):
    """Per-shard dense match on a row tile extended by ``halo`` rows each side.

    ``l_blk``/``r_blk``: f32[th, W(,C)] local gray/rgb rows."""
    th = l_blk.shape[0]
    idx = lax.axis_index(axis_name)
    row0 = idx * th  # global index of local row 0

    l_ext = _with_halo(l_blk, halo, axis_name, edge="replicate")
    r_ext = _with_halo(r_blk, halo, axis_name, edge="replicate")

    lg = dense.grayscale(l_ext)
    rg = dense.grayscale(r_ext)
    vol = dense.cost_volume(lg, rg, cfg)  # [th+2h, W, D]

    # zero out cost rows outside the real image so box sums match the
    # unsharded zero-pad clipping exactly
    gidx = row0 - halo + jnp.arange(th + 2 * halo)
    in_img = (gidx >= 0) & (gidx < h_total)
    vol = vol * in_img[:, None, None].astype(vol.dtype)

    agg_ext = dense.box_aggregate(vol, cfg.window)
    agg = agg_ext[halo : halo + th]

    disp, valid, cbest = dense.wta(agg, cfg.subpixel, cfg.uniqueness)
    if cfg.lr_threshold is not None:
        disp_r = dense.right_disparity_from_volume(agg)
        valid = valid & dense.lr_consistency(
            disp, disp_r, cfg.lr_threshold, cfg.num_disparities
        )
    disp = dense.fill_invalid(disp, valid)

    # median needs 1 row of disparity halo with edge semantics at real borders
    d_ext = _with_halo(disp, 1, axis_name, edge="replicate")
    disp = dense.median3(d_ext)[1 : 1 + th]
    return disp, valid, cbest


@partial(jax.jit, static_argnames=("cfg", "mesh", "halo"))
def match_pair_sharded(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    mesh: Optional[Mesh] = None,
    halo: Optional[int] = None,
) -> dense.MatchResult:
    """Row-tile-sharded dense match of one rectified pair over ``mesh``'s
    ``tile`` axis. Bit-identical to :func:`stepth.match.dense.match_pair`
    (seam test in tests/test_parallel.py)."""
    if mesh is None:
        from stepth.parallel.mesh import make_mesh

        mesh = make_mesh()
    if halo is None:
        halo = required_halo(cfg)
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    h = left.shape[0]
    ntile = mesh.shape["tile"]
    if h % ntile != 0:
        raise ValueError(f"H={h} not divisible by tile axis {ntile}")
    if h // ntile < halo:
        raise ValueError(f"tile height {h // ntile} < halo {halo}")

    spec = P("tile", None) if left.ndim == 2 else P("tile", None, None)
    fn = shard_map(
        partial(_match_tile, cfg=cfg, halo=halo, h_total=h, axis_name="tile"),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(P("tile", None), P("tile", None), P("tile", None)),
    )
    disp, valid, cbest = fn(left, right)
    return dense.MatchResult(disparity=disp, valid=valid, cost=cbest)


@partial(jax.jit, static_argnames=("cfg", "mesh", "halo"))
def match_batch_sharded(
    lefts,
    rights,
    cfg: MatchConfig = MatchConfig(),
    mesh: Optional[Mesh] = None,
    halo: Optional[int] = None,
):
    """Batched pairs: batch shards over ``data``, rows over ``tile``.
    Returns disparity f32[B, H, W]."""
    if mesh is None:
        from stepth.parallel.mesh import make_mesh

        mesh = make_mesh()
    if halo is None:
        halo = required_halo(cfg)
    lefts = jnp.asarray(lefts, jnp.float32)
    rights = jnp.asarray(rights, jnp.float32)
    b, h = lefts.shape[0], lefts.shape[1]
    nd, nt = mesh.shape["data"], mesh.shape["tile"]
    if b % nd != 0:
        raise ValueError(f"B={b} not divisible by data axis {nd}")
    if h % nt != 0:
        raise ValueError(f"H={h} not divisible by tile axis {nt}")

    def per_pair(l, r):
        d, _, _ = _match_tile(l, r, cfg=cfg, halo=halo, h_total=h, axis_name="tile")
        return d

    spec = P("data", "tile", None) if lefts.ndim == 3 else P("data", "tile", None, None)
    fn = shard_map(
        lambda ls, rs: jax.vmap(per_pair)(ls, rs),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=P("data", "tile", None),
    )
    return fn(lefts, rights)


def _refine_tiling(th: int, levels: int, tile_rows: int, window: int,
                   strict: bool = True):
    """Refine tile height and row halo for a row shard of height ``th``.

    The refine contract fixes a disparity base per (tile_rows × 128) tile of
    its *local* input, so shard-local tiles must start at global rows ≡ 0
    (mod tile_rows) at every refine level (0 … levels−2; the coarsest level
    has no tiles): the tile height is shrunk (in steps of 8) until it
    divides the shard height of the coarsest refine level, and the halo is a
    multiple of it. Bit-equality with the single-device path holds when that
    run uses the same (effective) tile_rows. ``strict=False`` sizes the halo
    even for shard heights the sharded matcher would refuse (the
    communication model projects such grids)."""
    tr = (tile_rows + 7) // 8 * 8
    th_fine = th >> max(levels - 2, 0)
    while tr > 8 and th_fine % tr != 0:
        tr -= 8
    if strict and th_fine % tr != 0:
        raise ValueError(
            f"refine shard height {th_fine} not divisible by any "
            f"8-aligned tile_rows <= {tile_rows}"
        )
    # enough rows for the window box sums (+1 for the median)
    need = window // 2 + 1
    return tr, -(-need // tr) * tr


def _shard_postprocess(disp, disp_r, valid, cfg, d_eff, halo, th, lr_check):
    """LR check, occlusion fill and median on shard rows (all row-local but
    the median, which takes a halo)."""
    if lr_check:
        thr = 1.0 if cfg.lr_threshold is None else float(cfg.lr_threshold)
        valid = dense.lr_consistency(disp, disp_r, thr, d_eff)
        disp = dense.fill_invalid(disp, valid)
    d_ext = _with_halo(disp, halo, "tile", edge="replicate")
    disp = dense.median3(d_ext)[halo : halo + th]
    if not lr_check:
        valid = valid & (disp >= 0)
    return disp, valid.astype(jnp.float32)


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "pyr", "mesh", "tile_rows", "coarse_backend", "sgm", "lr_check",
    ),
)
def match_hierarchical_sharded(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    pyr=None,
    mesh: Optional[Mesh] = None,
    tile_rows: int = 64,
    coarse_backend: str = "wta",
    sgm=None,
    lr_check: bool = False,
) -> dense.MatchResult:
    """The hierarchical matcher (:func:`stepth.match.pyramid.
    match_hierarchical`) sharded over the mesh ``tile`` axis: every pyramid
    level runs on the local row shard extended by an exchanged halo, with
    cost clipping at *global* image rows. The 2×2 pyramid downsampling is
    shard-local (shard heights must divide by 2^(levels−1)), so there is no
    cross-device traffic outside the halo ``ppermute``s.

    **Seam-exact** with the single-device matcher at the same effective
    ``tile_rows`` (see :func:`_refine_tiling`; tested in
    tests/test_parallel.py). The coarse level is the seam-exact sharded
    dense matcher (``coarse_backend="wta"``) or the sharded SGM with its
    exact shard-to-shard carry relay (``"sgm"``,
    :mod:`stepth.parallel.sgm_sharded`), which equals the unsharded SGM to
    ulp. ``lr_check`` threads the full-resolution left-right check through
    the shards exactly like the single-device path."""
    from stepth.config import PyramidConfig
    from stepth.match import pyramid as pyr_mod

    if pyr is None:
        pyr = PyramidConfig()
    if mesh is None:
        from stepth.parallel.mesh import make_mesh

        mesh = make_mesh()
    if lr_check and pyr.levels == 1:
        raise ValueError("lr_check needs at least one refine level")
    left = jnp.asarray(left, jnp.float32)
    right = jnp.asarray(right, jnp.float32)
    h = left.shape[0]
    ntile = mesh.shape["tile"]
    scale = 1 << (pyr.levels - 1)
    if h % ntile != 0:
        raise ValueError(f"H={h} not divisible by tile axis {ntile}")
    th = h // ntile
    if th % scale != 0:
        raise ValueError(f"shard height {th} not divisible by 2^(levels-1)={scale}")
    tr, halo = _refine_tiling(th, pyr.levels, tile_rows, cfg.window)
    coarse_cfg = pyr_mod.coarse_config(cfg, pyr)
    if th // scale < required_halo(coarse_cfg):
        raise ValueError(
            f"coarsest shard height {th // scale} < halo {required_halo(coarse_cfg)}"
        )

    def shard_fn(l_blk, r_blk):
        idx = lax.axis_index("tile")
        lg = dense.grayscale(l_blk)
        rg = dense.grayscale(r_blk)
        lefts, rights = [lg], [rg]
        for _ in range(pyr.levels - 1):
            lefts.append(pyr_mod.downsample2(lefts[-1]))
            rights.append(pyr_mod.downsample2(rights[-1]))

        h_c = h >> (pyr.levels - 1)
        if coarse_backend == "sgm":
            from stepth.match import sgm as sgm_xla
            from stepth.parallel import sgm_sharded as sgm_sh

            disp, valid, _ = sgm_sh._sgm_tile(
                lefts[-1], rights[-1], cfg=coarse_cfg,
                sgm=sgm_xla.SGMConfig() if sgm is None else sgm,
                halo=required_halo(coarse_cfg), wu=0, h_total=h_c,
                exact=True, axis_name="tile",
            )
        elif coarse_backend == "wta":
            disp, valid, _ = _match_tile(
                lefts[-1], rights[-1], coarse_cfg, required_halo(coarse_cfg),
                h_c, "tile",
            )
        else:
            raise ValueError(
                f"coarse_backend must be 'wta' or 'sgm', got {coarse_backend!r}"
            )

        max_base = pyr.coarsest_disparities
        disp_r = None
        for lvl in range(pyr.levels - 2, -1, -1):
            th_l = th >> lvl
            prior = pyr_mod.upsample2_disparity(disp, th_l, lefts[lvl].shape[1])
            max_base = max_base * 2
            want_lr = lr_check and lvl == 0
            out = pyr_mod.refine_level(
                _with_halo(lefts[lvl], halo, "tile", edge="replicate"),
                _with_halo(rights[lvl], halo, "tile", edge="replicate"),
                _with_halo(prior, halo, "tile", edge="replicate"),
                cfg, pyr.final_radius if lvl == 0 else pyr.refine_radius,
                max_base, tr, g_row0=idx * th_l - halo, g_h=h >> lvl,
                lr=want_lr,
                max_windows=pyr.final_windows if lvl == 0 else pyr.refine_windows,
            )
            d_full = out[0] if want_lr else out
            disp = d_full[halo : halo + th_l]
            if want_lr:
                disp_r = out[1][halo : halo + th_l]

        if not lr_check:
            valid = pyr_mod.upsample_valid(
                valid, th, lefts[0].shape[1], pyr.levels - 1
            )
        return _shard_postprocess(
            disp, disp_r, valid, cfg, max_base, halo, th, lr_check
        )

    spec = P("tile", None) if left.ndim == 2 else P("tile", None, None)
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(P("tile", None), P("tile", None)),
        # kernel outputs carry no varying-mesh-axes metadata; skip the check
        check_vma=False,
    )
    disp, valid_f = fn(left, right)
    return dense.MatchResult(
        disparity=disp, valid=valid_f > 0.5, cost=jnp.zeros_like(disp)
    )


def match_batch_hierarchical_sharded(
    lefts,
    rights,
    cfg: MatchConfig = MatchConfig(),
    pyr=None,
    mesh: Optional[Mesh] = None,
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    sgm=None,
) -> dense.MatchResult:
    """Data-parallel hierarchical matching for batched throughput: the batch
    shards over the ``data`` axis and each device runs the unmodified
    single-device pyramid on its local frames via ``lax.scan``. No
    collectives; bit-equal per frame to
    :func:`stepth.match.pyramid.match_hierarchical`."""
    from stepth.config import PyramidConfig
    from stepth.match import pyramid as pyr_mod

    if pyr is None:
        pyr = PyramidConfig()
    if mesh is None:
        from stepth.parallel.mesh import make_mesh

        mesh = make_mesh()
    lefts = jnp.asarray(lefts, jnp.float32)
    rights = jnp.asarray(rights, jnp.float32)
    b = lefts.shape[0]
    nd = mesh.shape["data"]
    if b % nd != 0:
        raise ValueError(f"B={b} not divisible by data axis {nd}")

    def local(ls, rs):
        def step(_, lr_pair):
            res = pyr_mod.match_hierarchical(
                lr_pair[0], lr_pair[1], cfg, pyr, coarse_backend, sgm,
                lr_check, tile_rows,
            )
            return None, (res.disparity, res.valid.astype(jnp.float32))

        _, (d, v) = lax.scan(step, None, (ls, rs))
        return d, v

    spec = P("data", None, None) if lefts.ndim == 3 else P("data", None, None, None)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(P("data", None, None), P("data", None, None)),
        check_vma=False,
    )
    disp, valid_f = fn(lefts, rights)
    return dense.MatchResult(
        disparity=disp, valid=valid_f > 0.5, cost=jnp.zeros_like(disp)
    )


def match_temporal_sharded(
    lefts,
    rights,
    cfg: MatchConfig = MatchConfig(),
    pyr=None,
    mesh: Optional[Mesh] = None,
    keyframe_interval: int = 8,
    tile_rows: int = 64,
    lr_check: bool = False,
    coarse_backend: str = "wta",
    sgm=None,
) -> dense.MatchResult:
    """Temporally-seeded video matching over the mesh ``tile`` axis — the
    sharded twin of :func:`stepth.match.pyramid.match_temporal`. Keyframes
    run the full sharded pyramid (:func:`match_hierarchical_sharded`);
    every other frame runs ONLY the full-resolution refine on the local row
    shard, seeded by the previous frame's (sharded) disparity, with the same
    l/r/prior halo exchange as the pyramid's level 0. The whole clip is one
    ``lax.scan``.

    Seam-exact with the single-device temporal path at the same effective
    ``tile_rows`` (tests/test_temporal_video.py)."""
    from stepth.config import PyramidConfig
    from stepth.match import pyramid as pyr_mod

    if pyr is None:
        pyr = PyramidConfig()
    if mesh is None:
        from stepth.parallel.mesh import make_mesh

        mesh = make_mesh()
    if keyframe_interval < 1:
        raise ValueError(f"keyframe_interval must be >= 1, got {keyframe_interval}")
    lefts = jnp.asarray(lefts, jnp.float32)
    rights = jnp.asarray(rights, jnp.float32)
    h, w = lefts.shape[1:3]
    th = h // mesh.shape["tile"]
    tr, halo = _refine_tiling(th, pyr.levels, tile_rows, cfg.window)
    max_base = pyr.coarsest_disparities << (pyr.levels - 1)

    def seeded_shard(l_blk, r_blk, p_blk):
        idx = lax.axis_index("tile")
        out = pyr_mod.refine_level(
            _with_halo(dense.grayscale(l_blk), halo, "tile", edge="replicate"),
            _with_halo(dense.grayscale(r_blk), halo, "tile", edge="replicate"),
            _with_halo(p_blk, halo, "tile", edge="replicate"),
            cfg, pyr.final_radius, max_base, tr, g_row0=idx * th - halo, g_h=h,
            lr=lr_check, max_windows=pyr.final_windows,
        )
        d_full, dr_full = out if lr_check else (out, None)
        disp = d_full[halo : halo + th]
        disp_r = None if dr_full is None else dr_full[halo : halo + th]
        return _shard_postprocess(
            disp, disp_r, jnp.ones(disp.shape, bool), cfg, max_base, halo, th,
            lr_check,
        )

    spec = P("tile", None) if lefts.ndim == 3 else P("tile", None, None)
    seeded_fn = shard_map(
        seeded_shard,
        mesh=mesh,
        in_specs=(spec, spec, P("tile", None)),
        out_specs=(P("tile", None), P("tile", None)),
        check_vma=False,
    )

    def full_fn(l, r):
        res = match_hierarchical_sharded(
            l, r, cfg, pyr, mesh, tile_rows, coarse_backend, sgm, lr_check,
        )
        return res.disparity, res.valid.astype(jnp.float32)

    def step(carry, lr_pair):
        prev, i = carry
        disp, valid_f = lax.cond(
            i % keyframe_interval == 0,
            lambda: full_fn(*lr_pair),
            lambda: seeded_fn(*lr_pair, prev),
        )
        return (disp, i + 1), (disp, valid_f)

    init = (jnp.zeros((h, w), jnp.float32), jnp.int32(0))
    _, (disp, valid_f) = lax.scan(step, init, (lefts, rights))
    return dense.MatchResult(
        disparity=disp, valid=valid_f > 0.5, cost=jnp.zeros_like(disp)
    )


@partial(jax.jit, static_argnames=("mesh",))
def normalize_depth_sharded(raw_depth, mesh: Optional[Mesh] = None):
    """Global max-normalization of a sharded raw depth map — the reference's
    HOT LOOP 3 (src/depth_image.rs:124-129) as a ``pmax`` collective + local
    scale. Quirk Q3 guarded: all-zero input yields all-zero output."""
    if mesh is None:
        from stepth.parallel.mesh import make_mesh

        mesh = make_mesh()
    raw_depth = jnp.asarray(raw_depth)

    def f(blk):
        m = lax.pmax(jnp.max(blk.astype(jnp.int32)), "tile")
        return jnp.where(
            m > 0, (blk.astype(jnp.int32) * 255) // jnp.maximum(m, 1), 0
        ).astype(jnp.uint8)

    return shard_map(
        f, mesh=mesh, in_specs=P("tile", None), out_specs=P("tile", None)
    )(raw_depth)
