"""Row-tile-sharded semi-global matching over the device mesh.

SGM's directional scans are the interesting sharding problem in this codebase:
unlike the window ops (dense/hierarchical matchers — fixed-radius neighbor
context, solved by halo exchange in :mod:`stepth.parallel.sharded`), a
scanline recurrence carries state across the *entire* image, so a row-sharded
image cuts the vertical and diagonal scan chains at every shard boundary.

Two modes:

* ``exact=True`` (default) — **equal to the unsharded backend** to within
  compile-level ulp noise (XLA reassociates float sums differently at
  different shard shapes; the dense sharded paths' 1e-5 standard).
  Horizontal scans are row-local and run shard-parallel for free. Vertical and
  diagonal scans relay their ``[W, D]`` carry shard-to-shard over ICI via
  ``lax.ppermute``: shard *s* runs its local ``lax.scan`` seeded by the final
  carry of shard *s−1*, exactly the arithmetic the unsharded scan would have
  executed at those rows (the step function is shared —
  :func:`stepth.match.sgm.scan_dir_from`). The chain is inherently serial,
  so the relayed directions take the same wall-time as unsharded (every shard
  also *executes* the scan in every round, with non-owners masked out — SPMD
  has no cheaper idle); what sharding buys is distributed volume memory, the
  n-way-parallel horizontal scans, cost-volume build, WTA, and epilogue.
* ``exact=False`` — **fully parallel, approximate at interior seams.** Each
  shard extends its rows by ``warmup`` halo rows (exchanged over ICI) and runs
  all directions locally; the warm carry entering the real rows approximates
  the true one because the SGM recurrence forgets its init quickly (the
  ``min + P2`` clamp bounds the carry profile to ``[0, C + P2]`` after one
  step). At *true* image borders this is exact: out-of-image rows carry zero
  cost, and a zero carry over zero cost stays identically zero, so the first
  real row starts fresh — precisely the unsharded border init.

Greenfield component (no reference counterpart): the reference's only
parallelism is an in-process rayon pool (reference src/depth_image.rs:111-129).
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
from stepth.match import sgm as sgm_mod
from stepth.parallel.sharded import _with_halo, required_halo


def _relay_dir(vol, *, reverse: bool, shift: int, p1, p2, axis_name: str):
    """One vertical/diagonal SGM direction over the row-sharded volume
    ``vol`` [th, W, D], the scan carry relayed shard-to-shard.

    Round *s* of the (static) relay loop: the owner shard — *s* for a forward
    scan, *n−1−s* for a reverse one — scans its local rows seeded by the carry
    relayed in round *s−1*; its final carry then ppermutes to the next owner.
    Non-owner rounds compute the same scan on a garbage seed and are masked
    out — idle shards would idle anyway, the chain is serial."""
    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i + 1, i) for i in range(n - 1)]
    perm = up if reverse else down
    carry = jnp.zeros(vol.shape[1:], jnp.float32)
    out = jnp.zeros_like(vol)
    for s in range(n):
        owner = (n - 1 - s) if reverse else s
        fc, ys = sgm_mod.scan_dir_from(
            vol, carry, reverse=reverse, shift=shift, p1=p1, p2=p2
        )
        mine = idx == owner
        out = jnp.where(mine, ys, out)
        if s < n - 1:
            carry = lax.ppermute(
                jnp.where(mine, fc, 0.0), axis_name, perm
            )
    return out


def _aggregate_sharded(vol, sgm: sgm_mod.SGMConfig, p1, p2, *, exact: bool,
                       axis_name: str):
    """Direction sum over the local volume ``vol`` [S, W, D] (S = th in exact
    mode, th + 2·warmup in warm-up mode). Accumulation order matches
    :func:`stepth.match.sgm.aggregate` term for term."""
    p1 = jnp.float32(p1)
    p2 = jnp.float32(p2)
    local = partial(sgm_mod._aggregate_dir, p1=p1, p2=p2)
    relay = (
        partial(local)
        if not exact
        else partial(_relay_dir, p1=p1, p2=p2, axis_name=axis_name)
    )

    cols = jnp.swapaxes(vol, 0, 1)  # [W, S, D] — horizontal scans, row-local
    out = local(cols, reverse=False, shift=0)  # →x
    out = out + local(cols, reverse=True, shift=0)  # ←x
    out = jnp.swapaxes(out, 0, 1)
    if sgm.directions == 8:
        # diagonals before the vertical pair — mirrors sgm.aggregate's order
        # (↑y last), so f32 sums match bit for bit
        out = out + relay(vol, reverse=False, shift=+1)  # ↘
        out = out + relay(vol, reverse=False, shift=-1)  # ↙
        out = out + relay(vol, reverse=True, shift=+1)  # ↗
        out = out + relay(vol, reverse=True, shift=-1)  # ↖
    if sgm.directions >= 4:
        out = out + relay(vol, reverse=False, shift=0)  # ↓y
        out = out + relay(vol, reverse=True, shift=0)  # ↑y
    return out


def _sgm_tile(l_blk, r_blk, *, cfg: MatchConfig, sgm: sgm_mod.SGMConfig,
              halo: int, wu: int, h_total: int, exact: bool, axis_name: str):
    """Per-shard SGM on a row tile. ``halo`` covers the cost-volume window
    support; ``wu`` extra rows (warm-up mode only) warm the directional scans."""
    th = l_blk.shape[0]
    idx = lax.axis_index(axis_name)
    row0 = idx * th
    ext = halo + wu

    l_ext = _with_halo(l_blk, ext, axis_name, edge="replicate")
    r_ext = _with_halo(r_blk, ext, axis_name, edge="replicate")
    lg = dense.grayscale(l_ext)
    rg = dense.grayscale(r_ext)
    vol = dense.cost_volume(lg, rg, cfg)  # [th+2·ext, W, D]

    # zero cost outside the real image: box sums match the unsharded zero-pad
    # clipping, and (warm-up mode) the scans stay identically zero across
    # out-of-image rows, so true borders start fresh exactly like unsharded
    gidx = row0 - ext + jnp.arange(th + 2 * ext)
    in_img = (gidx >= 0) & (gidx < h_total)
    vol = vol * in_img[:, None, None].astype(vol.dtype)

    agg_ext = dense.box_aggregate(vol, cfg.window)
    agg = agg_ext[halo : halo + th + 2 * wu]  # [th+2·wu, W, D]
    if wu:
        # box sums leak into out-of-image rows within the window radius;
        # re-zero them so warm-up scans cross true borders with a zero carry
        # (fresh start, exactly the unsharded border init)
        gidx2 = row0 - wu + jnp.arange(th + 2 * wu)
        in2 = (gidx2 >= 0) & (gidx2 < h_total)
        agg = agg * in2[:, None, None].astype(agg.dtype)

    scale = float(cfg.window * cfg.window) if cfg.window > 1 else 1.0
    agg = _aggregate_sharded(
        agg, sgm, sgm.p1 * scale, sgm.p2 * scale, exact=exact,
        axis_name=axis_name,
    )
    agg = agg[wu : wu + th] if wu else agg

    disp, valid, cbest = dense.wta(agg, cfg.subpixel, cfg.uniqueness)
    if cfg.lr_threshold is not None:
        disp_r = dense.right_disparity_from_volume(agg)
        valid = valid & dense.lr_consistency(
            disp, disp_r, cfg.lr_threshold, cfg.num_disparities
        )
    disp = dense.fill_invalid(disp, valid)
    d_ext = _with_halo(disp, 1, axis_name, edge="replicate")
    disp = dense.median3(d_ext)[1 : 1 + th]
    return disp, valid, cbest


@partial(
    jax.jit, static_argnames=("cfg", "sgm", "mesh", "exact", "warmup", "halo")
)
def match_pair_sgm_sharded(
    left,
    right,
    cfg: MatchConfig = MatchConfig(),
    sgm: sgm_mod.SGMConfig = sgm_mod.SGMConfig(),
    mesh: Optional[Mesh] = None,
    exact: bool = True,
    warmup: int = 32,
    halo: Optional[int] = None,
) -> dense.MatchResult:
    """Row-tile-sharded twin of :func:`stepth.match.sgm.match_pair_sgm`
    over ``mesh``'s ``tile`` axis. ``exact=True`` equals the unsharded backend
    to within compile-level ulp noise (tested in tests/test_sgm_sharded.py,
    1e-5 like the dense sharded paths); ``exact=False``
    trades seam exactness for fully parallel scans (``warmup`` halo rows warm
    the carries; true image borders remain exact)."""
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
    wu = 0 if exact else int(warmup)
    if h // ntile < halo + wu:
        raise ValueError(f"tile height {h // ntile} < halo+warmup {halo + wu}")

    spec = P("tile", None) if left.ndim == 2 else P("tile", None, None)
    fn = shard_map(
        partial(
            _sgm_tile, cfg=cfg, sgm=sgm, halo=halo, wu=wu, h_total=h,
            exact=exact, axis_name="tile",
        ),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(P("tile", None), P("tile", None), P("tile", None)),
    )
    disp, valid, cbest = fn(left, right)
    return dense.MatchResult(disparity=disp, valid=valid, cost=cbest)
