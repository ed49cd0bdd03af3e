"""Refine-level kernel for NVIDIA GPUs: Pallas on the Triton route.

Computes exactly what :func:`stepth.match.pyramid.refine_tiles_reference`
computes (the tile contract is in the :mod:`stepth.match.pyramid` docstring),
but runs only the windows each tile's plan asks for and never materializes a
candidate stack: one program owns ``br`` output rows of one (tile_rows × 128)
tile, loads its own plan entry (``bases``, ``nw``), and keeps the running
first-win argmin in registers.

Per candidate the program computes the cost of its whole 256-column region
once, then takes the box sums through a small per-program scratch buffer:
Triton has no register shifts, so the shifted taps of the vertical and the
horizontal sum are loads from scratch (L1-resident), separated by block
barriers. The taps are summed in the contract's fixed order, so census and
SAD costs match the reference bit for bit; SSD can differ in the last bits
where the compiler fuses ``d·d + acc`` into one FMA.

For ``lr`` each program also writes its windows' right-view minima over the
whole cost region; :func:`stepth.match.pyramid.merge_right_view` merges them
across tiles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from stepth.match.pyramid import (
    _BAD, _BIG, _CW, _NO_MATCH, _TW, RefineGeometry, _subpixel,
)

# Output rows per program (at most; see block_rows) and warps per program.
# With a 9-wide box, 16 rows plus their halo fill a 32-row cost block. On an
# H100 80GB HBM3 (700 W) a sweep of an earlier form of this kernel (every box
# tap recomputed from the sources) at 1080p level 0 put 8 and 16 rows with 8
# warps within 2% of each other, 32 rows 33-67% slower and 4 warps 3-15%
# slower; the present form has not been swept.
BLOCK_ROWS = 16
NUM_WARPS = 8


def block_rows(th: int, cap: int = BLOCK_ROWS) -> int:
    """Largest power of two that divides the tile height, at most ``cap``."""
    br = 1
    while br * 2 <= cap and th % (br * 2) == 0:
        br *= 2
    return br


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _kernel(
    bases_ref, nw_ref, g_row0_ref, src_l_ref, src_r_ref, disp_ref, *out_refs,
    geo: RefineGeometry, K: int, ncols: int, nrows: int, plane: int,
    nplanes: int, g_h: int, lr: bool, subpixel: bool, br: int,
    interpret: bool,
):
    th, R, m, rbox, w = geo.th, geo.radius, geo.m, geo.rbox, geo.w
    nr, nc = geo.nr, geo.nc
    sp = _next_pow2(br + 2 * rbox)  # cost rows: the block plus its halo
    scr = out_refs[-1]
    jc = pl.program_id(0)
    rb = pl.program_id(1)
    y0 = rb * br
    ti = y0 // th
    tile = ti * nc + jc
    base_c = (rb * nc + jc) * (sp + 2 * br) * _CW  # this program's scratch
    base_v = base_c + sp * _CW
    base_a = base_v + br * _CW
    g_row0 = g_row0_ref[0]

    def barrier():
        if not interpret:
            plgpu.debug_barrier()

    r_sp = lax.broadcasted_iota(jnp.int32, (sp, 1), 0)
    r_br = lax.broadcasted_iota(jnp.int32, (br, 1), 0)
    q256 = lax.broadcasted_iota(jnp.int32, (1, _CW), 1)
    lane = lax.broadcasted_iota(jnp.int32, (1, _TW), 1)
    x = jc * _TW - m + q256  # real column of each region column

    # the cost block: image rows y0 − rbox + r, region columns q
    crow = y0 - rbox + r_sp
    grow = g_row0 + crow
    row_ok = (crow >= 0) & (crow < geo.h) & (grow >= 0) & (grow < g_h)
    zmask = (row_ok & (x >= 0) & (x < w)).astype(jnp.float32)
    srow = crow + rbox  # source row
    in_src = srow < nrows
    li = jnp.where(in_src, srow, 0) * ncols + geo.pad_l + x
    if nplanes:
        lblk = [
            plgpu.load(src_l_ref.at[li + p * plane], mask=in_src, other=0)
            for p in range(nplanes)
        ]
    else:
        lblk = plgpu.load(src_l_ref.at[li], mask=in_src, other=0.0)

    def cost(s):
        ri = li - s
        if nplanes:
            ham = jnp.zeros((sp, _CW), jnp.int32)
            for p in range(nplanes):
                b = plgpu.load(src_r_ref.at[ri + p * plane], mask=in_src, other=0)
                ham = ham + lax.population_count(lblk[p] ^ b)
            c = ham.astype(jnp.float32)
        else:
            d = lblk - plgpu.load(src_r_ref.at[ri], mask=in_src, other=0.0)
            c = d * d if geo.squared else jnp.abs(d)
        xs = x - s
        return jnp.where((xs < 0) | (xs >= w), _BAD, c) * zmask

    def c_tap(d):  # cost row of output row t shifted by d
        return plgpu.load(scr.at[base_c + (r_br + rbox + d) * _CW + q256])

    def v_tap(cols, d):  # vertical sum at region column (cols + d) mod 256
        return plgpu.load(scr.at[base_v + r_br * _CW + ((cols + d) & (_CW - 1))])

    def three(tap, a):  # (t(a) + t(a−1)) + t(a+1)
        return tap(a) + tap(a - 1) + tap(a + 1)

    def box_sums(s, cols_list):
        """Aggregated cost of candidate ``s`` at each region-column set in
        ``cols_list`` (each i32[1, n])."""
        plgpu.store(scr.at[base_c + r_sp * _CW + q256], cost(s))
        barrier()
        if geo.window == 9:
            v = three(c_tap, 0) + three(c_tap, -3) + three(c_tap, 3)
        else:
            v = jnp.zeros((br, _CW), jnp.float32)
            for d in range(-rbox, rbox + 1):
                v = v + c_tap(d)
        plgpu.store(scr.at[base_v + r_br * _CW + q256], v)
        barrier()
        outs = []
        for cols in cols_list:
            tap = functools.partial(v_tap, cols)
            if geo.window == 9:
                outs.append(three(tap, 0) + three(tap, -3) + three(tap, 3))
            else:
                z = jnp.zeros((br, cols.shape[1]), jnp.float32)
                for d in range(-rbox, rbox + 1):
                    z = z + tap(d)
                outs.append(z)
        return outs

    q_left = m + lane  # region columns of the tile's output
    zeros = jnp.zeros((br, _TW), jnp.float32)

    def window(k, state):
        base = bases_ref[tile * K + k]

        def offset(oi, carry):
            best, bests, oi_s, wbest, cm1, cb, cp1, prev = carry[:8]
            s = base + oi - R
            if lr:
                (agg,) = box_sums(s, [q256])
                plgpu.store(scr.at[base_a + r_br * _CW + q256], agg)
                barrier()
                aggc = plgpu.load(scr.at[base_a + r_br * _CW + q_left])
                # right view, shifting frame: entry q takes the cost at
                # region column q − 2R + oi (wrapped entries are masked)
                qs = (q256 - 2 * R + oi) & (_CW - 1)
                xc = jc * _TW - m + qs
                xs = xc - s
                contrib = plgpu.load(scr.at[base_a + r_br * _CW + qs])
                bad = (xs < 0) | (xs >= w) | (xc < 0) | (xc >= w)
                contrib = jnp.where(bad, _BIG, contrib)
                bv, bs = carry[8:]
                upd_r = contrib < bv
                bv = jnp.where(upd_r, contrib, bv)
                bs = jnp.where(upd_r, s.astype(jnp.float32), bs)
            else:
                (aggc,) = box_sums(s, [q_left])
            upd = aggc < best
            is_next = jnp.logical_not(upd) & (wbest == k) & (oi_s == oi - 1)
            cm1 = jnp.where(upd, prev, cm1)
            cb = jnp.where(upd, aggc, cb)
            cp1 = jnp.where(is_next, aggc, cp1)
            best = jnp.where(upd, aggc, best)
            bests = jnp.where(upd, s, bests)
            oi_s = jnp.where(upd, oi, oi_s)
            wbest = jnp.where(upd, k, wbest)
            out = (best, bests, oi_s, wbest, cm1, cb, cp1, aggc)
            return out + (bv, bs) if lr else out

        carry = (*state, zeros)
        if lr:
            big = jnp.full((br, _CW), _BIG, jnp.float32)
            carry += (big, jnp.full((br, _CW), _NO_MATCH, jnp.float32))
        carry = lax.fori_loop(0, 2 * R + 1, offset, carry)
        if lr:
            val_ref, s_ref = out_refs[:2]
            bv = jnp.where(q256 < 2 * R, _BIG, carry[8])
            out = (((k * nr + ti) * nc + jc) * th + (y0 - ti * th + r_br)) * _CW + q256
            plgpu.store(val_ref.at[out], bv)
            plgpu.store(s_ref.at[out], carry[9])
        return carry[:7]

    state0 = (
        zeros + _BIG,
        jnp.zeros((br, _TW), jnp.int32),
        jnp.full((br, _TW), -2, jnp.int32),
        jnp.full((br, _TW), -1, jnp.int32),
        zeros,
        zeros + _BIG,
        zeros + _BIG,
    )
    best, bests, oi_s, wbest, cm1, cb, cp1 = lax.fori_loop(
        0, nw_ref[tile], window, state0
    )
    dval = _subpixel(bests, oi_s, cm1, cb, cp1, R, w, subpixel)
    plgpu.store(disp_ref.at[(y0 + r_br) * geo.wp + jc * _TW + lane], dval)


def refine_tiles(
    src_l, src_r, bases, nw, geo: RefineGeometry, g_row0=0, g_h=None,
    lr: bool = False, subpixel: bool = True, interpret: bool = False,
):
    """Kernel twin of :func:`stepth.match.pyramid.refine_tiles_reference`:
    same arguments, same outputs."""
    K = int(bases.shape[-1])
    nplanes = int(src_l.shape[0]) if src_l.ndim == 3 else 0
    if nplanes:  # popcount lowers for int32 only; the bits are the same
        src_l = lax.bitcast_convert_type(src_l, jnp.int32)
        src_r = lax.bitcast_convert_type(src_r, jnp.int32)
    nrows, ncols = int(src_l.shape[-2]), int(src_l.shape[-1])
    br = block_rows(geo.th)
    sp = _next_pow2(br + 2 * geo.rbox)
    n_prog = geo.nc * (geo.hp // br)
    kern = functools.partial(
        _kernel, geo=geo, K=K, ncols=ncols, nrows=nrows, plane=nrows * ncols,
        nplanes=nplanes, g_h=geo.h if g_h is None else g_h, lr=lr,
        subpixel=subpixel, br=br, interpret=interpret,
    )
    out_shape = [jax.ShapeDtypeStruct((geo.hp * geo.wp,), jnp.float32)]
    if lr:
        n_right = K * geo.nr * geo.nc * geo.th * _CW
        out_shape += [jax.ShapeDtypeStruct((n_right,), jnp.float32)] * 2
    # per-program scratch for the box sums (cost block, vertical and full sums)
    out_shape.append(
        jax.ShapeDtypeStruct((n_prog * (sp + 2 * br) * _CW,), jnp.float32)
    )
    outs = pl.pallas_call(
        kern,
        out_shape=out_shape,
        grid=(geo.nc, geo.hp // br),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="stepth_refine",
    )(
        bases.reshape(-1).astype(jnp.int32),
        nw.reshape(-1).astype(jnp.int32),
        jnp.asarray(g_row0, jnp.int32).reshape(1),
        src_l.reshape(-1),
        src_r.reshape(-1),
    )
    disp = outs[0].reshape(geo.hp, geo.wp)
    if not lr:
        return disp, None
    shape = (K, geo.nr, geo.nc, geo.th, _CW)
    return disp, (outs[1].reshape(shape), outs[2].reshape(shape))

