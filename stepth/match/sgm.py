"""Semi-global matching (SGM) aggregation — the accuracy backend.

The reference's matcher is a pure local search: each block independently takes
the first brightness match in an expanding ring (reference src/helpers.rs:9-54,
driven by src/depth_image.rs:111-123), so low-texture regions and repetitive
patterns mismatch freely. SGM (Hirschmüller 2008) regularizes the same cost
volume with a smoothness prior optimized exactly along 1-D scanlines — the
classic accuracy upgrade over winner-take-all, and the natural "better model"
family for this framework.

Each direction is one ``lax.scan`` along rows or columns. The carry is a full
``[T, D]`` slab — the orthogonal spatial axis by disparity — so every scan
step is a handful of wide elementwise ops (shifted minima over D, one
reduction) rather than per-pixel control flow.
Diagonal directions reuse the row scans with a one-column carry shift per step
(zero-filled at the border, which makes border pixels start fresh:
an all-zero predecessor gives ``L = C`` exactly, the standard init). The
recurrence is data-dependent along the scan axis, so this is inherently
serial per direction — but all ``T·D`` cells of a step vectorize, and the
left/right (and top/bottom) passes are independent programs XLA runs back to
back inside one jit.

Recurrence per direction ``r``::

    L_r(p, d) = C(p, d) − min_d' L_r(p−r, d')
                + min( L_r(p−r, d),
                       L_r(p−r, d∓1) + P1,
                       min_d' L_r(p−r, d') + P2 )

Penalties follow the OpenCV SGBM convention: the configured ``p1``/``p2`` are
per-pixel values scaled by ``window²`` when the cost volume was box-aggregated
(default ``p1=8, p2=32`` — tuned for SAD on u8-range images; census/Hamming
costs want smaller values, e.g. ``p1=2, p2=8`` per bit-plane).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from stepth.config import MatchConfig
from stepth.match import dense


@dataclasses.dataclass(frozen=True)
class SGMConfig:
    """Semi-global aggregation knobs.

    ``directions`` ∈ {2, 4, 8}: 2 = horizontal only, 4 = + vertical,
    8 = + diagonals. ``p1`` penalizes ±1-disparity steps (slanted surfaces),
    ``p2`` larger jumps (depth edges); both are per-pixel-cost scale and are
    multiplied by ``window²`` internally when the volume is box-aggregated.
    """

    p1: float = 8.0
    p2: float = 32.0
    directions: int = 4


def dir_step(carry, c, shift: int, p1, p2) -> jax.Array:
    """One SGM recurrence step: path costs ``L`` for the current scanline
    position given the predecessor's ``carry`` [T, D] and the current
    aggregated cost slab ``c`` [T, D]. ``shift`` laterally displaces the carry
    along T (±1 for diagonals, 0 for axis-aligned), zero-filling at the border
    so shifted-in pixels start fresh (an all-zero carry ⇒
    ``min(0, P1, P2) − 0 = 0`` ⇒ ``L = C``, the standard border init)."""
    if shift > 0:
        carry = jnp.pad(carry, ((shift, 0), (0, 0)))[:-shift]
    elif shift < 0:
        carry = jnp.pad(carry, ((0, -shift), (0, 0)))[-shift:]
    min_l = jnp.min(carry, axis=-1, keepdims=True)  # [T, 1]
    padded = jnp.pad(carry, ((0, 0), (1, 1)), constant_values=jnp.inf)
    cand = jnp.minimum(
        carry, jnp.minimum(padded[:, :-2] + p1, padded[:, 2:] + p1)
    )
    cand = jnp.minimum(cand, min_l + p2)
    return c + cand - min_l


def scan_dir_from(vol, carry0, *, reverse: bool, shift: int, p1, p2):
    """Scan one direction over ``vol`` [S, T, D] from an explicit initial
    carry; returns ``(final_carry, L)``. Exposed (rather than folded into
    :func:`_aggregate_dir`) so the sharded relay
    (:mod:`stepth.parallel.sgm_sharded`) runs the *identical* arithmetic
    per step — bit-exact seams depend on it."""

    def step(carry, c):
        out = dir_step(carry, c, shift, p1, p2)
        return out, out

    # under shard_map a fresh-zeros carry is unvarying while vol is varying;
    # match the carry's varying-manual-axes to the scanned operand's
    missing = getattr(jax.typeof(vol), "vma", frozenset()) - getattr(
        jax.typeof(carry0), "vma", frozenset()
    )
    if missing:
        carry0 = jax.lax.pcast(carry0, tuple(missing), to="varying")
    return jax.lax.scan(step, carry0, vol, reverse=reverse)


def _aggregate_dir(vol: jax.Array, reverse: bool, shift: int, p1, p2) -> jax.Array:
    """One SGM direction over ``vol`` [S, T, D], scanning axis 0."""
    init = jnp.zeros(vol.shape[1:], jnp.float32)
    _, ys = scan_dir_from(vol, init, reverse=reverse, shift=shift, p1=p1, p2=p2)
    return ys


def aggregate(vol: jax.Array, sgm: SGMConfig, p1: float, p2: float) -> jax.Array:
    """Sum of per-direction path costs S(p, d) = Σ_r L_r(p, d) over
    ``sgm.directions`` scanline directions. ``vol`` is f32[H, W, D]."""
    if sgm.directions not in (2, 4, 8):
        raise ValueError(f"directions must be 2, 4 or 8, got {sgm.directions}")
    p1 = jnp.float32(p1)
    p2 = jnp.float32(p2)

    cols = jnp.swapaxes(vol, 0, 1)  # [W, H, D] — scan over columns
    out = _aggregate_dir(cols, reverse=False, shift=0, p1=p1, p2=p2)  # →x
    out = out + _aggregate_dir(cols, reverse=True, shift=0, p1=p1, p2=p2)  # ←x
    out = jnp.swapaxes(out, 0, 1)
    if sgm.directions == 8:
        # Row scans with a per-step carry shift: direction (dy, dx) reads the
        # predecessor at column x−dx, i.e. the carry shifted by +dx.
        # Diagonals accumulate BEFORE the vertical pair; the sharded relay
        # (parallel/sgm_sharded.py) sums in the same order, so f32 sums
        # match bit for bit.
        out = out + _aggregate_dir(vol, reverse=False, shift=+1, p1=p1, p2=p2)  # ↘
        out = out + _aggregate_dir(vol, reverse=False, shift=-1, p1=p1, p2=p2)  # ↙
        out = out + _aggregate_dir(vol, reverse=True, shift=+1, p1=p1, p2=p2)  # ↗
        out = out + _aggregate_dir(vol, reverse=True, shift=-1, p1=p1, p2=p2)  # ↖
    if sgm.directions >= 4:
        out = out + _aggregate_dir(vol, reverse=False, shift=0, p1=p1, p2=p2)  # ↓y
        out = out + _aggregate_dir(vol, reverse=True, shift=0, p1=p1, p2=p2)  # ↑y
    return out


@partial(jax.jit, static_argnames=("cfg", "sgm"))
def match_pair_sgm(
    left, right, cfg: MatchConfig = MatchConfig(), sgm: SGMConfig = SGMConfig()
) -> dense.MatchResult:
    """Full SGM matcher on a rectified pair: cost volume → box aggregation
    (``cfg.window``) → semi-global path aggregation → WTA/subpixel → LR check →
    occlusion fill → median. Same contract as :func:`dense.match_pair`."""
    lg = dense.grayscale(left)
    rg = dense.grayscale(right)
    vol = dense.cost_volume(lg, rg, cfg)
    vol = dense.box_aggregate(vol, cfg.window)
    scale = float(cfg.window * cfg.window) if cfg.window > 1 else 1.0
    agg = aggregate(vol, sgm, sgm.p1 * scale, sgm.p2 * scale)
    disp, valid, cbest = dense.wta(agg, cfg.subpixel, cfg.uniqueness)
    if cfg.lr_threshold is not None:
        disp_r = dense.right_disparity_from_volume(agg)
        valid = valid & dense.lr_consistency(
            disp, disp_r, cfg.lr_threshold, cfg.num_disparities
        )
    disp = dense.fill_invalid(disp, valid)
    disp = dense.median3(disp)
    return dense.MatchResult(disparity=disp, valid=valid, cost=cbest)
