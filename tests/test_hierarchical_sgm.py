"""SGM-coarse hierarchical hybrid.

``match_hierarchical(coarse_backend="sgm")`` swaps the coarsest-level
exhaustive WTA for the semi-global matcher. These tests pin the
contract (same output surface as the WTA-coarse flagship), the composition
(the hybrid is exactly SGM-at-coarsest + the same refine levels), and the
reason the backend exists (repetitive texture that aliases under exhaustive
WTA resolves under SGM's scanline regularization).
"""

import numpy as np
import jax.numpy as jnp

from stepth.config import MatchConfig, PyramidConfig
from stepth.match import dense, pyramid
from stepth.match.sgm import SGMConfig
from stepth.models.stereo import StereoModel

from tests.test_match_dense import make_pair, interior

CFG = MatchConfig(num_disparities=32, window=9)
PYR = PyramidConfig(levels=3, refine_radius=4, coarsest_disparities=8)


def test_hierarchical_sgm_recovers_shift(rng):
    shift = 10
    left, right = make_pair(rng, h=96, w=256, shift=shift)
    res = pyramid.match_hierarchical(left, right, CFG, PYR, coarse_backend="sgm")
    assert res.disparity.shape == (96, 256)
    err = np.abs(np.asarray(interior(res.disparity, 16)) - shift)
    assert np.median(err) <= 1.0
    assert (err <= 1.5).mean() > 0.9


def test_hierarchical_sgm_is_sgm_plus_refine(rng):
    """The hybrid == running the SGM matcher at the coarsest level and
    feeding its disparity through the identical refine-level loop, bit-for-bit."""
    left, right = make_pair(rng, h=64, w=256, shift=7)
    sgm = SGMConfig(directions=4)
    res = pyramid.match_hierarchical(
        left, right, CFG, PYR, coarse_backend="sgm", sgm=sgm
    )

    from stepth.match import sgm as sgm_xla
    pyr_mod = pyramid

    lg = dense.grayscale(jnp.asarray(left, jnp.float32))
    rg = dense.grayscale(jnp.asarray(right, jnp.float32))
    lefts, rights = [lg], [rg]
    for _ in range(PYR.levels - 1):
        lefts.append(pyr_mod.downsample2(lefts[-1]))
        rights.append(pyr_mod.downsample2(rights[-1]))
    coarse_cfg = pyramid.coarse_config(CFG, PYR)
    disp = sgm_xla.match_pair_sgm(lefts[-1], rights[-1], coarse_cfg, sgm).disparity
    max_base = PYR.coarsest_disparities
    for lvl in range(PYR.levels - 2, -1, -1):
        h, w = lefts[lvl].shape
        prior = pyr_mod.upsample2_disparity(disp, h, w)
        max_base *= 2
        disp = pyramid.refine_level(
            lefts[lvl], rights[lvl], prior, CFG, PYR.refine_radius, max_base,
            tile_rows=64,
        )
    disp = dense.median3(disp)
    np.testing.assert_array_equal(np.asarray(res.disparity), np.asarray(disp))


def test_hierarchical_sgm_resolves_repetitive_texture(rng):
    """Vertical stripes whose period aliases the true shift at the coarsest
    level: exhaustive WTA locks onto the wrong phase for a large fraction of
    pixels; the SGM coarse prior resolves the ambiguity."""
    h, w, shift, period = 96, 256, 12, 32
    x = np.arange(w + shift, dtype=np.float32)
    stripes = 120.0 + 100.0 * np.sin(2 * np.pi * x / period)
    tex = np.broadcast_to(stripes, (h, w + shift)).copy()
    tex += rng.normal(0, 3.0, tex.shape).astype(np.float32)
    left, right = tex[:, :w], tex[:, shift:]

    cfg = MatchConfig(num_disparities=32, window=9)
    pyr = PyramidConfig(levels=3, refine_radius=4, coarsest_disparities=16)
    res_wta = pyramid.match_hierarchical(left, right, cfg, pyr, coarse_backend="wta")
    res_sgm = pyramid.match_hierarchical(
        left, right, cfg, pyr, coarse_backend="sgm", sgm=SGMConfig(directions=4)
    )
    err_wta = np.abs(np.asarray(interior(res_wta.disparity, 16)) - shift)
    err_sgm = np.abs(np.asarray(interior(res_sgm.disparity, 16)) - shift)
    # the hybrid nails the shift; plain WTA aliases somewhere in the interior
    assert np.median(err_sgm) <= 1.0
    assert (err_sgm <= 1.5).mean() > 0.95
    assert (err_sgm <= 1.5).mean() >= (err_wta <= 1.5).mean()


def test_model_backend_hierarchical_sgm(rng):
    left, right = make_pair(rng, h=64, w=256, shift=6)
    model = StereoModel(
        backend="hierarchical-sgm",
        match=MatchConfig(num_disparities=32, window=9),
        pyramid=PyramidConfig(levels=2, refine_radius=4, coarsest_disparities=16),
    )
    res = model(left, right)
    err = np.abs(np.asarray(interior(res.disparity, 16)) - 6)
    assert np.median(err) <= 1.0


def test_xla_hierarchical_sgm_coarse(rng):
    """pyramid.match_hierarchical(coarse_backend="sgm") with its default
    refine tiles."""
    shift = 10
    left, right = make_pair(rng, h=96, w=256, shift=shift)
    res = pyramid.match_hierarchical(
        left, right, CFG, PYR, coarse_backend="sgm", sgm=SGMConfig(directions=4)
    )
    err = np.abs(np.asarray(interior(res.disparity, 16)) - shift)
    assert np.median(err) <= 1.0


def test_sharded_hierarchical_sgm_matches_composition(rng):
    """Row-tile-sharded hybrid == (unsharded XLA SGM at the coarsest level +
    the identical refine levels + median), to the sharded-SGM ulp standard."""
    from stepth.match import sgm as sgm_xla
    from stepth.parallel import mesh as mesh_mod, sharded

    pyr_mod = pyramid

    shift = 9
    left, right = make_pair(rng, h=128, w=256, shift=shift)
    cfg = MatchConfig(num_disparities=32, window=9)
    pyr = PyramidConfig(levels=2, refine_radius=4, coarsest_disparities=16)
    sc = SGMConfig(directions=4)
    m = mesh_mod.make_mesh(data=1, tile=2)
    got = sharded.match_hierarchical_sharded(
        left, right, cfg, pyr, m, tile_rows=32, coarse_backend="sgm", sgm=sc
    )

    lg = dense.grayscale(jnp.asarray(left, jnp.float32))
    rg = dense.grayscale(jnp.asarray(right, jnp.float32))
    lefts, rights = [lg], [rg]
    for _ in range(pyr.levels - 1):
        lefts.append(pyr_mod.downsample2(lefts[-1]))
        rights.append(pyr_mod.downsample2(rights[-1]))
    coarse_cfg = pyramid.coarse_config(cfg, pyr)
    disp = sgm_xla.match_pair_sgm(lefts[-1], rights[-1], coarse_cfg, sc).disparity
    max_base = pyr.coarsest_disparities
    for lvl in range(pyr.levels - 2, -1, -1):
        h, w = lefts[lvl].shape
        prior = pyr_mod.upsample2_disparity(disp, h, w)
        max_base *= 2
        disp = pyramid.refine_level(
            lefts[lvl], rights[lvl], prior, cfg, pyr.refine_radius, max_base,
            tile_rows=32,
        )
    ref = dense.median3(disp)
    np.testing.assert_allclose(
        np.asarray(got.disparity), np.asarray(ref), atol=1e-4
    )
    err = np.abs(np.asarray(interior(got.disparity, 16)) - shift)
    assert np.median(err) <= 1.0


def test_sharded_hierarchical_sgm_via_model(rng):
    from stepth.parallel import mesh as mesh_mod

    shift = 6
    left, right = make_pair(rng, h=128, w=256, shift=shift)
    model = StereoModel(
        backend="hierarchical-sgm",
        match=MatchConfig(num_disparities=32, window=9),
        pyramid=PyramidConfig(levels=2, refine_radius=4, coarsest_disparities=16),
        sgm=SGMConfig(directions=4),
    )
    run = model.sharded(mesh_mod.make_mesh(data=1, tile=4))
    res = run(left, right)
    err = np.abs(np.asarray(interior(res.disparity, 16)) - shift)
    assert np.median(err) <= 1.0


def test_hierarchical_sgm_batched(rng):
    """One-dispatch serving path works for the hybrid backend and equals
    the per-frame results."""
    import jax

    model = StereoModel(
        backend="hierarchical-sgm",
        match=MatchConfig(num_disparities=16, window=5),
        pyramid=PyramidConfig(levels=2, refine_radius=2, coarsest_disparities=8),
    )
    pairs = [make_pair(rng, h=32, w=128, shift=s) for s in (3, 5)]
    lefts = jnp.stack([jnp.asarray(l) for l, _ in pairs])
    rights = jnp.stack([jnp.asarray(r) for _, r in pairs])
    out = jax.jit(model.batched())(lefts, rights)
    assert out.disparity.shape == (2, 32, 128)
    for i, (l, r) in enumerate(pairs):
        ref = model(l, r)
        np.testing.assert_array_equal(
            np.asarray(out.disparity[i]), np.asarray(ref.disparity)
        )
