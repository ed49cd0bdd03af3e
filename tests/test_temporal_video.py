"""Temporally-seeded video matching (`StereoModel.video` /
`pyramid.match_temporal`): non-keyframe frames run only the
full-resolution refine seeded by the previous frame's disparity.

Reference: the reference library has no video path at all (single-pair,
/root/reference/src/depth_image.rs); this is part of the greenfield serving
layer (BASELINE.md config 4)."""

import numpy as np
import pytest

from stepth.config import MatchConfig, PyramidConfig
from stepth.models import StereoModel

H, W, T = 64, 160, 6
MATCH = MatchConfig(num_disparities=16, window=9)
PYR = PyramidConfig(levels=2, refine_radius=4, coarsest_disparities=8)


def _clip(shifts, seed=9):
    """Constant-texture clip whose planted disparity is shifts[t]."""
    rng = np.random.default_rng(seed)
    pad = max(shifts) + 2
    tex = rng.uniform(0, 255, (H, W + pad)).astype(np.float32)
    k = np.ones(3, np.float32) / 3
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1, tex)
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0, tex)
    lefts = np.stack([tex[:, :W]] * len(shifts))
    rights = np.stack([tex[:, s : s + W] for s in shifts])
    return lefts, rights


def _medians(res):
    d = np.asarray(res.disparity)
    return [float(np.median(d[t, 8:-8, 24:-8])) for t in range(d.shape[0])]


def test_seeded_frames_track_drifting_disparity():
    """±1 px/frame drift stays within the refine radius: every seeded frame
    recovers the planted disparity without re-running the pyramid."""
    shifts = [5, 6, 7, 8, 9, 10]
    lefts, rights = _clip(shifts)
    run = StereoModel(backend="hierarchical", match=MATCH,
                      pyramid=PYR).video(keyframe_interval=4)
    meds = _medians(run(lefts, rights))
    for t, (m, s) in enumerate(zip(meds, shifts)):
        assert abs(m - s) <= 0.75, (t, m, s)


def test_keyframe_recovers_beyond_radius_jump():
    """A disparity jump beyond ±radius breaks the seeded frames (documented
    contract) and the next keyframe self-corrects."""
    shifts = [4, 4, 12, 12, 12, 12]  # +8 px at t=2 >> radius 4
    lefts, rights = _clip(shifts)
    run = StereoModel(backend="hierarchical", match=MATCH,
                      pyramid=PYR).video(keyframe_interval=4)
    meds = _medians(run(lefts, rights))
    assert abs(meds[0] - 4) <= 0.75
    assert abs(meds[4] - 12) <= 0.75  # keyframe at t=4 re-acquires
    assert abs(meds[5] - 12) <= 0.75  # and the next seeded frame holds it


def test_keyframe_interval_one_matches_per_frame_pyramid():
    shifts = [5, 7, 9]
    lefts, rights = _clip(shifts)
    model = StereoModel(backend="hierarchical", match=MATCH, pyramid=PYR)
    per_frame = np.stack(
        [np.asarray(model(lefts[t], rights[t]).disparity) for t in range(3)]
    )
    video = np.asarray(model.video(keyframe_interval=1)(lefts, rights).disparity)
    np.testing.assert_array_equal(per_frame, video)


def test_video_lr_check_flags_and_rejects_unsupported_backend():
    shifts = [5, 6]
    lefts, rights = _clip(shifts)
    model = StereoModel(backend="hierarchical", match=MATCH,
                        pyramid=PYR, lr_check=True)
    res = model.video(keyframe_interval=2)(lefts, rights)
    v = np.asarray(res.valid)
    assert v.shape == (2, H, W) and v.mean() > 0.5
    with pytest.raises(NotImplementedError):
        StereoModel(backend="dense").video()


def test_sharded_temporal_equals_single():
    """Sharded temporal video == single-device temporal bit-for-bit on the
    fake mesh (same effective tile_rows — the pyramid seam-exactness
    standard, applied to the seeded steps and the keyframe pyramid alike)."""
    import jax.numpy as jnp

    from stepth.match import pyramid
    from stepth.parallel import mesh as mesh_mod
    from stepth.parallel.sharded import match_temporal_sharded

    h, w = 128, 256
    shifts = [5, 6, 7, 8]
    rng = np.random.default_rng(11)
    pad = max(shifts) + 2
    tex = rng.uniform(0, 255, (h, w + pad)).astype(np.float32)
    lefts = jnp.asarray(np.stack([tex[:, :w]] * len(shifts)))
    rights = jnp.asarray(np.stack([tex[:, s : s + w] for s in shifts]))
    cfg = MatchConfig(num_disparities=32, window=9)
    pyr = PyramidConfig(levels=3, refine_radius=4, coarsest_disparities=8)
    ref = pyramid.match_temporal(
        lefts, rights, cfg, pyr, keyframe_interval=2, tile_rows=8,
    )
    for ntile in (2, 4):
        m = mesh_mod.make_mesh(data=1, tile=ntile)
        got = match_temporal_sharded(
            lefts, rights, cfg, pyr, m, keyframe_interval=2, tile_rows=8,
        )
        np.testing.assert_array_equal(
            np.asarray(ref.disparity), np.asarray(got.disparity)
        )
        np.testing.assert_array_equal(
            np.asarray(ref.valid), np.asarray(got.valid)
        )


def test_video_sgm_coarse_backend():
    """`StereoModel.video` with the SGM-coarse hybrid: keyframes run the SGM
    coarse stage, seeded frames the same refine as the WTA-coarse pyramid."""
    shifts = [5, 6, 7]
    lefts, rights = _clip(shifts)
    run = StereoModel(backend="hierarchical-sgm", match=MATCH,
                      pyramid=PYR).video(keyframe_interval=2)
    meds = _medians(run(lefts, rights))
    for t, (m, s) in enumerate(zip(meds, shifts)):
        assert abs(m - s) <= 0.75, (t, m, s)
