"""Dense fast-path matcher tests (stepth/match/dense.py, pyramid.py).

Synthetic rectified pairs with known ground-truth shift; interior-region
accuracy assertions (borders/occlusions excluded)."""

import numpy as np
import jax.numpy as jnp
import pytest

from stepth.config import MatchConfig, PyramidConfig
from stepth.match import dense, pyramid


def make_pair(rng, h=64, w=96, shift=5):
    """Right image = left shifted right→left by ``shift`` px (standard stereo:
    left pixel x matches right pixel x − shift)."""
    # smooth random texture so matching is well-posed
    tex = rng.uniform(0, 255, size=(h, w + shift)).astype(np.float32)
    k = np.ones(5) / 5
    for axis in (0, 1):
        tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, tex)
    left = tex[:, :w]  # left(x) = tex[x]
    right = tex[:, shift:]  # right(x) = tex[x+shift] ⇒ left(x) = right(x−shift)
    return left, right


def interior(arr, margin=8):
    return arr[margin:-margin, margin:-margin]


@pytest.mark.parametrize("cost", ["sad", "ssd", "census"])
def test_constant_shift_recovered(rng, cost):
    shift = 6
    left, right = make_pair(rng, shift=shift)
    cfg = MatchConfig(num_disparities=16, window=9, cost=cost)
    res = dense.match_pair(left, right, cfg)
    err = np.abs(np.asarray(interior(res.disparity)) - shift)
    assert np.median(err) <= 1.0
    assert (err <= 1.5).mean() > 0.9


def test_box_aggregate_matches_naive(rng):
    x = rng.uniform(0, 1, size=(12, 13, 4)).astype(np.float32)
    win = 5
    got = np.asarray(dense.box_aggregate(jnp.asarray(x), win))
    r = win // 2
    h, w, _ = x.shape
    for y in (0, 3, 11):
        for xx in (0, 6, 12):
            ylo, yhi = max(y - r, 0), min(y + r + 1, h)
            xlo, xhi = max(xx - r, 0), min(xx + r + 1, w)
            patch = x[ylo:yhi, xlo:xhi]
            want = patch.sum(axis=(0, 1))
            np.testing.assert_allclose(got[y, xx], want, rtol=1e-4)


def test_census_is_illumination_invariant(rng):
    g = rng.uniform(10, 200, size=(16, 16)).astype(np.float32)
    c1 = np.asarray(dense.census_transform(jnp.asarray(g), 5))
    c2 = np.asarray(dense.census_transform(jnp.asarray(g * 1.5 + 3.0), 5))
    np.testing.assert_array_equal(c1, c2)


def test_right_disparity_from_volume():
    # cost volume with a unique best at d=3 for every x where x+3 < w
    h, w, d = 4, 10, 6
    agg = np.ones((h, w, d), dtype=np.float32)
    agg[:, :, 3] = 0.0
    dr = np.asarray(dense.right_disparity_from_volume(jnp.asarray(agg)))
    assert (dr[:, : w - 3] == 3).all()


def test_lr_consistency_flags_mismatch():
    disp_l = jnp.full((4, 10), 2.0)
    disp_r = jnp.full((4, 10), 2.0)
    ok = np.asarray(dense.lr_consistency(disp_l, disp_r, 1.0))
    assert ok[:, 3:].all()
    disp_r2 = jnp.full((4, 10), 7.0)
    bad = np.asarray(dense.lr_consistency(disp_l, disp_r2, 1.0))
    assert not bad.any()


def test_fill_invalid_takes_nearer_side():
    disp = jnp.asarray([[5.0, 0.0, 0.0, 2.0]])
    valid = jnp.asarray([[True, False, False, True]])
    out = np.asarray(dense.fill_invalid(disp, valid))
    np.testing.assert_allclose(out, [[5.0, 2.0, 2.0, 2.0]])


def test_fill_invalid_all_invalid_is_zero():
    disp = jnp.asarray([[3.0, 4.0]])
    valid = jnp.asarray([[False, False]])
    out = np.asarray(dense.fill_invalid(disp, valid))
    np.testing.assert_allclose(out, [[0.0, 0.0]])


def test_median3_removes_speckle():
    x = np.full((8, 8), 4.0, dtype=np.float32)
    x[4, 4] = 99.0
    out = np.asarray(dense.median3(jnp.asarray(x)))
    np.testing.assert_allclose(out, 4.0)


def test_subpixel_interpolates_between_integers(rng):
    # fractional true shift: right sampled at x - 4.5 via linear interp
    h, w = 48, 80
    shift = 4.5
    tex = rng.uniform(0, 255, size=(h, w + 8)).astype(np.float64)
    k = np.ones(7) / 7
    for axis in (0, 1):
        tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, tex)
    xs = np.arange(w) + shift
    x0 = xs.astype(int)
    frac = xs - x0
    left = tex[:, :w]
    right = tex[:, x0] * (1 - frac) + tex[:, x0 + 1] * frac  # right(x) = tex[x+4.5]
    cfg = MatchConfig(num_disparities=12, window=11, cost="sad", lr_threshold=None)
    res = dense.match_pair(left, right, cfg)
    err = np.abs(np.asarray(interior(res.disparity)) - shift)
    assert np.median(err) < 0.5


def test_hierarchical_matches_constant_shift(rng):
    shift = 10
    left, right = make_pair(rng, h=96, w=128, shift=shift)
    res = pyramid.match_hierarchical(
        left,
        right,
        MatchConfig(num_disparities=32, window=9),
        PyramidConfig(levels=3, refine_radius=3, coarsest_disparities=8),
    )
    err = np.abs(np.asarray(interior(res.disparity, 12)) - shift)
    assert np.median(err) <= 1.0


def test_disparity_to_depth_u8_range():
    disp = jnp.asarray([[0.0, 31.5, 63.0]])
    out = np.asarray(dense.disparity_to_depth_u8(disp, 64))
    assert out.dtype == np.uint8
    assert out[0, 0] == 0 and out[0, 2] == 255
    assert 125 <= out[0, 1] <= 130


def test_batched_model_equals_per_frame(rng):
    """models.StereoModel.batched(): one-dispatch serving path over stacked
    pairs equals the per-frame call bit-for-bit (lax.scan adds no math)."""
    import jax

    from stepth.models import stereo

    B, h, w, shift = 3, 48, 96, 4
    base = (np.cumsum(rng.uniform(0, 255, (B, h, w)), axis=2) % 255).astype(
        np.float32
    )
    left = jnp.asarray(base)
    right = jnp.asarray(np.roll(base, -shift, axis=2))
    model = stereo.StereoModel(
        backend="dense", match=MatchConfig(num_disparities=8, window=5)
    )
    out = jax.jit(model.batched())(left, right)
    assert out.disparity.shape == (B, h, w)
    for i in range(B):
        ref = model(left[i], right[i])
        np.testing.assert_array_equal(
            np.asarray(out.disparity[i]), np.asarray(ref.disparity)
        )
        np.testing.assert_array_equal(
            np.asarray(out.valid[i]), np.asarray(ref.valid)
        )


def test_batched_model_flagship_interpret(rng):
    """The batched path also wraps the flagship (dense) configuration."""
    import jax

    from stepth.models import stereo

    B, h, w, shift = 2, 32, 160, 3
    base = (np.cumsum(rng.uniform(0, 255, (B, h, w)), axis=2) % 255).astype(
        np.float32
    )
    left = jnp.asarray(base)
    right = jnp.asarray(np.roll(base, -shift, axis=2))
    model = stereo.flagship(num_disparities=8)
    out = jax.jit(model.batched())(left, right)
    for i in range(B):
        ref = model(left[i], right[i])
        np.testing.assert_array_equal(
            np.asarray(out.disparity[i]), np.asarray(ref.disparity)
        )
