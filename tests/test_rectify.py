"""Stereo rectification: epipolar property (analytic), identity rig, remap,
and the full rectify → match → depth flow on a synthetic rotated rig."""

import numpy as np
import pytest
import jax.numpy as jnp

from stepth.ops import rectify


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


K = np.array([[200.0, 0, 96.0], [0, 200.0, 64.0], [0, 0, 1.0]], np.float32)


def test_identity_rig_maps_are_identity():
    """Already-rectified rig (R=I, baseline along -x in cam2 coords): the
    rectifying maps are the identity and the constants are the rig's."""
    T = np.array([-0.5, 0.0, 0.0], np.float32)  # c2 = +0.5 x
    maps = rectify.rectify_maps(K, K, np.eye(3, dtype=np.float32), T, (128, 192))
    xx, yy = np.meshgrid(np.arange(192, dtype=np.float32), np.arange(128, dtype=np.float32))
    np.testing.assert_allclose(np.asarray(maps.map_left[..., 0]), xx, atol=1e-3)
    np.testing.assert_allclose(np.asarray(maps.map_left[..., 1]), yy, atol=1e-3)
    np.testing.assert_allclose(np.asarray(maps.map_right[..., 0]), xx, atol=1e-3)
    np.testing.assert_allclose(np.asarray(maps.map_right[..., 1]), yy, atol=1e-3)
    assert abs(float(maps.focal) - 200.0) < 1e-4
    assert abs(float(maps.baseline) - 0.5) < 1e-6


def test_epipolar_rows_align_after_rectification(rng):
    """The defining property, checked analytically: random 3-D points
    projected through the two RECTIFIED cameras land on equal rows, and
    disparity equals focal·baseline/Z_rect."""
    R = (_rot("y", 3.0) @ _rot("x", -2.0) @ _rot("z", 1.5)).astype(np.float32)
    T = np.array([-0.6, 0.04, 0.02], np.float32)
    maps = rectify.rectify_maps(K, K, R, T, (128, 192))

    pts = rng.uniform(-1.0, 1.0, (500, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    uv1, uv2 = rectify.project_rectified(jnp.asarray(pts), maps, R, T)
    uv1 = np.asarray(uv1)
    uv2 = np.asarray(uv2)
    np.testing.assert_allclose(uv1[:, 1], uv2[:, 1], atol=1e-3)  # equal rows
    # disparity = f·B / depth along the rectified z axis
    disp = uv1[:, 0] - uv2[:, 0]
    c2 = -R.T @ T
    v1 = c2 / np.linalg.norm(c2)
    old_z = np.array([0, 0, 1.0], np.float32)
    v2 = np.cross(old_z, v1)
    v2 /= np.linalg.norm(v2)
    v3 = np.cross(v1, v2)
    z_rect = pts @ v3
    expect = float(maps.focal) * float(maps.baseline) / z_rect
    np.testing.assert_allclose(disp, expect, rtol=1e-4, atol=1e-3)
    assert (disp > 0).all()  # left-minus-right positive: standard convention


def test_remap_identity_and_shift(rng):
    img = rng.uniform(0, 255, (32, 48)).astype(np.float32)
    xx, yy = np.meshgrid(np.arange(48, dtype=np.float32), np.arange(32, dtype=np.float32))
    ident = jnp.asarray(np.stack([xx, yy], -1))
    out = rectify.remap_bilinear(img, ident)
    np.testing.assert_allclose(np.asarray(out), img, atol=1e-4)
    # integer shift right by 5: out(x) = img(x-5); left margin filled
    shift5 = jnp.asarray(np.stack([xx - 5, yy], -1))
    out5 = np.asarray(rectify.remap_bilinear(img, shift5, fill=-1.0))
    np.testing.assert_allclose(out5[:, 5:], img[:, :-5], atol=1e-4)
    assert (out5[:, :4] == -1.0).all()


def test_rectify_then_match_recovers_depth(rng):
    """End-to-end: synthesize two views of a fronto-parallel textured plane
    with a mildly rotated right camera, rectify, run the dense matcher, and
    recover the plane's depth from disparity."""
    from stepth.config import MatchConfig
    from stepth.match import dense

    h, w = 96, 160
    depth_z = 5.0
    R = _rot("y", 2.0).astype(np.float32)
    T = np.array([-0.5, 0.0, 0.0], np.float32)

    # plane texture sampled analytically in each ORIGINAL camera: the plane
    # point seen by pixel p is X = Z * K⁻¹p (cam1); texture value = smooth
    # function of the world (x, y) hit point
    def tex(xw, yw):
        return (
            120
            + 60 * np.sin(2.3 * xw * 3.0)
            + 50 * np.cos(1.7 * yw * 3.0)
            + 20 * np.sin(5.1 * (xw + yw) * 3.0)
        )

    Kinv = np.linalg.inv(K)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    rays1 = np.einsum("ij,hwj->hwi", Kinv, np.stack([xx, yy, np.ones_like(xx)], -1))
    X1 = rays1 * (depth_z / rays1[..., 2:3])  # cam1-frame plane points
    left = tex(X1[..., 0], X1[..., 1]).astype(np.float32)

    # right camera: pixel p2 → ray → intersect plane z_cam1 = depth_z.
    # x_cam2 = R x_cam1 + T ⇒ x_cam1 = Rᵀ(x_cam2 − T); ray in cam1:
    # x_cam1 = Rᵀ s d − Rᵀ T, pick s so z == depth_z
    rays2 = np.einsum("ij,hwj->hwi", Kinv, np.stack([xx, yy, np.ones_like(xx)], -1))
    d1 = np.einsum("ji,hwj->hwi", R, rays2)  # Rᵀ · ray
    o1 = -R.T @ T
    s = (depth_z - o1[2]) / d1[..., 2]
    X1r = o1 + s[..., None] * d1
    right = tex(X1r[..., 0], X1r[..., 1]).astype(np.float32)

    maps = rectify.rectify_maps(K, K, R, T, (h, w))
    lrect, rrect = rectify.rectify_pair(left, right, maps)

    res = dense.match_pair(lrect, rrect, MatchConfig(num_disparities=32, window=9))
    interior = np.asarray(res.disparity)[24:-24, 40:-40]
    # expected disparity: f·B/Z_rect; the plane is fronto-parallel in cam1 but
    # Z_rect varies slightly across the image — compare against the median of
    # the analytic value over the same interior
    pts = X1[24:-24, 40:-40].reshape(-1, 3)
    c2 = -R.T @ T
    v1 = c2 / np.linalg.norm(c2)
    v2 = np.cross([0, 0, 1.0], v1).astype(np.float32)
    v2 /= np.linalg.norm(v2)
    v3 = np.cross(v1, v2)
    z_rect = pts @ v3
    expect = float(maps.focal) * float(maps.baseline) / z_rect
    assert abs(np.median(interior) - np.median(expect)) <= 0.5


def test_distortion_folded_into_maps(rng):
    """With lens distortion: for random 3-D points, the map sampled at the
    point's rectified pixel returns the point's *distorted* source pixel —
    i.e. one remap both undistorts and rectifies."""
    from jax.scipy.ndimage import map_coordinates

    R = _rot("y", 2.5).astype(np.float32)
    T = np.array([-0.5, 0.02, 0.0], np.float32)
    dist1 = np.array([-0.12, 0.03, 0.001, -0.0005], np.float32)
    dist2 = np.array([-0.08, 0.02, -0.0008, 0.0004], np.float32)
    maps = rectify.rectify_maps(K, K, R, T, (128, 192), dist1=dist1, dist2=dist2)

    pts = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    uv1, uv2 = rectify.project_rectified(jnp.asarray(pts), maps, R, T)

    def distorted_px(X_cam, Kmat, dist):
        xn = X_cam[:, :2] / X_cam[:, 2:3]
        xd = np.asarray(rectify.distort_normalized(jnp.asarray(xn), dist))
        return xd * np.array([Kmat[0, 0], Kmat[1, 1]]) + np.array(
            [Kmat[0, 2], Kmat[1, 2]]
        )

    exp1 = distorted_px(pts, K, dist1)
    exp2 = distorted_px(pts @ R.T + T, K, dist2)

    for m, uv, exp in ((maps.map_left, uv1, exp1), (maps.map_right, uv2, exp2)):
        uv = np.asarray(uv)
        inb = (
            (uv[:, 0] > 1) & (uv[:, 0] < 190) & (uv[:, 1] > 1) & (uv[:, 1] < 126)
        )
        got_x = np.asarray(
            map_coordinates(m[..., 0], [uv[inb, 1], uv[inb, 0]], order=1)
        )
        got_y = np.asarray(
            map_coordinates(m[..., 1], [uv[inb, 1], uv[inb, 0]], order=1)
        )
        assert inb.sum() > 100
        np.testing.assert_allclose(got_x, exp[inb, 0], atol=0.05)
        np.testing.assert_allclose(got_y, exp[inb, 1], atol=0.05)


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("kind", ["affine", "random"])
def test_remap_bilinear_matches_scipy(rng, channels, kind):
    """``remap_bilinear`` is order-1 ``map_coordinates`` per plane, with the
    fill value outside the source image."""
    from scipy.ndimage import map_coordinates

    h, w = 37, 53
    shape = (h, w) if channels == 0 else (h, w, channels)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    if kind == "affine":
        mx, my = 0.97 * xx + 0.05 * yy + 1.3, -0.02 * xx + 1.01 * yy - 0.7
    else:
        mx = rng.uniform(-2, w + 1, (h, w)).astype(np.float32)
        my = rng.uniform(-2, h + 1, (h, w)).astype(np.float32)
    map_xy = np.stack([mx, my], -1).astype(np.float32)
    got = np.asarray(rectify.remap_bilinear(jnp.asarray(img), jnp.asarray(map_xy),
                                            fill=-7.0))
    inb = (mx >= 0) & (mx <= w - 1) & (my >= 0) & (my <= h - 1)
    planes = [img] if channels == 0 else [img[..., c] for c in range(channels)]
    want = [
        np.where(inb, map_coordinates(p.astype(np.float64), [my, mx], order=1,
                                      mode="nearest"), -7.0)
        for p in planes
    ]
    want = want[0] if channels == 0 else np.stack(want, -1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
