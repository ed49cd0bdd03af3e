"""Sparse feature front end: corners, descriptors, matching, and the full
images → pose integration with the epipolar module."""

import numpy as np
import jax.numpy as jnp

from stepth.match import features


def _checker_corners(rng, h=96, w=128, cell=16):
    """A checkerboard has unambiguous corners at cell intersections."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = (((yy // cell) + (xx // cell)) % 2).astype(np.float32) * 200.0
    img += rng.normal(0, 1.0, img.shape).astype(np.float32)
    return img


def test_harris_finds_checkerboard_corners(rng):
    img = _checker_corners(rng)
    c = features.harris_corners(img, max_corners=128, nms_radius=4)
    xy = np.asarray(c.xy)[np.asarray(c.valid)]
    assert len(xy) >= 30
    # top_k returns strongest-first; the static 128 slots tail off into noise
    # peaks, so judge localization on the strongest 30: near a cell
    # intersection (multiple of 16, the pixel-grid corner is at 15/16)
    top = xy[:30]
    fx = np.minimum(top[:, 0] % 16, 16 - top[:, 0] % 16)
    fy = np.minimum(top[:, 1] % 16, 16 - top[:, 1] % 16)
    assert (np.maximum(fx, fy) <= 2.0).mean() > 0.9


def test_matching_recovers_known_shift(rng):
    shift = 7
    tex = rng.uniform(0, 255, (96, 160 + shift)).astype(np.float32)
    k = np.ones(3) / 3
    for ax in (0, 1):
        tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), ax, tex)
    left, right = tex[:, :160], tex[:, shift:]
    uv1, uv2 = features.match_pair_features(left, right, max_corners=256)
    assert uv1.shape[0] >= 30
    dx = np.asarray(uv1[:, 0]) - np.asarray(uv2[:, 0])
    dy = np.asarray(uv1[:, 1]) - np.asarray(uv2[:, 1])
    good = (np.abs(dx - shift) <= 1.0) & (np.abs(dy) <= 1.0)
    assert good.mean() > 0.8, good.mean()


def test_images_to_pose_integration(rng):
    """The full sparse loop on a CURVED surface (a planar scene is the
    eight-point algorithm's degenerate configuration — E is not unique, so
    the first version of this test failed by design): render two views,
    detect + match features, recover the pose."""
    from stepth.fusion import epipolar
    from tests.test_rectify import K, _rot

    h, w = 128, 192
    R = _rot("y", 3.0).astype(np.float32)
    T = np.array([-0.5, 0.0, 0.0], np.float32)

    def zsurf(xw, yw):  # curved depth relief (non-planar)
        return 5.0 + 1.2 * np.sin(1.3 * xw) + 0.9 * np.cos(1.1 * yw)

    def tex(xw, yw):
        v = 120 + 60 * np.sin(7.1 * xw) + 50 * np.cos(5.3 * yw)
        v += 25 * np.sin(13.7 * xw + 11.9 * yw) + 15 * np.cos(23.0 * xw * yw)
        return v

    def render(rays, origin):
        # fixed-point ray-surface intersection: s·d_z + o_z = z(s·d_xy + o_xy)
        s = (5.0 - origin[2]) / rays[..., 2]
        for _ in range(50):
            X = origin + s[..., None] * rays
            s = (zsurf(X[..., 0], X[..., 1]) - origin[2]) / rays[..., 2]
        X = origin + s[..., None] * rays
        return tex(X[..., 0], X[..., 1]).astype(np.float32)

    Kinv = np.linalg.inv(K)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    rays1 = np.einsum("ij,hwj->hwi", Kinv, np.stack([xx, yy, np.ones_like(xx)], -1))
    left = render(rays1, np.zeros(3, np.float32))
    d1 = np.einsum("ji,hwj->hwi", R, rays1)  # cam2 rays in cam1 frame
    right = render(d1, -R.T @ T)

    uv1, uv2 = features.match_pair_features(
        left, right, max_corners=512, min_similarity=0.8
    )
    assert uv1.shape[0] >= 40
    t_unit = T / np.linalg.norm(T)

    # eight-point alone: the translation DIRECTION is weakly observable in
    # this geometry (narrow FOV, shallow relief, sub-pixel match noise) —
    # expect rough agreement only
    R8, T8, _ = epipolar.pose_from_correspondences(uv1, uv2, K, K, refine=False)
    assert np.abs(np.asarray(R8) - R).max() < 0.15
    assert float(np.dot(np.asarray(T8), t_unit)) > 0.6

    # + robust two-view BA (the default): maximum-likelihood recovery
    Rb, Tb, _ = epipolar.pose_from_correspondences(uv1, uv2, K, K)
    assert np.abs(np.asarray(Rb) - R).max() < 2e-2
    cosang = float(np.dot(np.asarray(Tb), t_unit))
    assert cosang > 0.99, cosang
