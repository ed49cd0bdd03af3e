"""Two-view geometry: essential matrix, pose recovery, triangulation, and the
integration with rectification."""

import numpy as np
import jax.numpy as jnp

from stepth.fusion import epipolar, geometry as geo
from tests.test_rectify import K, _rot


def _rig(rng, n=120):
    R = (_rot("y", 4.0) @ _rot("x", -2.0)).astype(np.float32)
    T = np.array([-0.8, 0.05, 0.03], np.float32)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pts[:, 2] += 7.0
    x1 = pts[:, :2] / pts[:, 2:3]
    p2 = pts @ R.T + T
    x2 = p2[:, :2] / p2[:, 2:3]
    return R, T, pts, x1.astype(np.float32), x2.astype(np.float32)


def test_essential_epipolar_constraint(rng):
    R, T, _, x1, x2 = _rig(rng)
    E = np.asarray(epipolar.estimate_essential(jnp.asarray(x1), jnp.asarray(x2)))
    h1 = np.concatenate([x1, np.ones((len(x1), 1), np.float32)], 1)
    h2 = np.concatenate([x2, np.ones((len(x2), 1), np.float32)], 1)
    resid = np.abs(np.einsum("ni,ij,nj->n", h2, E, h1))
    assert resid.max() < 1e-4, resid.max()
    # E ∝ [T]x R (up to sign/scale)
    Tx = np.array(
        [[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]], np.float32
    )
    E_gt = Tx @ R
    E_gt /= np.linalg.norm(E_gt)
    En = E / np.linalg.norm(E)
    assert min(np.abs(En - E_gt).max(), np.abs(En + E_gt).max()) < 1e-4


def test_recover_pose_and_triangulate(rng):
    R, T, pts, x1, x2 = _rig(rng)
    E = epipolar.estimate_essential(jnp.asarray(x1), jnp.asarray(x2))
    Rb, Tb, X = epipolar.recover_pose(E, jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(np.asarray(Rb), R, atol=1e-4)
    t_unit = T / np.linalg.norm(T)
    np.testing.assert_allclose(np.asarray(Tb), t_unit, atol=1e-4)
    # triangulated points match ground truth up to the global scale 1/|T|
    X = np.asarray(X)
    scale = np.median(pts[:, 2] / X[:, 2])
    np.testing.assert_allclose(X * scale, pts, rtol=2e-3, atol=2e-3)
    assert abs(scale - np.linalg.norm(T)) < 1e-3 * np.linalg.norm(T) + 1e-3


def test_pose_from_pixels_feeds_rectification(rng):
    """Pixels → pose → rectification: rows align in the rectified views."""
    from stepth.ops import rectify

    R, T, pts, _, _ = _rig(rng)
    uv1 = np.asarray(geo.project(jnp.asarray(pts), jnp.asarray([200.0, 200.0, 96.0, 64.0])))
    p2 = pts @ R.T + T
    uv2 = np.asarray(geo.project(jnp.asarray(p2), jnp.asarray([200.0, 200.0, 96.0, 64.0])))

    Rb, Tb, _ = epipolar.pose_from_correspondences(uv1, uv2, K, K)
    baseline = np.linalg.norm(T)  # known rig scale
    maps = rectify.rectify_maps(K, K, Rb, np.asarray(Tb) * baseline, (128, 192))
    r1, r2 = rectify.project_rectified(jnp.asarray(pts), maps, Rb, np.asarray(Tb) * baseline)
    np.testing.assert_allclose(
        np.asarray(r1)[:, 1], np.asarray(r2)[:, 1], atol=5e-3
    )
    assert abs(float(maps.baseline) - baseline) < 1e-5


def test_pose_recovery_pins_float32_precision(rng):
    """Pose recovery computes its products at full float32 whatever the
    default matmul precision: a run under "highest" gives the same pose, and
    so does one under the reduced "bfloat16" default a device may apply."""
    import jax

    _, _, pts, _, _ = _rig(rng)
    R, T = _rot("y", 4.0) @ _rot("x", -2.0), np.array([-0.8, 0.05, 0.03])
    intr = jnp.asarray([200.0, 200.0, 96.0, 64.0])
    uv1 = np.asarray(geo.project(jnp.asarray(pts), intr))
    uv2 = np.asarray(geo.project(jnp.asarray(pts @ R.T.astype(np.float32) + T.astype(np.float32)), intr))
    got = {}
    for prec in ("highest", "bfloat16"):
        with jax.default_matmul_precision(prec):
            Rb, Tb, _ = epipolar.pose_from_correspondences(uv1, uv2, K, K, ransac_iters=0)
        got[prec] = (np.asarray(Rb), np.asarray(Tb))
    np.testing.assert_allclose(got["bfloat16"][0], got["highest"][0], atol=1e-5)
    np.testing.assert_allclose(got["bfloat16"][1], got["highest"][1], atol=1e-5)
    np.testing.assert_allclose(got["highest"][0], R, atol=2e-3)

    # the CPU computes float32 dots exactly whatever is asked, so pin the
    # program itself: every matrix product in pose recovery asks for HIGHEST
    def dots(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn.params["precision"]
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from dots(sub)

    x1, x2 = jnp.asarray(uv1[:, :2] / 200.0), jnp.asarray(uv2[:, :2] / 200.0)
    E = epipolar.estimate_essential(x1, x2)
    precs = []
    for fn, args in (
        (epipolar.estimate_essential, (x1, x2)),
        (epipolar.recover_pose, (E, x1, x2)),
        (epipolar.epipolar_residuals, (E, x1, x2)),
        (epipolar.triangulate, (jnp.eye(3), jnp.ones(3), x1, x2)),
    ):
        precs += list(dots(jax.make_jaxpr(fn)(*args).jaxpr))
    assert precs, "no matrix products found"
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precs), precs
