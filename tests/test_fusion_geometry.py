"""SE(3)/projection geometry tests (stepth/fusion/geometry.py)."""

import numpy as np
import jax.numpy as jnp

from stepth.fusion import geometry as geo


def rand_pose(rng, scale=0.5):
    return jnp.asarray(
        np.concatenate([rng.normal(0, scale, 3), rng.normal(0, 1.0, 3)]), jnp.float32
    )


def test_exp_log_so3_roundtrip(rng):
    w = jnp.asarray(rng.normal(0, 0.8, (16, 3)), jnp.float32)
    R = geo.exp_so3(w)
    w2 = geo.log_so3(R)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=2e-4)


def test_rotation_orthonormal(rng):
    R = np.asarray(geo.exp_so3(jnp.asarray(rng.normal(0, 1.0, (8, 3)), jnp.float32)))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), R.shape)
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), eye, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_compose_inverse_identity(rng):
    a = rand_pose(rng)
    ainv = geo.inverse(a)
    ident = geo.compose(a, ainv)
    np.testing.assert_allclose(np.asarray(ident), 0.0, atol=1e-5)


def test_transform_matches_compose(rng):
    a, b = rand_pose(rng), rand_pose(rng)
    pts = jnp.asarray(rng.normal(0, 2.0, (10, 3)), jnp.float32)
    via_compose = geo.transform(geo.compose(a, b)[None], pts)
    via_seq = geo.transform(a[None], geo.transform(b[None], pts))
    np.testing.assert_allclose(np.asarray(via_compose), np.asarray(via_seq), atol=1e-4)


def test_project_unproject_roundtrip(rng):
    intr = jnp.asarray([500.0, 480.0, 320.0, 240.0])
    depth = jnp.asarray(rng.uniform(1.0, 10.0, (20,)), jnp.float32)
    uv = jnp.asarray(rng.uniform(0, 640, (20, 2)), jnp.float32)
    pts = geo.unproject(uv, depth, intr)
    uv2 = geo.project(pts, intr)
    np.testing.assert_allclose(np.asarray(uv2), np.asarray(uv), atol=1e-3)


def test_relative_pose(rng):
    a, b = rand_pose(rng), rand_pose(rng)
    rel = geo.relative(a, b)
    np.testing.assert_allclose(
        np.asarray(geo.compose(a, rel)), np.asarray(b), atol=1e-4
    )


def test_disparity_to_depth():
    disp = jnp.asarray([0.0, 1.0, 10.0])
    z = np.asarray(geo.disparity_to_depth(disp, focal=100.0, baseline=0.5))
    assert z[0] == 0.0
    np.testing.assert_allclose(z[1:], [50.0, 5.0])
