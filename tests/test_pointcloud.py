"""Point-cloud export: back-projection round-trip and PLY writer."""

import numpy as np
import jax.numpy as jnp

from stepth.core import io
from stepth.fusion import geometry as geo


def test_depth_to_points_roundtrip():
    h, w = 24, 32
    intr = jnp.asarray([50.0, 55.0, 16.0, 12.0])
    depth = jnp.asarray(
        1.0 + np.random.default_rng(0).uniform(0, 4, (h, w)).astype(np.float32)
    )
    pts = geo.depth_to_points(depth, intr)
    assert pts.shape == (h, w, 3)
    np.testing.assert_allclose(np.asarray(pts[..., 2]), np.asarray(depth))
    uv = geo.project(pts, intr)
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    np.testing.assert_allclose(np.asarray(uv[..., 0]), uu, atol=1e-4)
    np.testing.assert_allclose(np.asarray(uv[..., 1]), vv, atol=1e-4)


def test_save_ply_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (10, 7, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (10, 7, 3)).astype(np.uint8)
    valid = rng.uniform(size=(10, 7)) > 0.3
    pts[0, 0] = np.nan  # non-finite points are dropped too
    valid[0, 0] = True
    path = tmp_path / "cloud.ply"
    n = io.save_ply(path, pts, colors=cols, valid=valid)
    assert n == int(valid.sum()) - 1

    raw = path.read_bytes()
    head, body = raw.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    assert lines[0] == "ply"
    assert f"element vertex {n}" in lines
    assert len(body) == n * (12 + 3)
    rec = np.frombuffer(
        body, dtype=[("xyz", "<f4", 3), ("rgb", np.uint8, 3)]
    )
    keep = valid.reshape(-1) & np.isfinite(pts.reshape(-1, 3)).all(1)
    np.testing.assert_allclose(rec["xyz"], pts.reshape(-1, 3)[keep])
    np.testing.assert_array_equal(rec["rgb"], cols.reshape(-1, 3)[keep])


def test_save_ply_no_colors(tmp_path):
    pts = np.zeros((5, 3), np.float32)
    path = tmp_path / "c2.ply"
    n = io.save_ply(path, pts)
    assert n == 5
    raw = path.read_bytes()
    head, body = raw.split(b"end_header\n", 1)
    assert len(body) == 5 * 12
    assert b"uchar red" not in head


def test_disparity_to_pointcloud_flow(tmp_path):
    """The full user flow: disparity → metric depth → points → PLY."""
    disp = jnp.full((16, 16), 8.0)
    depth = geo.disparity_to_depth(disp, focal=100.0, baseline=0.5)
    np.testing.assert_allclose(np.asarray(depth), 100.0 * 0.5 / 8.0)
    pts = geo.depth_to_points(depth, jnp.asarray([100.0, 100.0, 8.0, 8.0]))
    n = io.save_ply(tmp_path / "c3.ply", pts)
    assert n == 256
