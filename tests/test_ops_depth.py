"""Depth utilities vs. reference semantics (reference src/depth_image.rs)."""

import numpy as np

from stepth.ops import depth as d


def test_invert(rng):
    x = rng.integers(0, 256, size=(10, 12), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(d.invert(x)), 255 - x)


def test_highlight_depth(rng):
    img = rng.integers(0, 256, size=(10, 12, 4), dtype=np.uint8)
    dep = rng.integers(0, 256, size=(10, 12), dtype=np.uint8)
    got = np.asarray(d.highlight_depth(img, dep))
    mult = dep.astype(np.float32) / 255.0 * 2.0
    exp_rgb = np.clip(img[..., :3].astype(np.float32) * mult[..., None], 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got[..., :3], exp_rgb)
    np.testing.assert_array_equal(got[..., 3], img[..., 3])


def test_slice_mask_bounds(rng):
    dep = rng.integers(0, 256, size=(10, 12), dtype=np.uint8)
    got = np.asarray(d.slice_mask(dep, 50, 180))
    exp = np.where((dep >= 50) & (dep <= 180), 255, 0).astype(np.uint8)
    np.testing.assert_array_equal(got, exp)
    # None defaults (reference :230-231)
    np.testing.assert_array_equal(np.asarray(d.slice_mask(dep, None, None)), np.full((10, 12), 255, np.uint8))


def test_frame_depth_method_backends(rng):
    """DepthFrame.load_depth_from_additional supports the production backends."""
    import jax.numpy as jnp
    from stepth import DepthFrame

    tex = rng.uniform(0, 255, (48, 132, 3)).astype(np.uint8)
    main = tex[:, :128]
    add = tex[:, 4:]
    f = DepthFrame.from_array(main)
    d_dense = f.load_depth_from_additional(add, (36,) * 3, method="dense")
    assert d_dense.depth.shape == (48, 128)
    assert np.asarray(d_dense.depth).max() > 0
    if True:  # native path when toolchain present
        from stepth import native

        if native.available():
            d_nat = f.load_depth_from_additional(add, (36,) * 3, method="native")
            assert d_nat.depth.shape == (48, 128)
