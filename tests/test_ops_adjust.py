"""Image adjustments (image-rs colorops semantics, docs/SEMANTICS.md; reference
call sites src/mask_image.rs:111-141)."""

import numpy as np

from stepth.ops import adjust


def test_brighten_saturating(rng):
    img = rng.integers(0, 256, size=(8, 10, 4), dtype=np.uint8)
    got = np.asarray(adjust.brighten(img, 50))
    exp_rgb = np.clip(img[..., :3].astype(np.int32) + 50, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got[..., :3], exp_rgb)
    np.testing.assert_array_equal(got[..., 3], img[..., 3])  # alpha unchanged
    got_neg = np.asarray(adjust.brighten(img, -200))
    assert got_neg[..., :3].max() <= 55


def test_contrast_formula(rng):
    img = rng.integers(0, 256, size=(8, 10, 4), dtype=np.uint8)
    got = np.asarray(adjust.contrast(img, 30.0))
    percent = np.float32(((100.0 + 30.0) / 100.0) ** 2)
    v = img[..., :3].astype(np.float32) / 255.0
    exp = np.clip(((v - 0.5) * percent + 0.5) * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got[..., :3], exp)
    np.testing.assert_array_equal(got[..., 3], img[..., 3])


def test_blur_smooths_edge():
    img = np.zeros((16, 16, 4), dtype=np.uint8)
    img[:, 8:, :3] = 255
    img[..., 3] = 255
    out = np.asarray(adjust.blur(img, 2.0))
    assert 0 < out[8, 7, 0] < 255
    assert (out[..., 3] == 255).all()  # constant alpha preserved


def test_unsharpen_threshold():
    img = np.zeros((16, 16, 4), dtype=np.uint8)
    img[:, 8:, :3] = 255
    img[..., 3] = 255
    out = np.asarray(adjust.unsharpen(img, 2.0, 20))
    blurred = np.asarray(adjust.blur(img, 2.0)).astype(np.int32)
    a = img.astype(np.int32)
    diff = a - blurred
    exp = np.where(np.abs(diff) > 20, np.clip(a + diff, 0, 255), a).astype(np.uint8)
    np.testing.assert_array_equal(out, exp)
