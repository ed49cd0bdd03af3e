"""Mask algebra vs. straightforward NumPy models of the reference semantics
(reference src/mask_image.rs; docs/SEMANTICS.md §6)."""

import numpy as np

from stepth.ops import mask as m


def _rand_mask(rng, h=16, w=24):
    # include gray values to exercise the exact-equality (quirk Q6) semantics
    return rng.choice([0, 17, 128, 254, 255], size=(h, w)).astype(np.uint8)


def _rand_rgba(rng, h=16, w=24):
    return rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)


def test_mask_and_or_exact_equality(rng):
    a, b = _rand_mask(rng), _rand_mask(rng)
    got_and = np.asarray(m.mask_and(a, b))
    got_or = np.asarray(m.mask_or(a, b))
    exp_and = np.where((a == 255) & (b == 255), 255, 0).astype(np.uint8)
    exp_or = np.where((a == 255) | (b == 255), 255, 0).astype(np.uint8)
    np.testing.assert_array_equal(got_and, exp_and)
    np.testing.assert_array_equal(got_or, exp_or)


def test_mask_not_is_255_complement_not_boolean(rng):
    a = _rand_mask(rng)
    got = np.asarray(m.mask_not(a))
    np.testing.assert_array_equal(got, (255 - a.astype(np.int32)).astype(np.uint8))
    # gray stays gray (reference src/mask_image.rs:193-195)
    assert np.asarray(m.mask_not(np.full((2, 2), 128, np.uint8)))[0, 0] == 127


def test_apply_mask_zeroes_only_exact_false(rng):
    img = _rand_rgba(rng)
    mask = _rand_mask(rng)
    got = np.asarray(m.apply(img, mask))
    exp = img.copy()
    exp[mask == 0] = 0  # gray pixels untouched (reference :205-213)
    np.testing.assert_array_equal(got, exp)


def test_highlight_matches_f32_reference_semantics(rng):
    img = _rand_rgba(rng)
    mask = _rand_mask(rng)
    got = np.asarray(m.highlight(img, mask))
    exp = img.copy()
    t = mask == 255
    exp[..., 0] = np.where(t, np.minimum(img[..., 0].astype(np.float32) * 2.0, 255).astype(np.uint8), img[..., 0])
    exp[..., 1] = np.where(t, (img[..., 1].astype(np.float32) * 0.5).astype(np.uint8), img[..., 1])
    exp[..., 2] = np.where(t, (img[..., 2].astype(np.float32) * 0.5).astype(np.uint8), img[..., 2])
    np.testing.assert_array_equal(got, exp)


def test_image_replace_origin(rng):
    img, other = _rand_rgba(rng), _rand_rgba(rng)
    mask = _rand_mask(rng)
    got = np.asarray(m.image_replace(img, mask, other, (0, 0)))
    exp = np.where((mask == 255)[..., None], other, img)
    np.testing.assert_array_equal(got, exp)


def test_image_replace_offset_absolute_reads(rng):
    # quirk Q4: the source is read at absolute coordinates
    img = _rand_rgba(rng, 16, 24)
    other = _rand_rgba(rng, 16, 24)
    mask = np.full((16, 24), 255, np.uint8)
    got = np.asarray(m.image_replace(img, mask, other, (4, 6)))
    exp = img.copy()
    exp[4:16, 6:24] = other[4:16, 6:24]  # absolute, not other[0:12, 0:18]
    np.testing.assert_array_equal(got, exp)


def test_conform_resizes_and_rebinarizes(rng):
    small = rng.integers(0, 256, size=(8, 12), dtype=np.uint8)
    out = np.asarray(m.conform(small, (16, 24)))
    assert out.shape == (16, 24)
    out2 = np.asarray(m.conform(small, (16, 24), rebinarize=True))
    assert set(np.unique(out2)).issubset({0, 255})


def test_conform_mismatched_aspect_hits_exact_dims(rng):
    # deviation from the reference's aspect-preserving resize (docs/SEMANTICS.md §6)
    small = rng.integers(0, 256, size=(5, 5), dtype=np.uint8)
    out = np.asarray(m.conform(small, (10, 20)))
    assert out.shape == (10, 20)


def test_reset(rng):
    assert (np.asarray(m.reset((4, 5))) == 255).all()
