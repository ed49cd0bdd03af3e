"""Brightness normalization (reference src/operations.rs; docs/SEMANTICS.md §8)."""

import numpy as np

from stepth.ops import photometric as p


def test_luma16_gain_and_noop(rng):
    a = rng.integers(0, 1 << 12, size=(20, 30), dtype=np.uint16)
    b = (a.astype(np.uint32) * 2).clip(0, 65535).astype(np.uint16)
    out = p.normalize_brightness_luma16_exact(a, b, percent=0.01)
    fbr = int(a.sum(dtype=np.uint64)) // a.size
    sbr = int(b.sum(dtype=np.uint64)) // b.size
    diff = sbr / fbr
    np.testing.assert_array_equal(out, (a.astype(np.float64) * diff).astype(np.uint16))
    # within tolerance -> exact copy (reference :30-32)
    np.testing.assert_array_equal(p.normalize_brightness_luma16_exact(a, a, 0.5), a)


def test_rgb16_per_channel(rng):
    a = rng.integers(1, 1 << 12, size=(16, 16, 3), dtype=np.uint16)
    gains = np.array([1.5, 0.75, 2.0])
    b = (a.astype(np.float64) * gains).astype(np.uint16)
    out = p.normalize_brightness_rgb16_exact(a, b, percent=0.01)
    m1 = a.reshape(-1, 3).astype(np.float64).mean(axis=0)
    m2 = b.reshape(-1, 3).astype(np.float64).mean(axis=0)
    exp = (a.astype(np.float64) * (m2 / m1)).astype(np.uint16)
    np.testing.assert_array_equal(out, exp)


def test_rgb16_noop_requires_all_channels(rng):
    a = rng.integers(1, 1000, size=(8, 8, 3), dtype=np.uint16)
    out = p.normalize_brightness_rgb16_exact(a, a, percent=0.1)
    np.testing.assert_array_equal(out, a)


def test_device_f32_close_to_exact(rng):
    a = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    b = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    out = np.asarray(p.normalize_brightness_f32(a.astype(np.uint16), b.astype(np.uint16)))
    exp = p.normalize_brightness_rgb16_exact(a.astype(np.uint16), b.astype(np.uint16), 0.0)
    assert np.abs(out.astype(np.int32) - exp.astype(np.int32)).max() <= 1
