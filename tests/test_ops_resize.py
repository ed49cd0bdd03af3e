"""Resampler: JAX op vs. NumPy oracle twin (bit-exact by construction of the Q15
fixed-point semantics, docs/SEMANTICS.md §5) plus behavioral properties."""

import numpy as np
import pytest

from stepth.ops import resize as r
from stepth.oracle import resize as r_np


@pytest.mark.parametrize("shape,out", [((40, 60), (20, 30)), ((20, 30), (40, 60)),
                                       ((33, 47), (33, 47)), ((17, 23), (5, 40))])
@pytest.mark.parametrize("filt", ["gaussian", "triangle", "catmullrom", "lanczos3"])
def test_resample_matches_oracle(rng, shape, out, filt):
    img = rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
    got = np.asarray(r.resample_exact(img, out[0], out[1], filt))
    exp = r_np.resample_exact_np(img, out[0], out[1], filt)
    np.testing.assert_array_equal(got, exp)


def test_resample_2d_gray(rng):
    img = rng.integers(0, 256, size=(24, 36), dtype=np.uint8)
    got = np.asarray(r.resample_exact(img, 12, 18))
    exp = r_np.resample_exact_np(img, 12, 18)
    np.testing.assert_array_equal(got, exp)


def test_same_size_gaussian_still_blurs(rng):
    # image-rs resize always resamples; same-size Gaussian output differs from
    # input on a sharp edge (docs/SEMANTICS.md §4)
    img = np.zeros((16, 16), dtype=np.uint8)
    img[:, 8:] = 255
    out = np.asarray(r.resample_exact(img, 16, 16, "gaussian"))
    assert not np.array_equal(out, img)
    assert 0 < out[0, 7] < 255  # edge got smoothed


def test_constant_image_is_preserved():
    img = np.full((20, 20), 77, dtype=np.uint8)
    out = np.asarray(r.resample_exact(img, 10, 10, "gaussian"))
    # weights sum to exactly 1<<15, so constants are exact
    np.testing.assert_array_equal(out, np.full((10, 10), 77, np.uint8))


def test_resize_dimensions_aspect():
    # downscale 600x400 into a 300x300 box -> 300x200
    assert r.resize_dimensions(600, 400, 300, 300) == (300, 200)
    # same-size stays same
    assert r.resize_dimensions(600, 400, 600, 400) == (600, 400)


def test_blur_matches_oracle(rng):
    img = rng.integers(0, 256, size=(20, 24, 4), dtype=np.uint8)
    got = np.asarray(r.blur_u8(img, 2.0))
    exp = r_np.blur_u8_np(img, 2.0)
    np.testing.assert_array_equal(got, exp)
