"""depth_split: JAX vs. independent NumPy oracle (reference
src/depth_image.rs:162-218; docs/SEMANTICS.md §7)."""

import numpy as np
import pytest

from stepth.oracle.kmeans import depth_split_oracle
from stepth.ops import kmeans


@pytest.mark.parametrize("zones", [2, 3, 4, 5])
def test_matches_oracle_random(rng, zones):
    d = rng.integers(0, 256, size=(40, 50), dtype=np.uint8)
    assert kmeans.depth_split(d, zones) == depth_split_oracle(d, zones)


def test_bimodal_two_zones(rng):
    d = np.concatenate([
        rng.integers(10, 40, size=500), rng.integers(200, 240, size=500)
    ]).astype(np.uint8).reshape(20, 50)
    got = kmeans.depth_split(d, 2)
    assert got == depth_split_oracle(d, 2)
    assert len(got) == 2
    (lo0, hi0), (lo1, hi1) = got
    assert lo0 >= 10 and hi0 < 100 and lo1 >= 150 and hi1 <= 240


def test_zones_below_two():
    d = np.zeros((4, 4), dtype=np.uint8)
    assert kmeans.depth_split(d, 1) == [(None, None)]  # reference :163-164
    assert kmeans.depth_split(d, 0) == [(None, None)]


def test_constant_plane_defined_behavior():
    # quirk Q5: reference panics; we define the degenerate single cluster
    d = np.full((8, 8), 42, dtype=np.uint8)
    assert kmeans.depth_split(d, 2) == [(42, 42)]
    assert depth_split_oracle(d, 2) == [(42, 42)]


def test_narrow_range_step_guard(rng):
    # max-min < zones-1 would be step<=0 in the reference (panic); guarded here
    d = rng.integers(100, 103, size=(10, 10)).astype(np.uint8)
    got = kmeans.depth_split(d, 5)
    assert got == depth_split_oracle(d, 5)


@pytest.mark.parametrize("zones", [2, 3])
def test_tiny_images(zones):
    d = np.array([[0, 255]], dtype=np.uint8)
    assert kmeans.depth_split(d, zones) == depth_split_oracle(d, zones)
