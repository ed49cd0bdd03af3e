"""Native C++ engine vs the NumPy oracle: bit-exact raw disparity and full
pipeline on random images and a reference-asset crop."""

import numpy as np
import pytest

from stepth import native
from stepth.oracle import pipeline as oracle

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native build failed: {native.build_error()}"
)


def _rand_pair(rng, h=40, w=56):
    main = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    add = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return main, add


def test_raw_disparity_matches_oracle(rng):
    main, add = _rand_pair(rng)
    prec = (36, 36, 36)
    want = oracle.raw_disparity_map(main, add, prec, min_splits=8)
    got = native.raw_disparity(main, add, prec, min_splits=8)
    np.testing.assert_array_equal(got, want)


def test_raw_disparity_smooth_blocks(rng):
    # piecewise-constant image → large homogeneous blocks, early leaf levels
    main = np.zeros((32, 48, 3), np.uint8)
    main[:16] = 200
    main[16:, :24] = 100
    add = np.roll(main, 5, axis=1)
    prec = (20, 20, 20)
    want = oracle.raw_disparity_map(main, add, prec, min_splits=4)
    got = native.raw_disparity(main, add, prec, min_splits=4)
    np.testing.assert_array_equal(got, want)


def test_full_pipeline_matches_oracle(rng):
    main, add = _rand_pair(rng, 36, 44)
    prec = (36, 36, 36)
    want = oracle.depth_from_additional_oracle(main, add, prec, min_splits=8)
    got = native.depth_from_additional(main, add, prec, min_splits=8)
    np.testing.assert_array_equal(got, want)


def test_asset_crop_matches_oracle(asset_pair):
    main, add = asset_pair
    main_c = main[::4, ::4][:64, :64]
    add_c = add[::4, ::4][:64, :64]
    prec = (36, 36, 36)
    want = oracle.raw_disparity_map(main_c, add_c, prec, min_splits=10)
    got = native.raw_disparity(main_c, add_c, prec, min_splits=10)
    np.testing.assert_array_equal(got, want)


def test_thread_counts_agree(rng):
    main, add = _rand_pair(rng)
    prec = (30, 30, 30)
    a = native.raw_disparity(main, add, prec, min_splits=8, n_threads=1)
    b = native.raw_disparity(main, add, prec, min_splits=8, n_threads=8)
    np.testing.assert_array_equal(a, b)


def test_hier_disparity_recovers_shift():
    """C++ hierarchical baseline (the bench.py CPU opponent): recovers a known
    constant shift on smooth texture and is thread-count invariant."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import make_pair

    left, right = make_pair(128, 256, shift=6, seed=3)
    d1 = native.hier_disparity(left, right, levels=3, coarsest_disparities=8,
                               refine_radius=4, window=9, n_threads=1)
    d8 = native.hier_disparity(left, right, levels=3, coarsest_disparities=8,
                               refine_radius=4, window=9, n_threads=8)
    np.testing.assert_array_equal(d1, d8)
    interior = d1[20:-20, 40:-40]
    assert abs(float(np.median(interior)) - 6.0) <= 1.0


def test_sgm_disparity_bit_equal_to_xla(rng):
    """C++ SGM == XLA SGM bit-for-bit on u8-valued gray inputs: every
    intermediate (SAD cost <= 255, box sums, min-normalized path costs,
    integer penalties) is an exact small integer in f32, so the two
    implementations' floats are identical despite different summation
    machinery. Covers 2/4/8 directions, LR validity, subpixel, fill, median."""
    from stepth.config import MatchConfig
    from stepth.match import sgm

    h, w, shift = 48, 96, 5
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    right = np.roll(left, -shift, axis=1).astype(np.float32)
    for dirs in (2, 4, 8):
        cfg = MatchConfig(num_disparities=16, window=5, lr_threshold=1.0)
        sc = sgm.SGMConfig(directions=dirs)
        ref = sgm.match_pair_sgm(left, right, cfg, sc)
        disp, valid = native.sgm_disparity(
            left, right, num_disparities=16, window=5, p1=sc.p1, p2=sc.p2,
            directions=dirs, lr_threshold=1.0,
        )
        np.testing.assert_array_equal(disp, np.asarray(ref.disparity))
        np.testing.assert_array_equal(valid, np.asarray(ref.valid))


def test_sgm_disparity_thread_invariant(rng):
    left = rng.integers(0, 256, (40, 64)).astype(np.float32)
    right = np.roll(left, -4, axis=1).astype(np.float32)
    a = native.sgm_disparity(left, right, num_disparities=8, n_threads=1)
    b = native.sgm_disparity(left, right, num_disparities=8, n_threads=8)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
