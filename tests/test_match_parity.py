"""Bit-parity: JAX device pipeline vs. the exact NumPy oracle
(SURVEY.md §4 golden/parity tests)."""

import numpy as np
import pytest

from stepth.match import parity
from stepth.oracle import pipeline as oracle_pipe
from stepth.oracle import ring as oracle_ring
from stepth.oracle import subdivision as oracle_sub


def _pair(rng, h=40, w=56, shift=3):
    """Synthetic quasi-rectified pair: smooth random field + horizontal shift."""
    base = rng.integers(0, 256, size=(h // 4, w // 4, 3)).astype(np.float32)
    up = np.kron(base, np.ones((4, 4, 1), np.float32))[:h, :w]
    main = up.astype(np.uint8)
    add = np.roll(main, shift, axis=1)
    return main, add


@pytest.mark.parametrize("min_s,max_s", [(4, 8), (2, 10), (6, 6)])
def test_subdivision_matches_oracle(rng, min_s, max_s):
    img = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    prec = np.array([30, 30, 30], np.int32)
    got = parity.subdivide(img, prec, min_splits=min_s, max_splits=max_s)
    exp = oracle_sub.subdivide(img, prec, min_splits=min_s, max_splits=max_s)
    np.testing.assert_array_equal(np.asarray(got.level), exp.level)
    np.testing.assert_array_equal(np.asarray(got.value), exp.value.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(got.seed_x), exp.seed_x)
    np.testing.assert_array_equal(np.asarray(got.seed_y), exp.seed_y)


def test_ring_rank_matches_scan_order():
    """The priority key must reproduce the oracle's literal scan order."""
    # enumerate order per the oracle's loops for a mid-image seed, no bounds
    r = 3
    visited = []
    x = y = 10
    for (main, sub, order) in [(y, x, True), (x, y, False)]:
        for i in [main + r, main - r]:
            for j in range(sub - r, sub + r + 1):
                py, px = (i, j) if order else (j, i)
                if (px - x, py - y) not in [(vx - x, vy - y) for vx, vy in visited]:
                    visited.append((px, py))
    ranks = [parity._ring_rank_np(py - y, px - x) for px, py in visited]
    assert ranks == sorted(ranks), "rank order must match scan order"


@pytest.mark.parametrize("phase_a", [2, 6, 30])
def test_match_distance_matches_oracle(rng, phase_a):
    main, add = _pair(rng)
    prec = (20, 20, 20)
    leaf = parity.subdivide(main, np.asarray(prec, np.int32), min_splits=4, max_splits=9)
    got = np.asarray(
        parity.match_distance(leaf, add, np.asarray(prec, np.int32),
                              max_radius=30, phase_a_radius=phase_a)
    )
    raw = oracle_pipe.raw_disparity_map(main, add, prec, min_splits=4, max_splits=9,
                                        max_radius=30)
    np.testing.assert_array_equal(got, raw)


def test_full_pipeline_bit_parity(rng):
    main, add = _pair(rng, 48, 64, shift=4)
    prec = (25, 25, 25)
    got = np.asarray(
        parity.depth_from_additional(main, add, np.asarray(prec, np.int32),
                                     min_splits=4, max_splits=10,
                                     max_radius=40, phase_a_radius=8)
    )
    exp = oracle_pipe.depth_from_additional_oracle(main, add, prec,
                                                   min_splits=4, max_splits=10,
                                                   max_radius=40)
    np.testing.assert_array_equal(got, exp)


def test_no_match_defined_zero(rng):
    main = np.zeros((16, 16, 3), np.uint8)
    add = np.full((16, 16, 3), 255, np.uint8)
    got = np.asarray(
        parity.depth_from_additional(main, add, np.asarray([1, 1, 1], np.int32),
                                     min_splits=2, max_splits=6, max_radius=20)
    )
    assert (got == 0).all()  # quirk Q3 guarded


def test_ring_search_distance_truncation(rng):
    """Q2: distances wrap mod 256 — force a far match."""
    add = np.zeros((40, 600, 3), np.uint8)
    add[:, :, :] = 200
    add[20, 560] = [7, 7, 7]  # the only matching pixel, far to the right
    d, pos = oracle_ring.ring_search([7, 7, 7], add, 10, 20, (5, 5, 5), 600)
    assert pos == (560, 20)
    assert d == 550  # oracle keeps u32; pipeline wraps to 550 % 256 = 38
