"""PrefetchLoader tests: order preservation, error propagation, bounded buffer."""

import time

import numpy as np
import pytest

from stepth.core.loader import PrefetchLoader, image_pair_loader


def test_order_preserved():
    items = list(range(50))
    out = list(PrefetchLoader(items, lambda x: x * 2, num_threads=4, buffer=4))
    assert out == [x * 2 for x in items]


def test_overlaps_slow_producer():
    def slow(x):
        time.sleep(0.02)
        return x

    items = list(range(16))
    t0 = time.perf_counter()
    out = list(PrefetchLoader(items, slow, num_threads=8, buffer=16))
    dt = time.perf_counter() - t0
    assert out == items
    assert dt < 0.02 * 16  # faster than serial

def test_error_propagates():
    def boom(x):
        if x == 3:
            raise ValueError("boom")
        return x

    with pytest.raises(ValueError, match="boom"):
        list(PrefetchLoader(list(range(8)), boom, num_threads=2, buffer=2))


def test_empty():
    assert list(PrefetchLoader([], lambda x: x)) == []


def test_image_pair_loader(tmp_path):
    from stepth.core import io

    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        img = rng.integers(0, 255, (8, 10, 3), dtype=np.uint8)
        p = str(tmp_path / f"im{i}.png")
        io.save(p, img)
        paths.append((p, p))
    batches = list(image_pair_loader(paths, num_threads=2, device_put=False))
    assert len(batches) == 3
    assert batches[0]["left"].shape == (8, 10, 3)
