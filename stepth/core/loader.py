"""Prefetching host→device data loader.

The reference's ingestion is native image-rs decode on the caller thread
(reference src/depth_image.rs:81, src/mask_image.rs:24); for a device pipeline
the equivalent concern is keeping the device fed: decode/IO on host threads while the
device computes. This loader wraps any indexable source (paths, arrays, a
video reader) with a thread pool + bounded queue and optional device placement,
so ``for batch in loader`` overlaps host IO with device steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional, Sequence

import jax
import numpy as np


class PrefetchLoader:
    """Iterate ``fn(items[i])`` with ``num_threads`` workers prefetching up to
    ``buffer`` results ahead, preserving order. ``device_put=True`` moves
    arrays to the default device inside the worker, overlapping H2D DMA."""

    def __init__(
        self,
        items: Sequence[Any],
        fn: Callable[[Any], Any],
        num_threads: int = 4,
        buffer: int = 8,
        device_put: bool = False,
    ) -> None:
        self.items = list(items)
        self.fn = fn
        self.num_threads = max(1, num_threads)
        self.buffer = max(1, buffer)
        self.device_put = device_put

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self) -> Iterator[Any]:
        n = len(self.items)
        if n == 0:
            return
        results: dict[int, Any] = {}
        cv = threading.Condition()
        state = {"next": 0, "consumed": 0}  # indices taken / yielded so far
        errors: list[BaseException] = []

        def worker():
            while True:
                with cv:
                    # Bound look-ahead at index *taking*, not insertion: indices
                    # are taken in order, so the producer of the next-needed
                    # item is always computing, never parked — a full buffer of
                    # future items can't starve the consumer (livelock
                    # otherwise: buffer full of i+1.. while i's producer waits).
                    while (
                        not errors
                        and state["next"] < n
                        and state["next"] - state["consumed"] >= self.buffer
                    ):
                        cv.wait(timeout=0.1)
                    if errors or state["next"] >= n:
                        return
                    i = state["next"]
                    state["next"] = i + 1
                try:
                    out = self.fn(self.items[i])
                    if self.device_put:
                        out = jax.device_put(out)
                except BaseException as e:  # propagate to consumer
                    with cv:
                        errors.append(e)
                        cv.notify_all()
                    return
                with cv:
                    results[i] = out
                    cv.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_threads)
        ]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with cv:
                    while i not in results and not errors:
                        cv.wait(timeout=0.1)
                    if errors:
                        raise errors[0]
                    out = results.pop(i)
                    state["consumed"] = i + 1
                    cv.notify_all()
                yield out
        finally:
            with cv:
                if not errors:
                    errors.append(GeneratorExit())  # unblock waiting workers
                cv.notify_all()
            for t in threads:
                t.join(timeout=1.0)


def image_pair_loader(
    pairs: Sequence[tuple],
    num_threads: int = 4,
    buffer: int = 4,
    device_put: bool = True,
) -> PrefetchLoader:
    """Loader over (left_path, right_path) tuples → dict of u8 RGB arrays."""
    from stepth.core import io

    def load(pair):
        lp, rp = pair
        return {"left": io.open_rgb(lp), "right": io.open_rgb(rp)}

    return PrefetchLoader(
        pairs, load, num_threads=num_threads, buffer=buffer, device_put=device_put
    )
