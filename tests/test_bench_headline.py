"""Pin bench.py's headline-selection logic (the driver-artifact contract).

The one JSON line's ``value`` is the best of the SAD-WTA
flagship and the ``hierarchical-sgm`` secondary row — the README default
backend. A bug here corrupts the
round's official number, so the selection is a pure function with tests;
no accelerator or JAX needed.
"""

import bench


def test_flagship_wins_when_hier_sgm_missing():
    partial = {}
    assert bench.select_headline(partial, 700.0) == 700.0
    assert partial["headline_backend"] == "hierarchical"
    assert partial["flagship_fps"] == 700.0


def test_hier_sgm_wins_when_faster():
    partial = {"hier_sgm": {"smooth_fps": 810.5, "edge_fps": 460.0}}
    assert bench.select_headline(partial, 700.0) == 810.5
    assert partial["headline_backend"] == "hierarchical-sgm"
    # the flagship stays recorded for round-over-round regression tracking
    assert partial["flagship_fps"] == 700.0


def test_flagship_wins_when_hier_sgm_slower():
    partial = {"hier_sgm": {"smooth_fps": 650.0}}
    assert bench.select_headline(partial, 700.0) == 700.0
    assert partial["headline_backend"] == "hierarchical"


def test_malformed_hier_sgm_row_falls_back():
    for row in (None, "oops", {"smooth_fps": "nan-ish"}, {}, 42):
        partial = {"hier_sgm": row}
        assert bench.select_headline(partial, 500.0) == 500.0, row
        assert partial["headline_backend"] == "hierarchical"


def test_existing_flagship_fps_not_clobbered():
    # the watchdog path may have recorded it already; selection must not
    # overwrite a value measured earlier in the run
    partial = {"flagship_fps": 699.99}
    bench.select_headline(partial, 700.0)
    assert partial["flagship_fps"] == 699.99
