"""The refine kernel (Pallas on the Triton route) against the jnp reference.

On the CPU the kernel runs in interpret mode; the compiled kernel is checked
on a GPU by the ``gpu``-marked test (and by chip_smoke.py at 1080p).
"""

import jax
import numpy as np
import pytest

from stepth.config import MatchConfig
from stepth.match import refine_triton

from tests.test_refine import _case_inputs, _golden, _run


def _kernel_cases():
    # cost × lr × shape × max_windows, a row-shard case, and the tile heights
    # (8, 24) that the kernel runs at 8 rows per program
    _, cases = _golden()
    pick = [i for i, c in enumerate(cases)
            if c["win"] == 9 and c["g_row0"] == 0 and c["tr"] in (8, 16, 24)]
    pick.append(next(i for i, c in enumerate(cases) if c["g_row0"] != 0 and c["lr"]))
    return pick


@pytest.mark.parametrize("ci", _kernel_cases())
def test_kernel_interpret_matches_reference(ci):
    """The Pallas kernel (interpret mode) reproduces the pinned contract
    outputs: the same disparity and, with ``lr``, the same right view, bit for
    bit (the reference is pinned to the same outputs in test_refine.py)."""
    data, cases = _golden()
    got = _run(data, cases[ci], impl="interpret")
    for a, key in zip(got, ("disp", "dispr")):
        np.testing.assert_array_equal(np.asarray(a), data[f"case{ci:02d}_{key}"])


@pytest.mark.parametrize("th,cap,want", [(64, 16, 16), (24, 16, 8), (16, 32, 16),
                                         (8, 16, 8), (40, 32, 8)])
def test_block_rows_divides_tile(th, cap, want):
    assert refine_triton.block_rows(th, cap) == want


@pytest.mark.gpu
@pytest.mark.parametrize("cost", ["sad", "ssd", "census"])
def test_compiled_kernel_matches_reference(cost):
    """The compiled kernel on a GPU, at the tolerance chip_smoke.py uses."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU form")
    from chip_smoke import compare

    data, cases = _golden()
    lg, rg, prior, _, _ = _case_inputs(data, cases[5])
    cfg = MatchConfig(window=9, cost=cost)
    for lr in (False, True):
        r = compare(lg, rg, prior, cfg, 2, 32, 16, lr, 16)
        assert r["ok"], r
