"""Full-resolution parity on the bundled reference assets: the device-side
JAX parity pipeline must equal the native C++ engine bit-for-bit on the real
600×400 pair (BASELINE.md config 1).

~2 minutes on the throttled CPU backend, so gated behind STEPTH_SLOW_TESTS=1;
run explicitly:

    STEPTH_SLOW_TESTS=1 python -m pytest tests/test_parity_fullres.py -q
"""

import os

import numpy as np
import pytest

from stepth import native

pytestmark = [
    pytest.mark.skipif(
        os.environ.get("STEPTH_SLOW_TESTS") != "1",
        reason="slow full-res parity; set STEPTH_SLOW_TESTS=1",
    ),
    pytest.mark.skipif(not native.available(), reason="native engine unavailable"),
]


def test_fullres_assets_parity(asset_pair):
    from stepth.match import parity

    main, add = asset_pair
    prec = (36, 36, 36)
    want = native.depth_from_additional(main, add, prec)
    got = np.asarray(parity.depth_from_additional(main, add, prec))
    np.testing.assert_array_equal(got, want)
