"""SGM aggregation: exactness vs a loop-level NumPy oracle, and the accuracy
claim itself — semi-global regularization must beat plain WTA on noisy
low-texture pairs (the failure mode of the reference's purely local ring
search, reference src/helpers.rs:9-54)."""

import jax.numpy as jnp
import numpy as np
import pytest

from stepth.config import MatchConfig
from stepth.match import dense, sgm


def sgm_oracle(vol: np.ndarray, directions: int, p1: float, p2: float) -> np.ndarray:
    """Direct per-pixel recurrence, scan order explicit. f32 like the device."""
    h, w, d = vol.shape
    vol = vol.astype(np.float32)
    dirs = {
        2: [(0, 1), (0, -1)],
        4: [(0, 1), (0, -1), (1, 0), (-1, 0)],
        8: [
            (0, 1), (0, -1), (1, 0), (-1, 0),
            (1, 1), (1, -1), (-1, 1), (-1, -1),
        ],
    }[directions]
    p1 = np.float32(p1)
    p2 = np.float32(p2)
    total = np.zeros_like(vol)
    for dy, dx in dirs:
        L = np.zeros_like(vol)
        ys = range(h) if dy >= 0 else range(h - 1, -1, -1)
        xs = range(w) if dx >= 0 else range(w - 1, -1, -1)
        for y in ys:
            for x in xs:
                py, px = y - dy, x - dx
                if 0 <= py < h and 0 <= px < w:
                    prev = L[py, px]
                    min_l = prev.min()
                    for k in range(d):
                        cand = min(prev[k], min_l + p2)
                        if k > 0:
                            cand = min(cand, prev[k - 1] + p1)
                        if k < d - 1:
                            cand = min(cand, prev[k + 1] + p1)
                        L[y, x, k] = (vol[y, x, k] + cand) - min_l
                else:
                    L[y, x] = vol[y, x]
        total += L
    return total


@pytest.mark.parametrize("directions", [2, 4, 8])
def test_aggregate_matches_oracle(directions):
    rng = np.random.default_rng(3 + directions)
    vol = rng.uniform(0.0, 50.0, (7, 9, 8)).astype(np.float32)
    want = sgm_oracle(vol, directions, p1=1.5, p2=5.0)
    got = np.asarray(
        sgm.aggregate(jnp.asarray(vol), sgm.SGMConfig(directions=directions), 1.5, 5.0)
    )
    np.testing.assert_allclose(got, want, atol=1e-3)


def _noisy_pair(rng, h=72, w=128, shift=6, texture=6.0, noise=8.0):
    """Weak smooth texture + sensor noise on the right view: locally ambiguous,
    globally unambiguous — WTA's worst case, SGM's home turf."""
    base = rng.uniform(0.0, 1.0, (h // 8, w // 8 + 2))
    up = np.kron(base, np.ones((8, 8)))[:h, : w + 8]
    # light blur so the texture has gradients rather than hard block edges
    k = np.array([1.0, 2.0, 3.0, 2.0, 1.0])
    k = k / k.sum()
    up = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, up)
    up = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, up)
    left = 120.0 + texture * 10.0 * up[:, :w]
    right = 120.0 + texture * 10.0 * up[:, shift : w + shift]
    right = right + rng.normal(0.0, noise, right.shape)
    return left.astype(np.float32), right.astype(np.float32)


def _epe(disp, shift, margin=12):
    inner = np.asarray(disp)[margin:-margin, margin:-margin]
    return float(np.mean(np.abs(inner - shift)))


def test_sgm_beats_wta_on_noisy_low_texture():
    rng = np.random.default_rng(0)
    left, right = _noisy_pair(rng)
    cfg = MatchConfig(num_disparities=16, window=3, cost="sad")
    epe_wta = _epe(dense.match_pair(left, right, cfg).disparity, 6)
    epe_sgm = _epe(sgm.match_pair_sgm(left, right, cfg).disparity, 6)
    assert epe_sgm < epe_wta * 0.5, (epe_sgm, epe_wta)
    assert epe_sgm < 0.75, epe_sgm


def test_sgm_eight_directions_not_worse():
    rng = np.random.default_rng(1)
    left, right = _noisy_pair(rng)
    cfg = MatchConfig(num_disparities=16, window=3, cost="sad")
    e4 = _epe(sgm.match_pair_sgm(left, right, cfg, sgm.SGMConfig(directions=4)).disparity, 6)
    e8 = _epe(sgm.match_pair_sgm(left, right, cfg, sgm.SGMConfig(directions=8)).disparity, 6)
    assert e8 <= e4 * 1.2, (e8, e4)
    assert e8 < 0.75, e8


def test_sgm_census_cost_runs():
    rng = np.random.default_rng(2)
    left, right = _noisy_pair(rng, noise=4.0)
    cfg = MatchConfig(num_disparities=16, window=3, cost="census", census_window=5)
    res = sgm.match_pair_sgm(
        left, right, cfg, sgm.SGMConfig(p1=2.0, p2=8.0, directions=4)
    )
    assert res.disparity.shape == left.shape
    assert _epe(res.disparity, 6) < 1.5


def test_sgm_zero_penalties_degenerate_to_wta():
    # With P1 = P2 = 0 the recurrence adds min(prev) − min(prev) = 0 along
    # every path... not exactly: cand = min(prev[d], min±P1, min+P2) = min(prev)
    # so L = C exactly, and SGM collapses to the unaggregated WTA.
    rng = np.random.default_rng(4)
    left, right = _noisy_pair(rng, noise=0.0)
    cfg = MatchConfig(
        num_disparities=16, window=5, cost="sad", lr_threshold=None, subpixel=False
    )
    res_sgm = sgm.match_pair_sgm(left, right, cfg, sgm.SGMConfig(p1=0.0, p2=0.0))
    res_wta = dense.match_pair(left, right, cfg)
    # identical winners modulo the 4x direction-count scaling of the cost
    np.testing.assert_array_equal(
        np.asarray(res_sgm.disparity), np.asarray(res_wta.disparity)
    )


def test_model_backend_sgm():
    from stepth.models.stereo import StereoModel

    rng = np.random.default_rng(5)
    left, right = _noisy_pair(rng)
    model = StereoModel(backend="sgm", match=MatchConfig(num_disparities=16, window=3))
    res = model(left, right)
    assert _epe(res.disparity, 6) < 0.75
    d8 = model.depth_u8(left, right)
    assert d8.dtype == jnp.uint8


@pytest.mark.parametrize("directions", [2, 4, 8])
@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("lr_threshold", [1.0, None])
def test_xla_sgm_equals_native(rng, directions, window, lr_threshold):
    """The XLA SGM backend equals the native C++ SGM bit for bit on u8-valued
    gray inputs (every intermediate is an exact small integer in f32). The
    native engine implements the SAD cost, so that is the cost compared."""
    from stepth import native

    if not native.available():
        pytest.skip("native engine needs a C++ toolchain")
    h, w, shift = 40, 80, 4
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    right = np.roll(left, -shift, axis=1).astype(np.float32)
    cfg = MatchConfig(num_disparities=12, window=window, lr_threshold=lr_threshold)
    sc = sgm.SGMConfig(directions=directions)
    ref = sgm.match_pair_sgm(left, right, cfg, sc)
    disp, valid = native.sgm_disparity(
        left, right, num_disparities=12, window=window, p1=sc.p1, p2=sc.p2,
        directions=directions, lr_threshold=lr_threshold,
    )
    np.testing.assert_array_equal(disp, np.asarray(ref.disparity))
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
