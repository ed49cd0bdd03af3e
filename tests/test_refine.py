"""The refine level: the jnp reference against the pinned contract, the window
planner, the right-view merge, and the implementation choice.

``tests/data/refine_golden.npz`` pins the tile contract: it holds outputs of
the original refine kernel (the one this contract was defined by), run in
interpret mode on the inputs stored beside them, for every cost, with and
without the right view, on aligned and ragged shapes, with one and many
windows, for row shards, and for tile heights of 8 and 24 rows. The reference must reproduce them bit for bit.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stepth.config import MatchConfig
from stepth.match import pyramid

from tests.test_match_dense import make_pair

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "refine_golden.npz")


def _golden():
    data = np.load(GOLDEN)
    cases = [ast.literal_eval(str(c)) for c in data["cases"]]
    return data, cases


def _case_inputs(data, case):
    if case["shape"] == "aligned":
        sl = (slice(0, 64), slice(0, 256))
    else:
        sl = (slice(5, 55), slice(17, 217))
    lg = jnp.asarray(data["left"][sl], jnp.float32)
    rg = jnp.asarray(data["right"][sl], jnp.float32)
    prior = jnp.asarray(data["prior"][sl])
    cfg = MatchConfig(window=case["win"], cost=case["cost"],
                      census_window=case["cw"])
    kw = dict(tile_rows=case["tr"], g_row0=case["g_row0"], g_h=case["g_h"],
              lr=case["lr"], max_windows=case["mw"])
    return lg, rg, prior, cfg, kw


def _run(data, case, **extra):
    lg, rg, prior, cfg, kw = _case_inputs(data, case)
    out = pyramid.refine_level(lg, rg, prior, cfg, 2, 32, **kw, **extra)
    return (out if case["lr"] else (out,))


_N_GOLDEN = 30


@pytest.mark.parametrize("ci", range(_N_GOLDEN))
def test_reference_matches_golden(ci):
    data, cases = _golden()
    assert len(cases) == _N_GOLDEN
    case = cases[ci]
    out = _run(data, case)
    np.testing.assert_array_equal(np.asarray(out[0]), data[f"case{ci:02d}_disp"])
    if case["lr"]:
        np.testing.assert_array_equal(
            np.asarray(out[1]), data[f"case{ci:02d}_dispr"]
        )


def test_impl_choice(monkeypatch):
    """jnp on the CPU, the compiled kernel on a GPU, no implementation for
    any other platform, and interpret mode only when a caller names it."""
    assert pyramid.refine_impl() == "reference"
    calls = []

    def fake_tiles(*args, interpret, **kw):
        calls.append(interpret)
        raise RuntimeError("stop")

    from stepth.match import refine_triton

    monkeypatch.setattr(refine_triton, "refine_tiles", fake_tiles)
    lg = jnp.zeros((16, 128))
    pyramid.refine_level(lg, lg, lg, MatchConfig(), 2, 16)  # reference: no kernel
    with pytest.raises(RuntimeError, match="stop"):
        pyramid.refine_level(lg, lg, lg, MatchConfig(), 2, 16, impl="interpret")
    assert calls == [True]
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pyramid.refine_impl() == "triton"
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(NotImplementedError):
        pyramid.refine_impl()


def test_unsupported_cost_and_window():
    lg = jnp.zeros((16, 128))
    with pytest.raises(NotImplementedError):
        pyramid.refine_level(lg, lg, lg, MatchConfig(cost="ncc"), 2, 16)
    with pytest.raises(ValueError):
        pyramid.refine_level(lg, lg, lg, MatchConfig(window=121), 2, 16)


def test_refine_level_improves_noisy_prior(rng):
    shift = 6
    left, right = make_pair(rng, h=64, w=256, shift=shift)
    prior = jnp.full(left.shape, float(shift)) + jnp.asarray(
        rng.normal(0, 1.0, left.shape).astype(np.float32)
    )
    out = pyramid.refine_level(
        jnp.asarray(left), jnp.asarray(right), prior, MatchConfig(window=9),
        radius=4, max_base=16,
    )
    err = np.abs(np.asarray(out)[8:-8, 16:-16] - shift)
    assert np.median(err) <= 0.5


@pytest.mark.parametrize("cost", ["sad", "census"])
def test_refine_level_locks_onto_clean_shift(rng, cost):
    shift = 6
    left, right = make_pair(rng, h=64, w=256, shift=shift)
    out = pyramid.refine_level(
        jnp.asarray(left), jnp.asarray(right), jnp.full(left.shape, float(shift)),
        MatchConfig(window=9, cost=cost, census_window=5), radius=4, max_base=16,
    )
    err = np.abs(np.asarray(out)[8:-8, 16:-16] - shift)
    assert np.median(err) <= 0.5


def test_refine_level_right_disparity(rng):
    """On a clean constant shift the right view matches the shift wherever
    covered, and the left disparity is the same with and without it."""
    shift = 6
    left, right = make_pair(rng, h=64, w=256, shift=shift)
    lg, rg = jnp.asarray(left), jnp.asarray(right)
    prior = jnp.full(lg.shape, float(shift))
    cfg = MatchConfig(window=9)
    d_plain = pyramid.refine_level(lg, rg, prior, cfg, radius=4, max_base=16)
    d_lr, d_r = pyramid.refine_level(lg, rg, prior, cfg, radius=4, max_base=16,
                                     lr=True)
    np.testing.assert_array_equal(np.asarray(d_plain), np.asarray(d_lr))
    err = np.abs(np.asarray(d_r)[8:-8, 16:-16] - shift)
    assert np.median(err) <= 0.5
    assert (err <= 1.0).mean() > 0.9


def test_window_plan_never_exceeds_cover_bound(rng):
    """The greedy ±R cover needs at most ceil((max_base+1)/(2R+1)) windows:
    consecutive greedy centers are > 2R apart in target space. Pinned on
    adversarial priors, and the clamped plan equals the unclamped one on its
    live slots."""
    for max_base, radius in ((16, 2), (64, 2), (32, 4), (128, 2)):
        bound = -(-(max_base + 1) // (2 * radius + 1))
        for _ in range(3):
            prior = jnp.asarray(
                rng.uniform(-5, max_base + 5, (32, 256)).astype(np.float32)
            )
            bases, nw = pyramid.tile_windows_from_prior(
                prior, 16, max_base, radius, max_windows=64
            )
            assert int(jnp.max(nw)) <= bound, (max_base, radius, int(jnp.max(nw)))
            bases_c, nw_c = pyramid.tile_windows_from_prior(
                prior, 16, max_base, radius, max_windows=16
            )
            k = min(bases_c.shape[-1], bases.shape[-1])
            np.testing.assert_array_equal(np.asarray(nw), np.asarray(nw_c))
            np.testing.assert_array_equal(
                np.asarray(bases)[..., :k] * (np.arange(k) < np.asarray(nw)[..., None]),
                np.asarray(bases_c)[..., :k] * (np.arange(k) < np.asarray(nw_c)[..., None]),
            )


def test_window_plan_smooth_and_step_tiles():
    """A constant prior plans one window at the clamped tile mean; a tile
    with two surfaces gets one window per surface."""
    prior = jnp.full((32, 256), 300.0)
    bases, nw = pyramid.tile_windows_from_prior(prior, 32, 64, 2, 1)
    assert bases.shape == (1, 2, 2)
    assert (np.asarray(bases[..., 0]) == 64).all() and (np.asarray(nw) == 1).all()
    step = jnp.concatenate([jnp.full((32, 64), 5.0), jnp.full((32, 64), 40.0)], 1)
    bases, nw = pyramid.tile_windows_from_prior(step, 32, 64, 2, 16)
    assert int(nw[0, 0]) == 2
    assert sorted(np.asarray(bases[0, 0, :2]).tolist()) == [5, 40]


def test_merge_right_view_tie_break():
    """Equal right-view costs from two tiles: the first column tile wins."""
    geo = pyramid.refine_geometry(8, 256, MatchConfig(window=3), 1, 8, 8)
    K, nr, nc = 2, 1, 2
    val = jnp.full((K, nr, nc, 8, 256), 1e30, jnp.float32)
    s = jnp.zeros_like(val)
    bases = jnp.zeros((nr, nc, K), jnp.int32)
    nw = jnp.ones((nr, nc), jnp.int32)
    # u = jc*128 - m + q - base - R: column u=100 from tile 0 (q=109) and
    # tile 1 (q=-19 -> out of region), so use u=130: tile0 q=139, tile1 q=11
    val = val.at[0, 0, 0, :, 139].set(5.0).at[0, 0, 1, :, 11].set(5.0)
    s = s.at[0, 0, 0, :, 139].set(3.0).at[0, 0, 1, :, 11].set(7.0)
    out = np.asarray(pyramid.merge_right_view(val, s, bases, nw, geo))
    assert (out[:, 130] == 3.0).all()
    val = val.at[0, 0, 1, :, 11].set(4.0)
    out = np.asarray(pyramid.merge_right_view(val, s, bases, nw, geo))
    assert (out[:, 130] == 7.0).all()
    assert (out[:, 0] == -1e6).all()
