"""Sharded SGM on the virtual 8-device CPU mesh: the exact mode (ppermute
carry relay for vertical/diagonal scans) must equal the unsharded backend
to within compile-level ulp noise (the dense sharded paths' 1e-5 standard —
XLA reassociates differently at different shard shapes); the warm-up mode must
agree except at a small interior-seam fraction."""

import numpy as np
import pytest

from stepth.config import MatchConfig
from stepth.match import sgm
from stepth.parallel import mesh as mesh_mod
from stepth.parallel import sgm_sharded

from tests.test_match_dense import make_pair


@pytest.mark.parametrize("directions", [2, 4, 8])
def test_exact_equals_unsharded(rng, directions):
    left, right = make_pair(rng, h=64, w=96, shift=5)
    cfg = MatchConfig(num_disparities=16, window=5, lr_threshold=1.0)
    sc = sgm.SGMConfig(directions=directions)
    m = mesh_mod.make_mesh(data=1, tile=4)
    ref = sgm.match_pair_sgm(left, right, cfg, sc)
    got = sgm_sharded.match_pair_sgm_sharded(left, right, cfg, sc, m)
    np.testing.assert_array_equal(np.asarray(ref.valid), np.asarray(got.valid))
    np.testing.assert_allclose(
        np.asarray(ref.disparity), np.asarray(got.disparity), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(ref.cost), np.asarray(got.cost), rtol=1e-5
    )


def test_exact_eight_shards_census_uniqueness(rng):
    left, right = make_pair(rng, h=128, w=64, shift=3)
    cfg = MatchConfig(
        num_disparities=8, window=5, cost="census", uniqueness=0.05,
        lr_threshold=1.0,
    )
    sc = sgm.SGMConfig(p1=2.0, p2=8.0, directions=4)
    m = mesh_mod.make_mesh(data=1, tile=8)
    ref = sgm.match_pair_sgm(left, right, cfg, sc)
    got = sgm_sharded.match_pair_sgm_sharded(left, right, cfg, sc, m)
    np.testing.assert_array_equal(np.asarray(ref.valid), np.asarray(got.valid))
    np.testing.assert_allclose(
        np.asarray(ref.disparity), np.asarray(got.disparity), atol=1e-5
    )


def test_warmup_mode_close(rng):
    left, right = make_pair(rng, h=128, w=96, shift=5)
    cfg = MatchConfig(num_disparities=16, window=5, lr_threshold=1.0)
    sc = sgm.SGMConfig(directions=4)
    m = mesh_mod.make_mesh(data=1, tile=4)
    ref = sgm.match_pair_sgm(left, right, cfg, sc)
    got = sgm_sharded.match_pair_sgm_sharded(
        left, right, cfg, sc, m, exact=False, warmup=16
    )
    d_ref = np.asarray(ref.disparity)
    d_got = np.asarray(got.disparity)
    agree = np.mean(np.abs(d_ref - d_got) <= 1.0)
    assert agree > 0.97, f"warm-up agreement {agree:.4f}"


def test_warmup_horizontal_only_is_exact(rng):
    # 2-direction SGM is row-local, so even the warm-up mode is bit-exact
    left, right = make_pair(rng, h=64, w=96, shift=5)
    cfg = MatchConfig(num_disparities=16, window=5, lr_threshold=1.0)
    sc = sgm.SGMConfig(directions=2)
    m = mesh_mod.make_mesh(data=1, tile=4)
    ref = sgm.match_pair_sgm(left, right, cfg, sc)
    got = sgm_sharded.match_pair_sgm_sharded(
        left, right, cfg, sc, m, exact=False, warmup=8
    )
    np.testing.assert_allclose(
        np.asarray(ref.disparity), np.asarray(got.disparity), atol=1e-5
    )


def test_model_sharded_sgm_wiring(rng):
    # StereoModel(backend="sgm").sharded(mesh) routes to the exact sharded twin
    from stepth.models.stereo import StereoModel

    left, right = make_pair(rng, h=64, w=64, shift=4)
    cfg = MatchConfig(num_disparities=8, window=5)
    model = StereoModel(backend="sgm", match=cfg, sgm=sgm.SGMConfig(directions=4))
    m = mesh_mod.make_mesh(data=1, tile=4)
    ref = model(left, right)
    got = model.sharded(m)(left, right)
    np.testing.assert_allclose(
        np.asarray(ref.disparity), np.asarray(got.disparity), atol=1e-5
    )


def test_warmup_single_shard_is_exact(rng):
    left, right = make_pair(rng, h=64, w=64, shift=4)
    cfg = MatchConfig(num_disparities=8, window=5)
    sc = sgm.SGMConfig(directions=8)
    m = mesh_mod.make_mesh(data=1, tile=1)
    ref = sgm.match_pair_sgm(left, right, cfg, sc)
    got = sgm_sharded.match_pair_sgm_sharded(
        left, right, cfg, sc, m, exact=False, warmup=8
    )
    np.testing.assert_allclose(
        np.asarray(ref.disparity), np.asarray(got.disparity), atol=1e-5
    )
