"""Bundle-adjustment tests: synthetic multi-view problems with known ground
truth; single-device LM-Schur-CG convergence and sharded == unsharded."""

import numpy as np
import jax.numpy as jnp
import pytest

from stepth.fusion import ba, geometry as geo
from stepth.parallel import mesh as mesh_mod


def make_problem(rng, n_cams=4, n_pts=60, noise=0.0, perturb=0.05):
    """Cameras on an arc looking at a point cloud near the origin."""
    intr = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    pts_gt = rng.uniform(-1.0, 1.0, (n_pts, 3)).astype(np.float32)
    pts_gt[:, 2] += 6.0  # in front of the rig

    poses_gt = []
    for c in range(n_cams):
        angle = 0.08 * (c - n_cams / 2)
        w = np.array([0.0, angle, 0.0], np.float32)
        t = np.array([0.4 * c, 0.0, 0.0], np.float32)
        poses_gt.append(np.concatenate([w, t]))
    poses_gt = np.stack(poses_gt).astype(np.float32)

    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.asarray(
        geo.project(
            geo.transform(jnp.asarray(poses_gt)[cam_idx], jnp.asarray(pts_gt)[pt_idx]),
            jnp.asarray(intr),
        )
    )
    uv = uv + rng.normal(0, noise, uv.shape).astype(np.float32)

    poses0 = poses_gt + rng.normal(0, perturb, poses_gt.shape).astype(np.float32)
    poses0[0] = poses_gt[0]  # gauge anchor stays exact
    pts0 = pts_gt + rng.normal(0, perturb * 4, pts_gt.shape).astype(np.float32)

    problem = ba.BAProblem(
        poses=jnp.asarray(poses0),
        points=jnp.asarray(pts0),
        intrinsics=jnp.asarray(intr),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        uv=jnp.asarray(uv),
        weight=jnp.ones(len(cam_idx), jnp.float32),
    )
    return problem, poses_gt, pts_gt


def test_residuals_zero_at_ground_truth(rng):
    problem, poses_gt, pts_gt = make_problem(rng, perturb=0.0)
    r = np.asarray(ba.residuals(problem, jnp.asarray(poses_gt), jnp.asarray(pts_gt)))
    np.testing.assert_allclose(r, 0.0, atol=1e-2)


def test_solve_reduces_cost(rng):
    problem, _, _ = make_problem(rng, perturb=0.05)
    c0 = float(ba._cost(problem, problem.poses, problem.points))
    state = ba.solve(problem, iters=8, cg_iters=12)
    assert float(state.cost) < c0 * 1e-2


def test_solve_recovers_ground_truth(rng):
    problem, poses_gt, pts_gt = make_problem(rng, perturb=0.03)
    state = ba.solve(problem, iters=12, cg_iters=15)
    # reprojection cost ≈ 0 (noiseless observations). The exact-f32 product
    # pipeline (no bf16 einsum lowering) reaches ~2e-10 on every seed; 1e-8
    # guards against accuracy regressions 50× above the floor.
    assert float(state.cost) < 1e-8


def test_masked_padding_slots_ignored(rng):
    problem, _, _ = make_problem(rng, n_cams=3, n_pts=40, perturb=0.02)
    # append garbage observations with weight 0
    n_pad = 64
    pad_uv = jnp.asarray(rng.uniform(0, 640, (n_pad, 2)), jnp.float32)
    padded = problem._replace(
        cam_idx=jnp.concatenate([problem.cam_idx, jnp.zeros(n_pad, jnp.int32)]),
        pt_idx=jnp.concatenate([problem.pt_idx, jnp.zeros(n_pad, jnp.int32)]),
        uv=jnp.concatenate([problem.uv, pad_uv]),
        weight=jnp.concatenate([problem.weight, jnp.zeros(n_pad, jnp.float32)]),
    )
    s1 = ba.solve(problem, iters=5, cg_iters=10)
    s2 = ba.solve(padded, iters=5, cg_iters=10)
    np.testing.assert_allclose(np.asarray(s1.poses), np.asarray(s2.poses), atol=1e-4)
    np.testing.assert_allclose(float(s1.cost), float(s2.cost), atol=1e-6)


def test_sharded_matches_single_device(rng):
    problem, _, _ = make_problem(rng, n_cams=4, n_pts=64, perturb=0.03)  # N=256
    m = mesh_mod.make_mesh(data=8, tile=1)
    s1 = ba.solve(problem, iters=4, cg_iters=8)
    s2 = ba.solve_sharded(problem, m, iters=4, cg_iters=8)
    # f32 psum reduction order differs from the single-device segment-sum, and
    # LM iterations amplify the last-bit differences — compare loosely and on
    # the cost, which is the contract.
    np.testing.assert_allclose(np.asarray(s1.poses), np.asarray(s2.poses), atol=5e-3)
    np.testing.assert_allclose(np.asarray(s1.points), np.asarray(s2.points), atol=5e-3)
    np.testing.assert_allclose(float(s1.cost), float(s2.cost), rtol=0.3, atol=1e-4)


def test_sharded_obs_count_validation(rng):
    problem, _, _ = make_problem(rng, n_cams=3, n_pts=21, perturb=0.02)  # N=63
    m = mesh_mod.make_mesh(data=8, tile=1)
    with pytest.raises(ValueError):
        ba.solve_sharded(problem, m, iters=2, cg_iters=4)


def test_ba_checkpoint_resume(rng, tmp_path):
    """Failure-recovery contract: checkpoint mid-optimization, restore, and
    continue — final cost matches an uninterrupted run of the same length."""
    from stepth.utils import checkpoint

    problem, _, _ = make_problem(rng, n_cams=3, n_pts=30, perturb=0.03)
    full = ba.solve(problem, iters=8, cg_iters=8)

    half = ba.solve(problem, iters=4, cg_iters=8)
    path = str(tmp_path / "ba_state.npz")
    checkpoint.save(path, half, metadata={"iters_done": 4})
    restored = checkpoint.restore(path, like=half)
    assert checkpoint.metadata(path)["iters_done"] == 4
    resumed_problem = problem._replace(
        poses=jnp.asarray(restored.poses), points=jnp.asarray(restored.points)
    )
    resumed = ba.solve(
        resumed_problem, iters=4, cg_iters=8,
        lm_lambda0=float(np.asarray(restored.lm_lambda)),
    )
    assert float(resumed.cost) <= float(full.cost) * 5 + 1e-6


# --- numeric-kernel units: the MXU segsum and closed-form inverses ----------


def test_segsum_matches_scatter(rng):
    import jax

    x = jnp.asarray(rng.normal(size=(4096, 6, 6)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, 37, 4096).astype(np.int32))
    want = jax.ops.segment_sum(x, idx, num_segments=37)
    got = ba._segsum(x, idx, 37)
    scale = float(jnp.max(jnp.abs(want)))
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), atol=2e-6 * scale
    )


def test_segsum_empty_segments_are_zero(rng):
    x = jnp.ones((8, 3), jnp.float32)
    idx = jnp.asarray([0, 0, 2, 2, 2, 5, 5, 5], jnp.int32)
    out = np.asarray(ba._segsum(x, idx, 7))
    np.testing.assert_array_equal(out[[1, 3, 4, 6]], 0.0)
    np.testing.assert_array_equal(out[0], 2.0)
    np.testing.assert_array_equal(out[2], 3.0)


def test_inv3_matches_numpy(rng):
    m = rng.normal(size=(64, 3, 3)).astype(np.float32)
    spd = np.einsum("pij,pkj->pik", m, m) + 0.1 * np.eye(3, dtype=np.float32)
    got = np.asarray(ba._inv3(jnp.asarray(spd)))
    want = np.linalg.inv(spd.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)


def test_inv_spd_matches_numpy(rng):
    m = rng.normal(size=(16, 6, 6)).astype(np.float32)
    spd = np.einsum("pij,pkj->pik", m, m) + 0.5 * np.eye(6, dtype=np.float32)
    got = np.asarray(ba._inv_spd(jnp.asarray(spd)))
    want = np.linalg.inv(spd.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-4)


def test_segsum_large_segment_branch(rng):
    """The >8192-segment branch (flattened scatter) agrees with the one-hot
    branch bit-for... well, to f32 summation-order tolerance."""
    import jax

    x = jnp.asarray(rng.normal(size=(2048, 3, 3)).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, 9000, 2048).astype(np.int32))
    got = ba._segsum(x, idx, 9000)  # scatter branch
    want = jax.ops.segment_sum(x, idx, num_segments=9000)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
    assert got.shape == (9000, 3, 3)


def test_robust_losses_reject_outliers(rng):
    """5% gross outlier observations (sign-symmetric, 80–160 px): the l2
    solve is dragged off (inliers reproject at several px); huber IRLS pulls
    the solution back to the inliers; redescending cauchy suppresses the
    outliers' influence almost entirely. Measured on inlier reprojection
    error — point coordinates aren't gauge-fixed (scale is free with one
    anchored camera), so they're not a valid accuracy metric."""
    problem, _, _ = make_problem(rng, n_cams=4, n_pts=64, perturb=0.03)
    uv = np.asarray(problem.uv).copy()
    n = uv.shape[0]
    bad = rng.choice(n, size=n // 20, replace=False)
    mag = rng.uniform(80.0, 160.0, (len(bad), 2)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], (len(bad), 2)).astype(np.float32)
    uv[bad] += mag * sign
    corrupted = problem._replace(uv=jnp.asarray(uv))
    keep = np.ones(n, bool)
    keep[bad] = False

    def inlier_err(state):
        r = np.asarray(ba.residuals(corrupted, state.poses, state.points))
        return float(np.abs(r[keep]).mean())

    e_l2 = inlier_err(ba.solve(corrupted, iters=12, cg_iters=10))
    e_hub = inlier_err(
        ba.solve(corrupted, iters=12, cg_iters=10, loss="huber", loss_delta=4.0)
    )
    e_cau = inlier_err(
        ba.solve(corrupted, iters=12, cg_iters=10, loss="cauchy", loss_delta=4.0)
    )
    assert e_hub < e_l2 * 0.2, (e_hub, e_l2)
    assert e_hub < 1.5, e_hub
    assert e_cau < 0.05, e_cau


def test_robust_loss_l2_unchanged(rng):
    """loss="l2" is the same objective as the historical default, bitwise."""
    problem, _, _ = make_problem(rng, n_cams=3, n_pts=32, perturb=0.03)
    a = ba.solve(problem, iters=4, cg_iters=8)
    b = ba.solve(problem, iters=4, cg_iters=8, loss="l2")
    np.testing.assert_array_equal(np.asarray(a.poses), np.asarray(b.poses))
    np.testing.assert_array_equal(np.asarray(a.points), np.asarray(b.points))


def test_sharded_huber_matches_single_device(rng):
    problem, _, _ = make_problem(rng, n_cams=4, n_pts=64, perturb=0.03)  # N=256
    uv = np.asarray(problem.uv).copy()
    bad = rng.choice(uv.shape[0], size=8, replace=False)
    uv[bad] += 100.0
    problem = problem._replace(uv=jnp.asarray(uv))
    m = mesh_mod.make_mesh(data=8, tile=1)
    s1 = ba.solve(problem, iters=4, cg_iters=8, loss="huber", loss_delta=4.0)
    s2 = ba.solve_sharded(problem, m, iters=4, cg_iters=8, loss="huber", loss_delta=4.0)
    np.testing.assert_allclose(
        np.asarray(s1.poses), np.asarray(s2.poses), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(s1.points), np.asarray(s2.points), atol=5e-3
    )
