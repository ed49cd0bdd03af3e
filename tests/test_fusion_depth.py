"""Pose-graph and depth-fusion tests."""

import numpy as np
import jax.numpy as jnp

from stepth.fusion import depthfusion, geometry as geo, posegraph


def test_posegraph_recovers_chain(rng):
    """A noisy chain + loop-closure graph relaxes to the ground truth."""
    m = 6
    gt = []
    for i in range(m):
        gt.append(
            np.concatenate(
                [rng.normal(0, 0.1, 3), np.array([i * 1.0, 0.0, 0.0])]
            ).astype(np.float32)
        )
    gt = jnp.asarray(np.stack(gt))

    ei, ej, meas = [], [], []
    for i in range(m - 1):  # odometry chain
        ei.append(i), ej.append(i + 1)
        meas.append(geo.relative(gt[i], gt[i + 1]))
    ei.append(0), ej.append(m - 1)  # loop closure
    meas.append(geo.relative(gt[0], gt[m - 1]))

    noisy = np.asarray(gt) + rng.normal(0, 0.05, (m, 6)).astype(np.float32)
    noisy[0] = np.asarray(gt[0])
    graph = posegraph.PoseGraph(
        poses=jnp.asarray(noisy),
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        measurements=jnp.stack(meas),
        weights=jnp.ones(len(ei), jnp.float32),
    )
    e0 = float(posegraph.total_error(graph, graph.poses))
    opt = posegraph.optimize(graph, iters=15)
    e1 = float(posegraph.total_error(graph, opt))
    assert e1 < e0 * 1e-4
    np.testing.assert_allclose(np.asarray(opt), np.asarray(gt), atol=5e-3)


def test_warp_identity_pose_roundtrip():
    """Warping into the same view reproduces the depth map (up to rounding)."""
    h, w = 32, 40
    intr = jnp.asarray([50.0, 50.0, w / 2, h / 2])
    depth = jnp.full((h, w), 4.0)
    pose = jnp.zeros(6)
    warped = depthfusion.warp_depth_to_ref(depth, pose, pose, intr)
    np.testing.assert_allclose(np.asarray(warped), 4.0, atol=1e-4)


def test_warp_translated_camera_shifts_depth():
    """A camera translated along +X sees the plane shifted; depth unchanged for
    a fronto-parallel plane."""
    h, w = 32, 40
    intr = jnp.asarray([50.0, 50.0, w / 2, h / 2])
    depth = jnp.full((h, w), 5.0)
    src_pose = jnp.zeros(6)
    ref_pose = jnp.asarray([0.0, 0.0, 0.0, 0.5, 0.0, 0.0])  # world→ref shifts X
    warped = np.asarray(depthfusion.warp_depth_to_ref(depth, src_pose, ref_pose, intr))
    filled = warped > 0
    assert filled.mean() > 0.8  # most pixels covered
    np.testing.assert_allclose(warped[filled], 5.0, atol=1e-3)


def test_fuse_depths_consensus(rng):
    h, w = 24, 30
    intr = jnp.asarray([40.0, 40.0, w / 2, h / 2])
    pose = jnp.zeros(6)
    base = jnp.full((h, w), 3.0)
    depths = jnp.stack([base, base * 1.005, base * 3.0])  # two agree, one far
    poses = jnp.stack([pose, pose, pose])
    fused = depthfusion.fuse_depths(depths, poses, pose, intr, rel_tol=0.02)
    np.testing.assert_allclose(np.asarray(fused.depth), 3.0 * 1.0025, rtol=0.01)
    assert (np.asarray(fused.confidence) == 2).all()


def test_fuse_depths_empty_inputs():
    h, w = 8, 10
    intr = jnp.asarray([40.0, 40.0, w / 2, h / 2])
    pose = jnp.zeros(6)
    fused = depthfusion.fuse_depths(
        jnp.zeros((2, h, w)), jnp.stack([pose, pose]), pose, intr
    )
    assert (np.asarray(fused.depth) == 0).all()
    assert (np.asarray(fused.confidence) == 0).all()


def test_posegraph_robust_to_false_closure(rng):
    """A FALSE loop-closure edge (wrong relative pose, normal weight): under
    l2 it warps the whole trajectory; under cauchy its influence redescends
    to ~0 and the chain relaxes to ground truth anyway."""
    m = 6
    gt = []
    for i in range(m):
        gt.append(
            np.concatenate(
                [rng.normal(0, 0.1, 3), np.array([i * 1.0, 0.0, 0.0])]
            ).astype(np.float32)
        )
    gt = jnp.asarray(np.stack(gt))

    ei, ej, meas = [], [], []
    for i in range(m - 1):  # odometry chain (true)
        ei.append(i), ej.append(i + 1)
        meas.append(geo.relative(gt[i], gt[i + 1]))
    ei.append(0), ej.append(m - 1)  # true loop closure
    meas.append(geo.relative(gt[0], gt[m - 1]))
    ei.append(1), ej.append(4)  # FALSE closure: claims node 4 sits at node 1+1m
    meas.append(jnp.asarray(np.array([0, 0, 0, 1.0, 0, 0], np.float32)))

    noisy = np.asarray(gt) + rng.normal(0, 0.03, (m, 6)).astype(np.float32)
    noisy[0] = np.asarray(gt[0])
    graph = posegraph.PoseGraph(
        poses=jnp.asarray(noisy),
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        measurements=jnp.stack(meas),
        weights=jnp.ones(len(ei), jnp.float32),
    )
    opt_l2 = posegraph.optimize(graph, iters=20)
    opt_cau = posegraph.optimize(graph, iters=20, loss="cauchy", loss_delta=0.1)
    opt_hub = posegraph.optimize(graph, iters=20, loss="huber", loss_delta=0.1)
    e_l2 = float(np.abs(np.asarray(opt_l2) - np.asarray(gt)).max())
    e_cau = float(np.abs(np.asarray(opt_cau) - np.asarray(gt)).max())
    e_hub = float(np.abs(np.asarray(opt_hub) - np.asarray(gt)).max())
    # the false edge demands node 4 move ~2m; l2 splits the error across the
    # trajectory, cauchy suppresses the edge entirely
    assert e_l2 > 0.2, e_l2
    assert e_cau < 0.02, e_cau
    assert e_hub < e_l2 * 0.5, (e_hub, e_l2)

    # l2 path unchanged by the loss plumbing (bitwise)
    a = posegraph.optimize(graph, iters=5)
    b = posegraph.optimize(graph, iters=5, loss="l2")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
