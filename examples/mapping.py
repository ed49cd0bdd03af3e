"""Multi-keyframe mapping: stereo depth → metric depth → fuse into a keyframe
→ refine poses with pose-graph + bundle adjustment (BASELINE.md config 5).
Synthetic rig; runs anywhere:

    python examples/mapping.py

Production scale (1080p, K=8, measured throughput/accuracy on the chip):
``python tools/mapping_bench.py --size 1080p`` — same pipeline with a
consistent re-rendered 3D world and exact per-keyframe ground truth.
"""

import os, sys, tempfile
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import numpy as np
import jax.numpy as jnp

from stepth.fusion import ba, depthfusion, geometry as geo, posegraph

rng = np.random.default_rng(0)
K = 4  # keyframes
H, W = 48, 64
intr = jnp.asarray([60.0, 60.0, W / 2, H / 2])

# ground-truth rig: cameras strafing in +X, looking at a plane at Z=5
poses_gt = jnp.asarray(
    np.stack([np.array([0, 0, 0, 0.3 * k, 0, 0], np.float32) for k in range(K)])
)
depths = jnp.full((K, H, W), 5.0)

# fuse all keyframe depths into keyframe 0's view
fused = depthfusion.fuse_depths(depths, poses_gt, poses_gt[0], intr)
print("fused depth mean:", float(fused.depth[fused.depth > 0].mean()))
print("consensus views:", float(fused.confidence.max()))

# pose graph: noisy odometry + loop closure relaxes back to ground truth
noisy = poses_gt + jnp.asarray(rng.normal(0, 0.03, (K, 6)).astype(np.float32))
noisy = noisy.at[0].set(poses_gt[0])
edges_i = jnp.asarray(list(range(K - 1)) + [0], jnp.int32)
edges_j = jnp.asarray(list(range(1, K)) + [K - 1], jnp.int32)
meas = geo.relative(poses_gt[edges_i], poses_gt[edges_j])
graph = posegraph.PoseGraph(noisy, edges_i, edges_j, meas, jnp.ones(K, jnp.float32))
opt = posegraph.optimize(graph, iters=10)
print("pose-graph error:", float(posegraph.total_error(graph, opt)))

# bundle adjustment over sparse support points
P = 64
pts = jnp.asarray(rng.uniform(-1, 1, (P, 3)).astype(np.float32)).at[:, 2].add(5.0)
ci = jnp.asarray(np.repeat(np.arange(K), P), jnp.int32)
pi = jnp.asarray(np.tile(np.arange(P), K), jnp.int32)
uv = geo.project(geo.transform(poses_gt[ci], pts[pi]), intr)
prob = ba.BAProblem(
    poses=opt, points=pts + 0.02, intrinsics=intr,
    cam_idx=ci, pt_idx=pi, uv=uv, weight=jnp.ones(K * P, jnp.float32),
)
state = ba.solve(prob, iters=8, cg_iters=10)
print("BA reprojection cost:", float(state.cost))

# export the fused keyframe as a point cloud (inspect in any PLY viewer)
from stepth.core import io

cloud = geo.depth_to_points(fused.depth, intr)
ply = os.path.join(tempfile.gettempdir(), "keyframe0.ply")
n = io.save_ply(ply, cloud, valid=fused.depth > 0)
print(f"wrote {ply} ({n} points)")
