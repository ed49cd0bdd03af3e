"""Config-5 end-to-end at production scale (VERDICT r4 next #5).

The round-4 repo had every config-5 piece (temporal matcher, metric depth,
z-buffer fusion, pose graph, resumable BA) but had only ever run them
together at 48×64/K=4. This tool runs the WHOLE pipeline at 1080p on the
chip and reports measured numbers:

* matcher throughput over the keyframe clip (the production census+LR
  configuration),
* fusion throughput (fused keyframes/s) and fused-depth accuracy vs exact
  ground truth,
* pose-graph relaxation error, BA LM iters/s through the production
  ``fusion.solve_resumable`` path (checkpointed segments),
* end-to-end wall time.

Scene construction: one consistent 3D world — the ``curved`` scene family's
disparity field in keyframe 0, converted to metric depth (f=1000 px,
B=0.05 m). Each keyframe k strafes the rig in +X; its ground-truth depth is
the forward-splatted warp of the world into pose k (holes filled row-wise),
and its stereo pair is RE-RENDERED from that exact disparity field with a
fresh texture (``utils.scenes._render`` accepts arbitrary fields), so every
keyframe's matcher input has exact per-pixel GT while the matching problems
stay independent. The warp used for GT generation is the same
``depthfusion.warp_depth_to_ref`` the fusion stage uses — its geometric
correctness is pinned separately by tests/test_fusion_depth.py against
analytic cases; what this tool measures on top is the matcher-noise
averaging and the end-to-end plumbing at scale.

    python tools/mapping_bench.py [--size 1080p|vga] [--keyframes 8]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SIZES = {
    "vga": (480, 640, 64, 3, 16),
    "1080p": (1088, 1920, 128, 4, 16),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=SIZES, default="1080p")
    ap.add_argument("--keyframes", type=int, default=8)
    ap.add_argument("--cost", default="census", choices=("sad", "census"))
    ap.add_argument("--ba-points", type=int, default=4096)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from stepth.config import MatchConfig, PyramidConfig
    from stepth.utils.cache import enable_compile_cache

    enable_compile_cache()
    from stepth.fusion import ba, depthfusion, geometry as geo, posegraph
    from stepth.fusion import resumable
    from stepth.models import StereoModel
    from stepth.utils import scenes

    H, W, DMAX, LEVELS, COARSEST = SIZES[args.size]
    K = args.keyframes
    F, B = 1000.0, 0.05  # focal px, stereo baseline m
    STRAFE = 0.02  # m between keyframes
    intr = jnp.asarray([F, F, W / 2.0, H / 2.0])
    rng = np.random.default_rng(7)

    t_all0 = time.perf_counter()

    # ---- world + per-keyframe GT ------------------------------------------
    base = scenes.make_scene("curved", H, W, DMAX, seed=1)
    d0 = base.disparity.astype(np.float64)
    Z0 = jnp.asarray((F * B) / d0)  # metric depth, keyframe 0
    poses = jnp.asarray(
        np.stack(
            [np.array([0, 0, 0, STRAFE * k, 0, 0], np.float32) for k in range(K)]
        )
    )

    def fill_rows(depth):
        """Row-wise nearest fill of splat holes (0s)."""
        d = np.array(depth)  # writable copy
        for r in range(d.shape[0]):
            row = d[r]
            bad = row <= 0
            if bad.all():
                continue
            idx = np.where(~bad, np.arange(len(row)), -1)
            np.maximum.accumulate(idx, out=idx)
            first = np.argmax(~bad)
            idx[idx < 0] = np.where(~bad)[0][0] if first >= 0 else 0
            d[r] = row[idx]
        return d

    t0 = time.perf_counter()
    warp_j = jax.jit(depthfusion.warp_depth_to_ref)
    gt_depths = [np.asarray(Z0)]
    for k in range(1, K):
        wk = warp_j(Z0, poses[0], poses[k], intr)
        gt_depths.append(fill_rows(wk))
    gt_depths = np.stack(gt_depths)  # [K, H, W]
    print(f"[mapping] GT warp+fill: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    # ---- re-render each keyframe's stereo pair from its GT disparity ------
    t0 = time.perf_counter()
    lefts, rights = [], []
    for k in range(K):
        disp_k = np.clip((F * B) / np.maximum(gt_depths[k], 1e-3),
                         0.0, DMAX - 1.0).astype(np.float32)
        tex = scenes._tex(np.random.default_rng(100 + k), H, W)
        sc = scenes._render(
            [scenes._Layer(disp_k, None, tex)], H, W, 8, f"kf{k}"
        )
        lefts.append(sc.left)
        rights.append(sc.right)
    clip_l = jnp.asarray(np.stack(lefts))
    clip_r = jnp.asarray(np.stack(rights))
    print(f"[mapping] render {K} keyframe pairs: {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)

    # ---- stage 1: temporal matcher (production configuration) -------------
    model = StereoModel(
        backend="hierarchical",
        match=MatchConfig(num_disparities=DMAX, window=9, cost=args.cost),
        pyramid=PyramidConfig(levels=LEVELS, coarsest_disparities=COARSEST),
        lr_check=True,
    )
    run = jax.jit(model.video(keyframe_interval=4))
    res = run(clip_l, clip_r)  # compile + first run
    res.disparity.block_until_ready()
    t0 = time.perf_counter()
    res = run(clip_l, clip_r)
    res.disparity.block_until_ready()
    t_match = time.perf_counter() - t0
    disp = np.asarray(res.disparity)
    valid = np.asarray(res.valid)
    match_fps = K / t_match
    # matcher accuracy vs the exact GT disparities (non-occluded via valid)
    gt_disp = np.clip((F * B) / np.maximum(gt_depths, 1e-3), 0, DMAX - 1)
    epe = np.abs(disp - gt_disp)[valid].mean()
    print(f"[mapping] matcher ({args.cost}+LR): {t_match*1e3:.1f} ms for {K} "
          f"keyframes -> {match_fps:.1f} frames/s; clip EPE {epe:.3f} px "
          f"(valid {valid.mean():.3f})", file=sys.stderr)

    # ---- stage 2: metric depth + multi-keyframe fusion ---------------------
    depths = jnp.asarray(
        np.where(valid, (F * B) / np.maximum(disp, 1e-3), 0.0).astype(np.float32)
    )
    fuse = jax.jit(
        lambda d, p: depthfusion.fuse_depths(d, p, p[0], intr)
    )
    fused = fuse(depths, poses)
    fused.depth.block_until_ready()
    t0 = time.perf_counter()
    fused = fuse(depths, poses)
    fused.depth.block_until_ready()
    t_fuse = time.perf_counter() - t0
    fdepth = np.asarray(fused.depth)
    fconf = np.asarray(fused.confidence)
    have = fdepth > 0
    relerr = np.abs(fdepth - np.asarray(Z0)) / np.asarray(Z0)
    core = have & (fconf >= 3)
    single = np.abs(np.asarray(depths[0]) - np.asarray(Z0)) / np.asarray(Z0)
    single_ok = np.asarray(depths[0]) > 0
    # median + inlier fractions: a failed match at near-zero disparity maps
    # to astronomical depth, so means are outlier-dominated by construction
    fused_med = float(np.median(relerr[core]))
    fused_in1 = float((relerr[core] < 0.01).mean())
    single_med = float(np.median(single[single_ok]))
    single_in1 = float((single[single_ok] < 0.01).mean())
    print(
        f"[mapping] fusion: {t_fuse*1e3:.1f} ms for {K} keyframes -> "
        f"{K/t_fuse:.1f} fused keyframes/s; coverage {have.mean():.3f}, "
        f"conf>=3 {core.mean():.3f}; fused |dZ|/Z median {fused_med:.4f} / "
        f"inliers<1% {fused_in1:.3f} (single-view {single_med:.4f} / "
        f"{single_in1:.3f})",
        file=sys.stderr,
    )

    # ---- stage 3: pose graph (noisy odometry + loop closure) ---------------
    noisy = poses + jnp.asarray(rng.normal(0, 0.01, (K, 6)).astype(np.float32))
    noisy = noisy.at[0].set(poses[0])
    ei = jnp.asarray(list(range(K - 1)) + [0], jnp.int32)
    ej = jnp.asarray(list(range(1, K)) + [K - 1], jnp.int32)
    meas = geo.relative(poses[ei], poses[ej])
    graph = posegraph.PoseGraph(noisy, ei, ej, meas, jnp.ones(K, jnp.float32))
    t0 = time.perf_counter()
    opt = posegraph.optimize(graph, iters=10)
    opt.block_until_ready()
    t_pg = time.perf_counter() - t0
    pg_err = float(posegraph.total_error(graph, opt))
    pose_rmse = float(np.sqrt(np.mean((np.asarray(opt) - np.asarray(poses)) ** 2)))
    print(f"[mapping] pose graph: {t_pg*1e3:.1f} ms (incl. compile), residual "
          f"{pg_err:.2e}, pose RMSE vs GT {pose_rmse:.4f}", file=sys.stderr)

    # ---- stage 4: resumable BA over fused-geometry support points ----------
    P = args.ba_points
    ys = rng.integers(8, H - 8, P)
    xs = rng.integers(8, W - 8, P)
    z = np.asarray(Z0)[ys, xs]
    uv0 = jnp.asarray(np.stack([xs, ys], -1).astype(np.float32))
    pts = geo.unproject(uv0, jnp.asarray(z.astype(np.float32)), intr)
    pts = geo.transform(geo.inverse(poses[0])[None], pts)
    ci = jnp.asarray(np.repeat(np.arange(K), P), jnp.int32)
    pi = jnp.asarray(np.tile(np.arange(P), K), jnp.int32)
    uv = geo.project(geo.transform(poses[ci], pts[pi]), intr)
    uv = uv + jnp.asarray(rng.normal(0, 0.3, uv.shape).astype(np.float32))
    prob = ba.BAProblem(
        poses=opt,
        points=pts + jnp.asarray(rng.normal(0, 0.002, pts.shape).astype(np.float32)),
        intrinsics=intr,
        cam_idx=ci,
        pt_idx=pi,
        uv=uv,
        weight=jnp.ones(K * P, jnp.float32),
    )
    ckpt = "/tmp/mapping_bench_ba.npz"
    if os.path.exists(ckpt):
        os.remove(ckpt)
    LM = 10
    t0 = time.perf_counter()
    state = resumable.solve_resumable(prob, ckpt, iters=LM, cg_iters=10, every=5)
    state.poses.block_until_ready()
    t_ba = time.perf_counter() - t0
    print(
        f"[mapping] resumable BA ({K} cams, {P} pts, {K*P} obs): "
        f"{t_ba:.2f} s for {LM} LM iters (incl. compile + 2 checkpoints) -> "
        f"{LM/t_ba:.1f} iters/s; cost {float(state.cost):.2e}",
        file=sys.stderr,
    )
    os.remove(ckpt)

    t_all = time.perf_counter() - t_all0
    print(
        f"[mapping] END-TO-END {args.size} K={K}: {t_all:.1f} s wall "
        f"(match {t_match*1e3:.0f} ms + fuse {t_fuse*1e3:.0f} ms + "
        f"posegraph {t_pg*1e3:.0f} ms + BA {t_ba:.1f} s + host render/GT)",
        file=sys.stderr,
    )
    print(
        f"| {args.size} | K={K} | match {match_fps:.0f} fps ({args.cost}+LR, "
        f"EPE {epe:.2f}) | fuse {K/t_fuse:.0f} kf/s (median |dZ|/Z "
        f"{fused_med:.4f} vs single {single_med:.4f}; <1% {fused_in1:.3f} vs "
        f"{single_in1:.3f}) | BA {LM/t_ba:.1f} it/s | wall {t_all:.1f} s |"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
