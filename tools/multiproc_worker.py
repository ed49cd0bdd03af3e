"""Worker body for the multi-process `jax.distributed` drill.

The reference has no distributed layer at all (SURVEY.md §2.3: its only
parallelism is an in-process rayon pool, reference src/depth_image.rs:111-129);
this build's multi-host story is `jax.distributed` + XLA collectives. This
worker exercises that story for real — N OS processes, each owning 4 virtual
CPU devices, forming one 8-device global mesh through the coordination
service — so the multi-host code path (global mesh construction, cross-process
halo ppermutes, cross-process pmax, runtime heartbeat failure detection) runs
on one machine's CPU.

Run as:  python tools/multiproc_worker.py <pid> <nprocs> <port> <mode>
Modes:
  match    — sharded dense match + collective depth normalization on the
             2-process global mesh; every process asserts its addressable
             shards are bit-identical to the single-device reference.
  failure  — process 1 dies abruptly after bring-up; process 0 must *detect*
             the failure (coordination-service heartbeat) instead of hanging
             in the next barrier, then exits 0 to signal a successful drill.
  ba       — distributed Schur-complement bundle adjustment across the two
             processes: observations shard over the 8-device data axis (psum
             reductions cross the process boundary every LM/CG step), states
             replicate; every process asserts the result matches a
             single-device LM run of the same problem.
  sgm      — row-tile-sharded semi-global matching in exact mode: the
             vertical/diagonal scan-carry relay ppermutes shard-to-shard,
             crossing the OS-process boundary mid-chain; every process
             asserts its shards match the unsharded XLA SGM backend.
"""

import os
import sys


def main() -> None:
    pid, nprocs, port, mode = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        sys.argv[3],
        sys.argv[4],
    )
    # a CPU-only drill: several of these processes share one machine, and
    # each would otherwise claim the same accelerator
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

    import jax

    from stepth.parallel import distributed

    distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
        heartbeat_timeout_s=10,
        initialization_timeout_s=120,
    )
    assert distributed.process_info() == (pid, nprocs)

    if mode == "match":
        _drill_match(pid)
    elif mode == "failure":
        _drill_failure(pid)
    elif mode == "ba":
        _drill_ba(pid)
    elif mode == "sgm":
        _drill_sgm(pid)
    elif mode == "resumable":
        _drill_resumable(pid, nprocs)
    else:
        raise SystemExit(f"unknown mode {mode}")


def _drill_match(pid: int) -> None:
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stepth.config import MatchConfig
    from stepth.match import dense
    from stepth.parallel import distributed, sharded

    mesh = distributed.global_mesh(data=1, tile=8)
    assert mesh.devices.size == 8, mesh

    rng = np.random.default_rng(7)
    h, w, shift = 64, 96, 5
    left = rng.uniform(0, 255, (h, w)).astype(np.float32)
    right = np.roll(left, -shift, axis=1).astype(np.float32)
    cfg = MatchConfig(num_disparities=16, window=9, cost="sad")

    # Build *global* arrays from the (replicated) host data: each process
    # contributes only the row-tiles its local devices own.
    sh = NamedSharding(mesh, P("tile", None))
    gl = jax.make_array_from_callback(left.shape, sh, lambda idx: left[idx])
    gr = jax.make_array_from_callback(right.shape, sh, lambda idx: right[idx])

    res = sharded.match_pair_sharded(gl, gr, cfg, mesh)

    # Single-device reference, computed redundantly on every host.
    ref = dense.match_pair(left, right, cfg)
    ref_d = np.asarray(ref.disparity)
    ref_v = np.asarray(ref.valid)
    for shard in res.disparity.addressable_shards:
        # subpixel disparity: float-exactness modulo compiler fma/vectorization
        # differences (same tolerance as the single-process seam tests)
        np.testing.assert_allclose(
            np.asarray(shard.data), ref_d[shard.index], atol=1e-5,
            err_msg=f"pid{pid}",
        )
    for shard in res.valid.addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(shard.data), ref_v[shard.index], err_msg=f"pid{pid}"
        )

    # Collective normalization: the global max rides a cross-process pmax.
    raw = (np.abs(ref_d) * 20).astype(np.uint8)
    graw = jax.make_array_from_callback(raw.shape, sh, lambda idx: raw[idx])
    norm = sharded.normalize_depth_sharded(graw, mesh)
    want = (raw.astype(np.int64) * 255 // int(raw.max())).astype(np.uint8)
    for shard in norm.addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(shard.data), want[shard.index], err_msg=f"pid{pid}"
        )
    print(f"[worker {pid}] match drill OK", flush=True)


def _drill_sgm(pid: int) -> None:
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stepth.config import MatchConfig
    from stepth.match import sgm
    from stepth.parallel import distributed, sgm_sharded

    mesh = distributed.global_mesh(data=1, tile=8)
    assert mesh.devices.size == 8, mesh

    rng = np.random.default_rng(13)
    h, w, shift = 64, 96, 5
    left = rng.uniform(0, 255, (h, w)).astype(np.float32)
    right = np.roll(left, -shift, axis=1).astype(np.float32)
    cfg = MatchConfig(num_disparities=16, window=5, lr_threshold=1.0)
    sc = sgm.SGMConfig(directions=8)

    sh = NamedSharding(mesh, P("tile", None))
    gl = jax.make_array_from_callback(left.shape, sh, lambda idx: left[idx])
    gr = jax.make_array_from_callback(right.shape, sh, lambda idx: right[idx])
    res = sgm_sharded.match_pair_sgm_sharded(gl, gr, cfg, sc, mesh)

    # Single-device reference, computed redundantly on every process. The
    # relay chain spans all 8 shards, so rounds 4..7 of every vertical and
    # diagonal direction carry state that crossed the process boundary.
    ref = sgm.match_pair_sgm(left, right, cfg, sc)
    ref_d = np.asarray(ref.disparity)
    ref_v = np.asarray(ref.valid)
    for shard in res.disparity.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(shard.data), ref_d[shard.index], atol=1e-5,
            err_msg=f"pid{pid}",
        )
    for shard in res.valid.addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(shard.data), ref_v[shard.index], err_msg=f"pid{pid}"
        )
    print(f"[worker {pid}] sgm drill OK", flush=True)


def _ba_problem_np():
    """Deterministic BA problem, built identically on every process: 4
    cameras on an arc observing 64 points -> N=256 observations (divisible
    by data axes 8, 4, and 2)."""
    import jax.numpy as jnp
    import numpy as np

    from stepth.fusion import geometry as geo

    rng = np.random.default_rng(11)
    n_cams, n_pts = 4, 64
    intr = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    pts_gt = rng.uniform(-1.0, 1.0, (n_pts, 3)).astype(np.float32)
    pts_gt[:, 2] += 6.0
    poses_gt = np.stack(
        [
            np.concatenate(
                [
                    np.array([0.0, 0.08 * (c - n_cams / 2), 0.0], np.float32),
                    np.array([0.4 * c, 0.0, 0.0], np.float32),
                ]
            )
            for c in range(n_cams)
        ]
    ).astype(np.float32)
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = np.asarray(
        geo.project(
            geo.transform(jnp.asarray(poses_gt)[cam_idx], jnp.asarray(pts_gt)[pt_idx]),
            jnp.asarray(intr),
        )
    )
    poses0 = poses_gt + rng.normal(0, 0.03, poses_gt.shape).astype(np.float32)
    poses0[0] = poses_gt[0]  # gauge anchor stays exact
    pts0 = (pts_gt + rng.normal(0, 0.12, pts_gt.shape)).astype(np.float32)
    weight = np.ones(len(cam_idx), np.float32)
    return poses0, pts0, intr, cam_idx, pt_idx, uv, weight


def _drill_ba(pid: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stepth.fusion import ba
    from stepth.parallel import distributed

    mesh = distributed.global_mesh(data=8, tile=1)
    assert mesh.devices.size == 8, mesh

    poses0, pts0, intr, cam_idx, pt_idx, uv, weight = _ba_problem_np()

    local = ba.BAProblem(
        poses=jnp.asarray(poses0),
        points=jnp.asarray(pts0),
        intrinsics=jnp.asarray(intr),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        uv=jnp.asarray(uv),
        weight=jnp.asarray(weight),
    )
    # Single-device reference, computed redundantly on every process.
    ref = ba.solve(local, iters=4, cg_iters=8)

    def garr(x, spec):
        x = np.asarray(x)
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(x.shape, sh, lambda idx, x=x: x[idx])

    gprob = ba.BAProblem(
        poses=garr(poses0, P()),
        points=garr(pts0, P()),
        intrinsics=garr(intr, P()),
        cam_idx=garr(cam_idx, P("data")),
        pt_idx=garr(pt_idx, P("data")),
        uv=garr(uv, P("data", None)),
        weight=garr(weight, P("data")),
    )
    state = ba.solve_sharded(gprob, mesh, iters=4, cg_iters=8)

    # States replicate (P()), so every process holds full copies. Tolerances
    # mirror tests/test_fusion_ba.py::test_sharded_matches_single_device —
    # psum reduction order differs from the single-device segment-sum and LM
    # amplifies last-bit drift.
    got_poses = np.asarray(jax.device_get(state.poses))
    got_points = np.asarray(jax.device_get(state.points))
    np.testing.assert_allclose(
        got_poses, np.asarray(ref.poses), atol=5e-3, err_msg=f"pid{pid}"
    )
    np.testing.assert_allclose(
        got_points, np.asarray(ref.points), atol=5e-3, err_msg=f"pid{pid}"
    )
    c_ref = float(ref.cost)
    c_got = float(jax.device_get(state.cost))
    c0 = float(ba._cost(local, local.poses, local.points))
    assert c_got < c0 * 1e-2, (c_got, c0)  # LM actually converged
    np.testing.assert_allclose(c_got, c_ref, rtol=0.3, atol=1e-4)
    print(f"[worker {pid}] ba drill OK (cost {c0:.3e} -> {c_got:.3e})", flush=True)


def _drill_resumable(pid: int, nprocs: int) -> None:
    """Production failure-recovery path (VERDICT r3 item 7): a checkpointed
    BA solve that a supervisor can relaunch after a peer dies.

    Phase 1 (nprocs=2, 8-device global mesh): both processes run
    ``solve_resumable``; after the first checkpointed segment, process 1
    hard-exits (STEPTH_DIE_AT) without goodbye. Process 0 hangs in the next
    cross-process psum until the coordination-service heartbeat fail-fasts it
    — the *detection*. Phase 2 (nprocs=1, relaunched by the supervisor): the
    surviving topology rebuilds its mesh from the 4 devices it still has
    (``auto_mesh`` — the shrunken mesh) and the same call resumes from the
    checkpoint and completes. BA state replicates, so any surviving subset
    can continue.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from stepth.fusion import ba, resumable
    from stepth.parallel import distributed

    ckpt_dir = os.environ["STEPTH_CKPT_DIR"]
    die_at = int(os.environ.get("STEPTH_DIE_AT", "-1"))
    # per-process checkpoint file: BA state replicates, so each process owns
    # an identical copy and the survivor resumes from its own (no write race)
    ckpt = os.path.join(ckpt_dir, f"ba_resumable_p{pid}.npz")

    poses0, pts0, intr, cam_idx, pt_idx, uv, weight = _ba_problem_np()
    arrays = dict(
        poses=(poses0, P()), points=(pts0, P()), intrinsics=(intr, P()),
        cam_idx=(cam_idx, P("data")), pt_idx=(pt_idx, P("data")),
        uv=(uv, P("data", None)), weight=(weight, P("data")),
    )
    if nprocs > 1:
        mesh = distributed.global_mesh(data=8, tile=1)

        def garr(x, spec):
            x = np.asarray(x)
            sh = NamedSharding(mesh, spec)
            return jax.make_array_from_callback(
                x.shape, sh, lambda idx, x=x: x[idx]
            )

        prob = ba.BAProblem(**{k: garr(*v) for k, v in arrays.items()})
    else:
        mesh = resumable.auto_mesh(len(cam_idx))
        assert mesh is not None and mesh.devices.size == 4, mesh
        prob = ba.BAProblem(**{k: jnp.asarray(v[0]) for k, v in arrays.items()})

    def on_segment(done, state):
        print(f"[worker {pid}] segment done: iter {done}, "
              f"cost {float(jax.device_get(state.cost)):.3e}", flush=True)
        if pid == 1 and done == die_at:
            os._exit(43)  # no goodbye — peer must *detect* this

    st = resumable.solve_resumable(
        prob, ckpt, iters=6, cg_iters=8, every=2, mesh=mesh,
        on_segment=on_segment,
    )
    c0 = float(ba._cost(
        ba.BAProblem(**{k: jnp.asarray(v[0]) for k, v in arrays.items()}),
        jnp.asarray(poses0), jnp.asarray(pts0),
    ))
    c = float(jax.device_get(st.cost))
    assert c < c0 * 1e-2, (c, c0)
    np.savez(
        os.path.join(ckpt_dir, f"final_p{pid}.npz"),
        poses=np.asarray(jax.device_get(st.poses)),
        points=np.asarray(jax.device_get(st.points)),
        cost=c,
    )
    print(f"[worker {pid}] resumable drill OK (cost {c0:.3e} -> {c:.3e})",
          flush=True)
    # phase-1 success path is never reached by pid 1 (it dies at die_at); in
    # phase 2 the normal exit suffices — no distributed shutdown barrier to
    # dodge because nprocs == 1


def _drill_failure(pid: int) -> None:
    import time

    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("stepth-drill-up")
    if pid == 1:
        # Die without goodbye — no coordination-service shutdown, simulating
        # a host crash. Process 0 must notice via missed heartbeats.
        os._exit(42)
    time.sleep(2.0)
    t0 = time.monotonic()
    try:
        multihost_utils.sync_global_devices("stepth-drill-after-death")
    except Exception as e:  # noqa: BLE001 — any fail-fast error is a pass
        dt = time.monotonic() - t0
        print(f"[worker 0] peer failure detected in {dt:.1f}s: {type(e).__name__}",
              flush=True)
        # skip the atexit distributed-shutdown barrier: with the peer dead it
        # would fail and hard-abort this (already successful) drill
        os._exit(0)
    raise SystemExit("barrier succeeded after peer death — detector inert")


if __name__ == "__main__":
    main()
