"""Failure-recovery drill (VERDICT round-1 item 9): checkpoint → kill →
restart → resume, asserting the resumed run equals an uninterrupted one
bit-for-bit.

The recovery model for multi-host jobs is fail-fast + restart-from-checkpoint
(stepth.parallel.distributed wires the coordination-service heartbeat as
the detector); this drill exercises the restart half with *real process
boundaries*: phase A runs 5 LM iterations in its own Python process, saves a
checkpoint (poses/points/lm_lambda), and exits — simulating a preemption right
after a checkpoint. Phase B starts a fresh process, restores, and runs the
remaining 5 iterations. The solver's full iteration state is the checkpoint
(LM lambda included), so the resumed trajectory must match 10 straight
iterations exactly.
"""

import os
import subprocess
import sys

import numpy as np

_DRIVER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[4])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from stepth.fusion import ba
from stepth.utils import checkpoint

phase, ckpt, out, repo = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
prob_npz = np.load(os.path.join(os.path.dirname(ckpt), "problem.npz"))
problem = ba.BAProblem(**{k: jnp.asarray(v) for k, v in prob_npz.items()})

if phase == "A":
    st = ba.solve(problem, iters=5, cg_iters=8)
    checkpoint.save(ckpt, {
        "poses": st.poses, "points": st.points, "lm": st.lm_lambda,
    })
else:
    like = {"poses": problem.poses, "points": problem.points,
            "lm": jnp.float32(0)}
    state = checkpoint.restore(ckpt, like=like)
    problem = problem._replace(
        poses=jnp.asarray(state["poses"]), points=jnp.asarray(state["points"])
    )
    st = ba.solve(problem, iters=5, cg_iters=8,
                  lm_lambda0=float(np.asarray(state["lm"])))
    np.savez(out, poses=np.asarray(st.poses), points=np.asarray(st.points),
             cost=np.asarray(st.cost))
"""


def test_ba_checkpoint_kill_resume(tmp_path, rng):
    from tests.test_fusion_ba import make_problem
    from stepth.fusion import ba

    problem, _, _ = make_problem(rng, n_cams=4, n_pts=40, perturb=0.05)
    np.savez(
        tmp_path / "problem.npz",
        **{k: np.asarray(v) for k, v in problem._asdict().items()},
    )
    driver = tmp_path / "driver.py"
    driver.write_text(_DRIVER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = str(tmp_path / "ba_ckpt.npz")
    out = str(tmp_path / "final.npz")

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for phase in ("A", "B"):
        proc = subprocess.run(
            [sys.executable, str(driver), phase, ckpt, out, repo],
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert proc.returncode == 0, f"phase {phase}: {proc.stderr[-2000:]}"
        if phase == "A":
            assert os.path.exists(ckpt), "phase A produced no checkpoint"

    resumed = np.load(out)
    straight = ba.solve(problem, iters=10, cg_iters=8)
    np.testing.assert_array_equal(resumed["poses"], np.asarray(straight.poses))
    np.testing.assert_array_equal(resumed["points"], np.asarray(straight.points))


def test_solve_resumable_interrupt_resume(tmp_path, rng):
    """The production path (fusion.resumable): a solve interrupted after any
    checkpointed segment continues bit-for-bit when simply rerun."""
    import jax.numpy as jnp

    from tests.test_fusion_ba import make_problem
    from stepth.fusion import ba, resumable

    problem, _, _ = make_problem(rng, n_cams=4, n_pts=40, perturb=0.05)
    ckpt = str(tmp_path / "resumable.npz")

    class Die(Exception):
        pass

    def killer(done, state):
        if done == 4:
            raise Die()  # simulated death AFTER the segment checkpoint

    try:
        resumable.solve_resumable(
            problem, ckpt, iters=10, cg_iters=8, every=2, on_segment=killer
        )
        raise AssertionError("killer hook never fired")
    except Die:
        pass
    meta = __import__("stepth.utils.checkpoint", fromlist=["metadata"]).metadata(ckpt)
    assert meta["iter"] == 4 and meta["total_iters"] == 10

    # rerun THE SAME CALL — it must resume at iter 4, not restart
    st = resumable.solve_resumable(problem, ckpt, iters=10, cg_iters=8, every=2)
    straight = ba.solve(problem, iters=10, cg_iters=8)
    np.testing.assert_array_equal(np.asarray(st.poses), np.asarray(straight.poses))
    np.testing.assert_array_equal(np.asarray(st.points), np.asarray(straight.points))

    # a third call is a no-op restore of the completed state
    again = resumable.solve_resumable(problem, ckpt, iters=10, cg_iters=8, every=2)
    np.testing.assert_array_equal(np.asarray(again.poses), np.asarray(st.poses))


def test_checkpoint_save_is_atomic_and_tolerant(tmp_path, rng):
    """ADVICE r4 (medium): a kill mid-save must never brick the resume loop.

    save() publishes via temp-file + os.replace, so the final path only ever
    holds a complete npz; and even a corrupt file (simulating a crash that
    predates the atomic path, or disk truncation) reads as "no checkpoint"
    from metadata() and restarts solve_resumable from scratch instead of
    raising BadZipFile forever."""
    import jax.numpy as jnp

    from tests.test_fusion_ba import make_problem
    from stepth.fusion import ba, resumable
    from stepth.utils import checkpoint

    ckpt = str(tmp_path / "atomic.npz")
    state = {"poses": jnp.ones((4, 6)), "lm": jnp.float32(2.0)}
    checkpoint.save(ckpt, state, metadata={"iter": 3})
    assert checkpoint.metadata(ckpt) == {"iter": 3}
    # no temp residue next to the published file
    assert sorted(os.listdir(tmp_path)) == ["atomic.npz"]

    # truncate the file mid-way: metadata() must treat it as absent
    with open(ckpt, "r+b") as f:
        f.truncate(40)
    assert checkpoint.metadata(ckpt) is None

    # and solve_resumable over a truncated checkpoint restarts cleanly
    problem, _, _ = make_problem(rng, n_cams=4, n_pts=40, perturb=0.05)
    ckpt2 = str(tmp_path / "solve.npz")
    resumable.solve_resumable(problem, ckpt2, iters=4, cg_iters=8, every=2)
    with open(ckpt2, "r+b") as f:
        f.truncate(40)
    st = resumable.solve_resumable(problem, ckpt2, iters=4, cg_iters=8, every=2)
    straight = ba.solve(problem, iters=4, cg_iters=8)
    np.testing.assert_array_equal(np.asarray(st.poses), np.asarray(straight.poses))


def test_resumable_rejects_stale_checkpoint_from_other_problem(tmp_path, rng):
    """ADVICE r4: a checkpoint from a DIFFERENT problem at the same path (with
    a matching total_iters) must be ignored, not silently restored."""
    from tests.test_fusion_ba import make_problem
    from stepth.fusion import ba, resumable

    prob_a, _, _ = make_problem(rng, n_cams=4, n_pts=40, perturb=0.05)
    prob_b, _, _ = make_problem(rng, n_cams=4, n_pts=40, perturb=0.05)
    assert not np.array_equal(np.asarray(prob_a.uv), np.asarray(prob_b.uv))
    ckpt = str(tmp_path / "stale.npz")

    resumable.solve_resumable(prob_a, ckpt, iters=6, cg_iters=8, every=2)
    # same path, same iters, different problem: must solve B from scratch
    st_b = resumable.solve_resumable(prob_b, ckpt, iters=6, cg_iters=8, every=2)
    straight_b = ba.solve(prob_b, iters=6, cg_iters=8)
    np.testing.assert_array_equal(
        np.asarray(st_b.poses), np.asarray(straight_b.poses)
    )
    np.testing.assert_array_equal(
        np.asarray(st_b.points), np.asarray(straight_b.points)
    )


_RESUMABLE_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from stepth.fusion import ba, resumable

ckpt, out, repo, die_at = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
prob_npz = np.load(os.path.join(os.path.dirname(ckpt), "problem.npz"))
problem = ba.BAProblem(**{k: jnp.asarray(v) for k, v in prob_npz.items()})

def hook(done, state):
    if done == die_at:
        os._exit(17)  # preemption: no cleanup, no goodbye

st = resumable.solve_resumable(problem, ckpt, iters=10, cg_iters=8, every=2,
                               on_segment=hook)
np.savez(out, poses=np.asarray(st.poses), points=np.asarray(st.points))
"""


def test_supervisor_relaunches_until_done(tmp_path, rng):
    """supervise() + solve_resumable close the loop: the worker process is
    killed mid-run (twice), the supervisor relaunches it, and the final
    result equals an uninterrupted solve bit-for-bit."""
    from tests.test_fusion_ba import make_problem
    from stepth.fusion import ba
    from stepth.utils import supervisor

    problem, _, _ = make_problem(rng, n_cams=4, n_pts=40, perturb=0.05)
    np.savez(
        tmp_path / "problem.npz",
        **{k: np.asarray(v) for k, v in problem._asdict().items()},
    )
    worker = tmp_path / "worker.py"
    worker.write_text(_RESUMABLE_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = str(tmp_path / "sup_ckpt.npz")
    out = str(tmp_path / "sup_final.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    # die after iter 2 on attempt 0, after iter 6 on attempt 1, then finish
    def argv(attempt):
        die_at = {0: "2", 1: "6"}.get(attempt, "-1")
        return [sys.executable, str(worker), ckpt, out, repo, die_at]

    logs = []
    rc = supervisor.supervise(
        argv, max_restarts=3, backoff_s=0.01, env=env,
        attempt_timeout_s=600, log=logs.append,
    )
    assert rc == 0, logs
    assert any("recovered after 2 restart(s)" in m for m in logs), logs

    final = np.load(out)
    straight = ba.solve(problem, iters=10, cg_iters=8)
    np.testing.assert_array_equal(final["poses"], np.asarray(straight.poses))
    np.testing.assert_array_equal(final["points"], np.asarray(straight.points))
