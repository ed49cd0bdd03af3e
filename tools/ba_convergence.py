"""BA solver evidence for BASELINE.md config 5 (round-2 VERDICT #7):

1. CG convergence on the implicit Schur system — relative residual per
   iteration with the block-Jacobi preconditioner vs plain CG, at bench
   scale and production scale → "iters to 1e-6".
2. The obs-sharded solver (`solve_sharded`, 1-device mesh) timed on the
   device at production scale (128 cams / 65 536 pts / 1 048 576 obs) next to
   the single-device path.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from jax.sharding import Mesh  # noqa: E402

from stepth.fusion import ba  # noqa: E402
from stepth.utils.cache import enable_compile_cache  # noqa: E402


def make_problem(n_cams, n_pts, obs_per_cam, seed=0, perturb=0.01):
    return ba.synthetic_problem(n_cams, n_pts, n_cams * obs_per_cam, seed, perturb)


def report_convergence(name, prob, cg_iters=30):
    for use_p, label in ((True, "block-Jacobi"), (False, "plain")):
        hist = np.asarray(
            ba.cg_convergence(prob, cg_iters=cg_iters, use_precond=use_p)
        )
        to6 = np.argmax(hist <= 1e-6) if (hist <= 1e-6).any() else -1
        to3 = np.argmax(hist <= 1e-3) if (hist <= 1e-3).any() else -1
        curve = " ".join(f"{v:.1e}" for v in hist[: min(16, len(hist))])
        print(f"[ba-cg] {name} {label}: iters-to-1e-3 = {to3}, "
              f"iters-to-1e-6 = {to6}; rel-residuals: {curve} ...", flush=True)


def time_solver(name, fn, prob, n=6):
    st = fn(prob)
    _ = float(st.cost)  # compile + first
    t0 = time.perf_counter()
    p = prob
    for _ in range(n):
        st = fn(p)
        p = p._replace(poses=st.poses, points=st.points)
    _ = float(st.cost)
    per = (time.perf_counter() - t0) / n
    print(f"[ba-time] {name}: {per*1e3:.1f} ms / 10 LM iters -> "
          f"{10/per:.2f} LM iters/s (cost {float(st.cost):.2e})", flush=True)
    return per


def main():
    enable_compile_cache()
    small = make_problem(32, 4096, 2048)
    report_convergence("bench-scale 32c/4096p/65k-obs", small)

    big = make_problem(128, 65536, 8192)
    report_convergence("production 128c/65536p/1M-obs", big)

    time_solver("single-path solve (128c/1M obs)",
                lambda p: ba.solve(p, iters=10, cg_iters=10), big)

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    time_solver("obs-sharded solve_sharded (1-device mesh, 128c/1M obs)",
                lambda p: ba.solve_sharded(p, mesh, iters=10, cg_iters=10), big)


if __name__ == "__main__":
    main()
