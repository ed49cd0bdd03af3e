"""Distributed Schur-complement bundle adjustment.

Greenfield subsystem (BASELINE.md config 5; the reference has no multi-frame
machinery). Levenberg–Marquardt over camera poses [C,6] and world points [P,3]
with reprojection residuals, solved each step by **implicit-Schur CG**:

* Jacobian blocks per observation: A = ∂r/∂pose [N,2,6], B = ∂r/∂point [N,2,3]
  (via ``jax.jacfwd`` on the single-observation residual, vmapped — no
  hand-derived Jacobians to get wrong).
* Hessian blocks by segment-sum: U_c = Σ AᵀA, V_p = Σ BᵀB, per-obs W = AᵀB.
* The reduced camera system S·x = b (S = U − W V⁻¹ Wᵀ) is solved by CG where
  each S·x application is two segment-sums and small einsums — S is never
  materialized, so cost is O(N) per CG iteration. Segment-sums are
  scatter-adds over the flattened operand (``_segsum``).
* **Distribution**: observations shard over the mesh ``data`` axis
  (shard_map); U, V, b and every CG matvec's partial segment-sums are combined
  with ``psum`` — poses/points replicate. This is the standard dominant-cost
  split: N ≫ C, P.

All shapes static; invalid observation slots are masked by weight 0, so
variable-size problems pad to a fixed N.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from stepth.fusion import geometry


class BAProblem(NamedTuple):
    """A fixed-size bundle-adjustment problem (pad + mask to resize)."""

    poses: jax.Array  # f32[C, 6] se3 world→camera
    points: jax.Array  # f32[P, 3]
    intrinsics: jax.Array  # f32[4] shared (fx, fy, cx, cy)
    cam_idx: jax.Array  # i32[N]
    pt_idx: jax.Array  # i32[N]
    uv: jax.Array  # f32[N, 2] observed pixels
    weight: jax.Array  # f32[N] (0 masks a padded slot)


class BAState(NamedTuple):
    poses: jax.Array
    points: jax.Array
    cost: jax.Array  # scalar mean squared reprojection error (weighted)
    lm_lambda: jax.Array


def _residual_one(pose, point, intr, uv):
    return geometry.project(geometry.transform(pose, point), intr) - uv


def _segsum(x, idx, num_segments: int):
    """Segment-sum over the leading axis, on the operand flattened to 2-D
    (one scatter-add of [N, feat] rows)."""
    flat = x.reshape(x.shape[0], -1)
    out = jax.ops.segment_sum(flat, idx, num_segments=num_segments)
    return out.reshape((num_segments,) + x.shape[1:])


def _inv3(m):
    """Closed-form adjugate inverse for batched 3×3 SPD blocks: a handful of
    fused elementwise ops instead of batched LU solves."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    D = c * h - b * i
    E = a * i - c * g
    F = b * g - a * h
    G = b * f - c * e
    H = c * d - a * f
    I = a * e - b * d
    det = a * A + b * B + c * C
    adj = jnp.stack(
        [
            jnp.stack([A, D, G], -1),
            jnp.stack([B, E, H], -1),
            jnp.stack([C, F, I], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def _inv_spd(m):
    """Batched SPD inverse via Cholesky (for the [C,6,6] camera blocks)."""
    chol = jnp.linalg.cholesky(m)
    eye = jnp.broadcast_to(jnp.eye(m.shape[-1], dtype=m.dtype), m.shape)
    return jax.scipy.linalg.cho_solve((chol, True), eye)


def residuals(problem: BAProblem, poses, points) -> jax.Array:
    """Weighted reprojection residuals f32[N, 2]."""
    r = jax.vmap(_residual_one, in_axes=(0, 0, None, 0))(
        poses[problem.cam_idx], points[problem.pt_idx], problem.intrinsics, problem.uv
    )
    return r * problem.weight[:, None]


def _jacobian_blocks(problem: BAProblem, poses, points):
    """Per-observation A [N,2,6], B [N,2,3], r [N,2] (weighted)."""

    def one(pose, point, uv, wgt):
        r = _residual_one(pose, point, problem.intrinsics, uv)
        A = jax.jacfwd(lambda p: _residual_one(p, point, problem.intrinsics, uv))(pose)
        B = jax.jacfwd(lambda x: _residual_one(pose, x, problem.intrinsics, uv))(point)
        return r * wgt, A * wgt, B * wgt

    return jax.vmap(one)(
        poses[problem.cam_idx], points[problem.pt_idx], problem.uv, problem.weight
    )


def _schur_system(problem, A, B, r, lm_lambda, axis_name: Optional[str]):
    """Build the implicit reduced camera system: returns
    ``(S_apply, precond, b, back_substitute)`` where ``S_apply(x)`` applies the
    Schur complement S = U − W V⁻¹ Wᵀ without materializing it, ``precond`` is
    the block-Jacobi M⁻¹ = diag(U_d)⁻¹ application, ``b`` the Schur RHS, and
    ``back_substitute(dpose)`` recovers Δpoints.

    With ``axis_name``, every segment-sum reduction is followed by a psum so
    the result is correct when observations are sharded along that axis.
    """
    C = problem.poses.shape[0]
    Pn = problem.points.shape[0]
    ci, pi = problem.cam_idx, problem.pt_idx

    def allsum(x):
        return lax.psum(x, axis_name) if axis_name else x

    # Per-observation products as broadcast-multiply-sums, NOT einsums: with
    # default precision a tiny batched einsum may run in a reduced-precision
    # matrix unit (TF32 on a GPU), while the broadcast form is exact f32.
    def outer(a, b):  # Σ_k a[n,k,i]·b[n,k,j] → [N,i,j]
        return jnp.sum(a[:, :, :, None] * b[:, :, None, :], axis=1)

    def matvec_t(m, v):  # Σ_i m[n,i,j]·v[n,i] → [N,j]
        return jnp.sum(m * v[:, :, None], axis=1)

    def matvec(m, v):  # Σ_j m[n,i,j]·v[n,j] → [N,i]
        return jnp.sum(m * v[:, None, :], axis=2)

    # Hessian blocks + gradients. The camera- and point-side reductions each
    # fuse the Hessian block and the gradient into ONE segment-sum
    # (concat along the feature axis): [N,42]→C and [N,12]→P.
    cam_feats = jnp.concatenate(
        [outer(A, A).reshape(-1, 36), matvec_t(A, r)], axis=1
    )  # [N, 42]
    pt_feats = jnp.concatenate(
        [outer(B, B).reshape(-1, 9), matvec_t(B, r)], axis=1
    )  # [N, 12]
    cam_red = allsum(_segsum(cam_feats, ci, C))  # [C,42]
    pt_red = allsum(_segsum(pt_feats, pi, Pn))  # [P,12]
    U = cam_red[:, :36].reshape(C, 6, 6)
    g_c = cam_red[:, 36:]
    V = pt_red[:, :9].reshape(Pn, 3, 3)
    g_p = pt_red[:, 9:]
    W = outer(A, B)  # [N,6,3] stays local

    # LM damping (additive, Marquardt-style on the diagonal)
    eye6 = jnp.eye(6, dtype=U.dtype)
    eye3 = jnp.eye(3, dtype=V.dtype)
    U_d = U + lm_lambda * eye6
    V_d = V + lm_lambda * eye3
    V_inv = _inv3(V_d)  # [P,3,3] closed-form batched inverses

    # Schur RHS: b = -g_c + W V⁻¹ g_p
    Vg = matvec(V_inv, g_p)
    b = -g_c + allsum(_segsum(matvec(W, Vg[pi]), ci, C))

    def S_apply(x):  # x [C,6] → S x [C,6]
        Ux = matvec(U_d, x)
        Wx_p = allsum(
            _segsum(matvec_t(W, x[ci]), pi, Pn)
        )  # [P,3] = Σ Wᵀ x over each point's obs
        z = matvec(V_inv, Wx_p)
        WVz = allsum(_segsum(matvec(W, z[pi]), ci, C))
        return Ux - WVz

    # block-Jacobi preconditioner M⁻¹ = diag(U_d)⁻¹
    M_inv = _inv_spd(U_d)

    def precond(x):
        return matvec(M_inv, x)

    def back_substitute(dpose):
        # Δp = V⁻¹(−g_p − Wᵀ Δc)
        Wt_dc = allsum(_segsum(matvec_t(W, dpose[ci]), pi, Pn))
        return matvec(V_inv, -g_p - Wt_dc)

    return S_apply, precond, b, back_substitute


def _schur_solve(problem, A, B, r, lm_lambda, cg_iters, axis_name: Optional[str]):
    """One LM step via implicit-Schur CG (block-Jacobi preconditioned).
    Returns (dpose [C,6], dpoint [P,3])."""
    S_apply, precond, b, back_substitute = _schur_system(
        problem, A, B, r, lm_lambda, axis_name
    )

    # CG on S x = b
    x0 = jnp.zeros_like(b)
    r0 = b - S_apply(x0)
    z0 = precond(r0)

    def cg_body(i, state):
        x, rr, z, p, rz = state
        Sp = S_apply(p)
        denom = jnp.sum(p * Sp)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = precond(rr)
        rz_new = jnp.sum(rr * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1e-12, rz)
        p = z + beta * p
        return x, rr, z, p, rz_new

    x, *_ = lax.fori_loop(0, cg_iters, cg_body, (x0, r0, z0, z0, jnp.sum(r0 * z0)))
    dpose = x
    return dpose, back_substitute(dpose)


@partial(jax.jit, static_argnames=("cg_iters", "use_precond", "fix_first_cam"))
def cg_convergence(
    problem: BAProblem,
    cg_iters: int = 30,
    lm_lambda0: float = 1e-3,
    use_precond: bool = True,
    fix_first_cam: bool = True,
) -> jax.Array:
    """Diagnostic: relative CG residual norms ``‖b − S·x_k‖ / ‖b‖`` for
    k = 0..cg_iters on the FIRST LM step's Schur system — the
    "iters-to-1e-6" evidence behind the default ``cg_iters`` (BASELINE.md
    config 5). ``use_precond=False`` runs plain CG for comparison."""
    r, A, B = _jacobian_blocks(problem, problem.poses, problem.points)
    if fix_first_cam:
        A = A * (problem.cam_idx != 0).astype(A.dtype)[:, None, None]
    S_apply, precond, b, _ = _schur_system(
        problem, A, B, r, jnp.float32(lm_lambda0), None
    )
    if not use_precond:
        precond = lambda x: x  # noqa: E731
    bnorm = jnp.sqrt(jnp.sum(b * b))

    x0 = jnp.zeros_like(b)
    r0 = b - S_apply(x0)
    z0 = precond(r0)
    hist0 = jnp.zeros((cg_iters + 1,)).at[0].set(jnp.sqrt(jnp.sum(r0 * r0)))

    def cg_body(i, state):
        x, rr, z, p, rz, hist = state
        Sp = S_apply(p)
        denom = jnp.sum(p * Sp)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = precond(rr)
        rz_new = jnp.sum(rr * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1e-12, rz)
        p = z + beta * p
        hist = hist.at[i + 1].set(jnp.sqrt(jnp.sum(rr * rr)))
        return x, rr, z, p, rz_new, hist

    *_, hist = lax.fori_loop(
        0, cg_iters, cg_body, (x0, r0, z0, z0, jnp.sum(r0 * z0), hist0)
    )
    return hist / jnp.maximum(bnorm, 1e-30)


def _rho(s2, loss: str, delta: float):
    """Per-observation robust cost from the squared weighted residual norm
    ``s2 = ||w·r||²``. ``l2`` is the plain squared norm (the historical
    objective, bit-identical); ``huber`` is quadratic to ``delta`` then
    linear; ``cauchy`` saturates hard outliers."""
    if loss == "l2":
        return s2
    s = jnp.sqrt(jnp.maximum(s2, 0.0))
    if loss == "huber":
        return jnp.where(s <= delta, s2, 2.0 * delta * s - delta * delta)
    if loss == "cauchy":
        return delta * delta * jnp.log1p(s2 / (delta * delta))
    raise ValueError(f"loss must be 'l2', 'huber' or 'cauchy', got {loss!r}")


def _irls_problem(problem, poses, points, loss: str, delta: float):
    """The IRLS-reweighted problem for one Gauss-Newton step of the robust
    objective Σ ρ(||w·rᵢ||): per-obs weight scaled by √ω, ω = ρ'(s)/(2s)
    (Triggs et al., "Bundle Adjustment — A Modern Synthesis" §4.3)."""
    if loss == "l2":
        return problem
    rw = residuals(problem, poses, points)
    s = jnp.sqrt(jnp.sum(rw * rw, axis=-1) + 1e-12)
    if loss == "huber":
        omega = jnp.minimum(1.0, delta / s)
    elif loss == "cauchy":
        omega = 1.0 / (1.0 + (s / delta) ** 2)
    else:
        raise ValueError(f"loss must be 'l2', 'huber' or 'cauchy', got {loss!r}")
    return problem._replace(weight=problem.weight * jnp.sqrt(omega))


def _cost(problem, poses, points, loss: str = "l2", delta: float = 4.0):
    r = residuals(problem, poses, points)
    wsum = jnp.maximum(jnp.sum(problem.weight), 1.0)
    if loss == "l2":  # keep the historical reduction order (bit-identical)
        return jnp.sum(r * r) / wsum
    return jnp.sum(_rho(jnp.sum(r * r, axis=-1), loss, delta)) / wsum


@partial(
    jax.jit, static_argnames=("iters", "cg_iters", "fix_first_cam", "loss")
)
def solve(
    problem: BAProblem,
    iters: int = 10,
    cg_iters: int = 10,
    lm_lambda0: float = 1e-3,
    fix_first_cam: bool = True,
    loss: str = "l2",
    loss_delta: float = 4.0,
) -> BAState:
    """Levenberg–Marquardt loop (single device). Gauge freedom is fixed by
    freezing camera 0 when ``fix_first_cam``.

    ``loss``: robust per-observation cost — ``"l2"`` (default, the plain
    reprojection objective), ``"huber"`` or ``"cauchy"`` with scale
    ``loss_delta`` (pixels of weighted residual). Robust modes run IRLS:
    each LM step reweights observations by √(ρ'(s)/2s) of the *current*
    residual norm, so gross outliers stop dragging the solution
    (tests/test_fusion_ba.py::test_robust_losses_reject_outliers)."""

    def lm_body(i, state):
        poses, points, lm, _ = state
        eff = _irls_problem(problem, poses, points, loss, loss_delta)
        r, A, B = _jacobian_blocks(eff, poses, points)
        if fix_first_cam:
            A = A * (problem.cam_idx != 0).astype(A.dtype)[:, None, None]
        dpose, dpoint = _schur_solve(eff, A, B, r, lm, cg_iters, None)
        if fix_first_cam:
            dpose = dpose.at[0].set(0.0)
        new_poses = poses + dpose
        new_points = points + dpoint
        c_old = _cost(problem, poses, points, loss, loss_delta)
        c_new = _cost(problem, new_poses, new_points, loss, loss_delta)
        accept = c_new < c_old
        lm = jnp.where(accept, jnp.maximum(lm * 0.5, 1e-7), jnp.minimum(lm * 4.0, 1e3))
        poses = jnp.where(accept, new_poses, poses)
        points = jnp.where(accept, new_points, points)
        return poses, points, lm, jnp.where(accept, c_new, c_old)

    init = (
        problem.poses,
        problem.points,
        jnp.float32(lm_lambda0),
        _cost(problem, problem.poses, problem.points, loss, loss_delta),
    )
    poses, points, lm, cost = lax.fori_loop(0, iters, lm_body, init)
    return BAState(poses=poses, points=points, cost=cost, lm_lambda=lm)


@partial(
    jax.jit,
    static_argnames=("mesh", "iters", "cg_iters", "fix_first_cam", "loss"),
)
def solve_sharded(
    problem: BAProblem,
    mesh: Mesh,
    iters: int = 10,
    cg_iters: int = 10,
    lm_lambda0: float = 1e-3,
    fix_first_cam: bool = True,
    loss: str = "l2",
    loss_delta: float = 4.0,
) -> BAState:
    """Distributed LM: observations shard over the mesh ``data`` axis; poses and
    points replicate; every reduction is a ``psum`` collective. Identical math
    to :func:`solve` (tested equal on the fake-device mesh), including the
    robust ``loss`` modes (IRLS weights are per-observation and shard-local)."""
    n = problem.uv.shape[0]
    ndata = mesh.shape["data"]
    if n % ndata != 0:
        raise ValueError(f"N={n} observations not divisible by data axis {ndata}")

    obs_spec = P("data")
    in_specs = BAProblem(
        poses=P(), points=P(), intrinsics=P(),
        cam_idx=obs_spec, pt_idx=obs_spec, uv=P("data", None), weight=obs_spec,
    )

    def shard_fn(prob: BAProblem):
        def cost_of(ps, xs):
            rr = residuals(prob, ps, xs)
            if loss == "l2":  # historical reduction order (bit-identical)
                s = lax.psum(jnp.sum(rr * rr), "data")
            else:
                s = lax.psum(
                    jnp.sum(_rho(jnp.sum(rr * rr, axis=-1), loss, loss_delta)),
                    "data",
                )
            w = lax.psum(jnp.sum(prob.weight), "data")
            return s / jnp.maximum(w, 1.0)

        def lm_body(i, state):
            poses, points, lm, _ = state
            eff = _irls_problem(prob, poses, points, loss, loss_delta)
            r, A, B = _jacobian_blocks(eff, poses, points)
            if fix_first_cam:
                A = A * (prob.cam_idx != 0).astype(A.dtype)[:, None, None]
            dpose, dpoint = _schur_solve(eff, A, B, r, lm, cg_iters, "data")
            if fix_first_cam:
                dpose = dpose.at[0].set(0.0)
            new_poses = poses + dpose
            new_points = points + dpoint

            c_old = cost_of(poses, points)
            c_new = cost_of(new_poses, new_points)
            accept = c_new < c_old
            lm = jnp.where(accept, jnp.maximum(lm * 0.5, 1e-7), jnp.minimum(lm * 4.0, 1e3))
            poses = jnp.where(accept, new_poses, poses)
            points = jnp.where(accept, new_points, points)
            return poses, points, lm, jnp.where(accept, c_new, c_old)

        init = (
            prob.poses,
            prob.points,
            jnp.float32(lm_lambda0),
            cost_of(prob.poses, prob.points),
        )
        poses, points, lm, cost = lax.fori_loop(0, iters, lm_body, init)
        return BAState(poses=poses, points=points, cost=cost, lm_lambda=lm)

    out_specs = BAState(poses=P(), points=P(), cost=P(), lm_lambda=P())
    fn = shard_map(shard_fn, mesh=mesh, in_specs=(in_specs,), out_specs=out_specs)
    return fn(problem)


def synthetic_problem(n_cams: int, n_pts: int, n_obs: int, seed: int = 0,
                      perturb: float = 0.01) -> BAProblem:
    """A rig of ``n_cams`` cameras along x observing ``n_pts`` points
    (``n_obs`` observations, split evenly over the cameras, points drawn at
    random), with exact pixels and poses perturbed by ``perturb``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    intr = jnp.asarray([500.0, 500.0, 640.0, 360.0])
    pts = jnp.asarray(rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32))
    pts = pts.at[:, 2].add(10.0)
    poses = jnp.asarray(
        np.stack([
            np.concatenate([rng.normal(0, 0.02, 3), [0.2 * c, 0.0, 0.0]])
            for c in range(n_cams)
        ]).astype(np.float32)
    )
    ci = jnp.asarray(np.repeat(np.arange(n_cams), n_obs // n_cams), jnp.int32)
    pi = jnp.asarray(rng.integers(0, n_pts, ci.shape[0]).astype(np.int32))
    uv = geometry.project(geometry.transform(poses[ci], pts[pi]), intr)
    return BAProblem(
        poses=poses + jnp.asarray(rng.normal(0, perturb, poses.shape).astype(np.float32)),
        points=pts,
        intrinsics=intr,
        cam_idx=ci,
        pt_idx=pi,
        uv=uv,
        weight=jnp.ones(ci.shape[0], jnp.float32),
    )
