"""Pose-graph optimization over SE(3) (greenfield; BASELINE.md config 5).

Nodes are keyframe poses [M, 6]; edges carry relative-pose measurements
Z_ij ≈ T_i⁻¹ ∘ T_j with scalar weights. Residual per edge is the 6-vector of
(Z_ij⁻¹ ∘ (T_i⁻¹ ∘ T_j)) — zero iff the measurement is satisfied. Solved by
damped Gauss–Newton with the full (small, dense) normal system: pose graphs are
tiny next to the dense stereo workload, so a dense ``jnp.linalg.solve`` on one
chip is the right tool; the heavy distributed machinery lives in
:mod:`stepth.fusion.ba`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from stepth.fusion import geometry as geo


class PoseGraph(NamedTuple):
    poses: jax.Array  # f32[M, 6]
    edge_i: jax.Array  # i32[E]
    edge_j: jax.Array  # i32[E]
    measurements: jax.Array  # f32[E, 6] relative poses Z_ij
    weights: jax.Array  # f32[E]


def edge_residuals(graph: PoseGraph, poses: jax.Array) -> jax.Array:
    """Weighted tangent-space residuals f32[E, 6]."""
    rel = geo.relative(poses[graph.edge_i], poses[graph.edge_j])
    err = geo.compose(geo.inverse(graph.measurements), rel)
    return err * graph.weights[:, None]


@partial(jax.jit, static_argnames=("iters", "fix_first", "loss"))
def optimize(
    graph: PoseGraph,
    iters: int = 10,
    damping: float = 1e-4,
    fix_first: bool = True,
    loss: str = "l2",
    loss_delta: float = 0.1,
) -> jax.Array:
    """Damped Gauss–Newton; returns optimized poses f32[M, 6]. Node 0 is frozen
    when ``fix_first`` (gauge).

    ``loss``: ``"l2"`` (default), ``"huber"`` or ``"cauchy"`` with tangent-space
    scale ``loss_delta`` — IRLS edge reweighting per GN step, the standard
    defense against FALSE LOOP CLOSURES: a wrong closure edge under l2 warps
    the whole trajectory; under a robust loss its influence is bounded
    (huber) or redescends to ~0 (cauchy)
    (tests/test_fusion_geometry.py::test_posegraph_robust_to_false_closure)."""
    m = graph.poses.shape[0]
    dim = m * 6

    def res_flat(pose_flat, g):
        return edge_residuals(g, pose_flat.reshape(m, 6)).reshape(-1)

    def gn_body(k, poses):
        if loss == "l2":
            g = graph
        else:
            rw = edge_residuals(graph, poses)  # weighted [E, 6]
            s = jnp.sqrt(jnp.sum(rw * rw, axis=-1) + 1e-12)
            if loss == "huber":
                omega = jnp.minimum(1.0, loss_delta / s)
            elif loss == "cauchy":
                omega = 1.0 / (1.0 + (s / loss_delta) ** 2)
            else:
                raise ValueError(
                    f"loss must be 'l2', 'huber' or 'cauchy', got {loss!r}"
                )
            g = graph._replace(weights=graph.weights * jnp.sqrt(omega))
        flat = poses.reshape(-1)
        r = res_flat(flat, g)
        J = jax.jacfwd(lambda p: res_flat(p, g))(flat)  # [E*6, M*6]
        if fix_first:
            mask = jnp.concatenate(
                [jnp.zeros(6, J.dtype), jnp.ones(dim - 6, J.dtype)]
            )
            J = J * mask[None, :]
        # precision=HIGHEST: default-precision `@` may run in a reduced-
        # precision matrix unit (TF32 on a GPU); the normal equations need
        # full f32.
        H = jnp.matmul(J.T, J, precision=lax.Precision.HIGHEST) + damping * jnp.eye(
            dim, dtype=J.dtype
        )
        g = jnp.matmul(J.T, r, precision=lax.Precision.HIGHEST)
        step = jnp.linalg.solve(H, g)
        if fix_first:
            step = step.at[:6].set(0.0)
        return (flat - step).reshape(m, 6)

    return lax.fori_loop(0, iters, gn_body, graph.poses)


def total_error(graph: PoseGraph, poses: jax.Array) -> jax.Array:
    r = edge_residuals(graph, poses)
    return jnp.sum(r * r)
