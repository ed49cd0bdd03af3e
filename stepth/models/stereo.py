"""Model-level API: configured stereo depth estimators as frozen pytrees.

The reference's "model" is one hard-wired pipeline behind ``DepthImage``
(reference src/depth_image.rs:76-136). Here the matcher family is explicit —
pick a backend, hold its config, call it like a function. All backends share
the :class:`stepth.match.dense.MatchResult` contract.

Backends:
  * ``"dense"``            — exhaustive cost volume + WTA (reference quality)
  * ``"hierarchical"``     — coarse-to-fine pyramid: exhaustive WTA at the
                             coarsest level, tile-window refine above it
                             (large search ranges; the refine levels run the
                             Pallas kernel on a GPU)
  * ``"hierarchical-sgm"`` — the same pyramid with the SGM matcher at the
                             coarsest level (SGM-class robustness on
                             repetitive/low-texture scenes: the coarse volume
                             is 4^(levels−1)× smaller than full-res SGM's)
  * ``"sgm"``              — semi-global matching (scanline-regularized WTA;
                             the accuracy backend for noisy/low-texture pairs)
  * ``"parity"``           — the bit-exact reference-semantics path
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np

from stepth.config import DEFAULT_PRECISION, MatchConfig, PyramidConfig
from stepth.match import dense
from stepth.match.sgm import SGMConfig


@dataclasses.dataclass(frozen=True)
class StereoModel:
    """A configured stereo depth estimator."""

    backend: str = "dense"
    match: MatchConfig = MatchConfig()
    pyramid: PyramidConfig = PyramidConfig()
    sgm: SGMConfig = SGMConfig()  # sgm / hierarchical-sgm only
    precision: Tuple[int, int, int] = DEFAULT_PRECISION  # parity backend only
    # hierarchical / hierarchical-sgm only: the final refine level also
    # returns its right-view disparity and LR-inconsistent pixels are marked
    # invalid (occluded pixels get flagged instead of silently carrying the
    # foreground's disparity). The non-pyramid backends take their LR switch
    # from match.lr_threshold.
    lr_check: bool = False

    def __call__(self, left, right) -> dense.MatchResult:
        if self.backend == "dense":
            return dense.match_pair(left, right, self.match)
        if self.backend in ("hierarchical", "hierarchical-sgm"):
            from stepth.match import pyramid

            return pyramid.match_hierarchical(
                left, right, self.match, self.pyramid, self.coarse_backend, self.sgm,
                self.lr_check,
            )
        if self.backend == "sgm":
            from stepth.match import sgm as sgm_mod

            return sgm_mod.match_pair_sgm(left, right, self.match, self.sgm)
        if self.backend == "parity":
            from stepth.match import parity
            import jax.numpy as jnp

            depth = parity.depth_from_additional(
                np.asarray(left, dtype=np.uint8),
                np.asarray(right, dtype=np.uint8),
                self.precision,
            )
            d = jnp.asarray(depth).astype(jnp.float32)
            return dense.MatchResult(
                disparity=d, valid=jnp.ones(d.shape, bool), cost=jnp.zeros_like(d)
            )
        raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def coarse_backend(self) -> str:
        return "sgm" if self.backend == "hierarchical-sgm" else "wta"

    def depth_u8(self, left, right) -> jax.Array:
        """Disparity scaled to the reference's u8 depth convention."""
        res = self(left, right)
        if self.backend == "parity":
            return res.disparity.astype("uint8")
        return dense.disparity_to_depth_u8(res.disparity, self.match.num_disparities)

    def batched(self):
        """One-dispatch batch path for multi-stream serving: a callable
        mapping stacked pairs ``[B,H,W]`` (or ``[B,H,W,3]``) to a stacked
        :class:`MatchResult`, rolled as ``lax.scan`` inside a single jit.

        Frames run device-sequentially — one 1080p frame already fills the
        device — but the whole batch costs ONE dispatch, so per-frame
        latency is the device throughput rather than throughput + host
        round-trip."""
        if self.backend == "parity":
            raise NotImplementedError("parity backend is host-side; loop it")

        def run(lefts, rights):
            def step(_, lr):
                return None, self(*lr)

            _, out = jax.lax.scan(step, None, (lefts, rights))
            return out

        return run

    def video(self, keyframe_interval: int = 8):
        """Temporally-seeded video path (pyramid backends only): a callable
        mapping stacked clips ``[T,H,W]`` to a stacked :class:`MatchResult`.
        Non-keyframe frames skip the coarse pyramid and run only the
        full-resolution refine seeded by the previous frame's disparity;
        every ``keyframe_interval``-th frame re-runs the full pyramid so fast
        motion and disocclusions self-correct. Use :meth:`batched` for
        independent (non-sequential) frames."""
        from stepth.match import pyramid

        if self.backend not in ("hierarchical", "hierarchical-sgm"):
            raise NotImplementedError(
                f"video() needs a pyramid backend, got {self.backend!r}"
            )
        return lambda lefts, rights: pyramid.match_temporal(
            lefts, rights, self.match, self.pyramid,
            keyframe_interval=keyframe_interval, lr_check=self.lr_check,
            coarse_backend=self.coarse_backend, sgm=self.sgm,
        )

    def sharded(self, mesh):
        """Return a callable running this model row-tile-sharded over ``mesh``."""
        from stepth.parallel import sharded

        if self.backend == "dense":
            return lambda l, r: sharded.match_pair_sharded(l, r, self.match, mesh)
        if self.backend in ("hierarchical", "hierarchical-sgm"):
            return lambda l, r: sharded.match_hierarchical_sharded(
                l, r, self.match, self.pyramid, mesh,
                coarse_backend=self.coarse_backend, sgm=self.sgm,
                lr_check=self.lr_check,
            )
        if self.backend == "sgm":
            from stepth.parallel import sgm_sharded

            return lambda l, r: sgm_sharded.match_pair_sgm_sharded(
                l, r, self.match, self.sgm, mesh
            )
        raise NotImplementedError(f"sharded() unsupported for {self.backend}")


def flagship(num_disparities: int = 128) -> StereoModel:
    """The exhaustive-search configuration: dense cost volume, SAD, LR check."""
    return StereoModel(
        backend="dense",
        match=MatchConfig(
            num_disparities=num_disparities, window=9, cost="sad", lr_threshold=1.0
        ),
    )
