"""Multi-frame mapping: SE(3) geometry, multi-keyframe depth fusion, pose-graph
optimization, and distributed Schur-complement bundle adjustment (greenfield;
BASELINE.md config 5)."""

from stepth.fusion import (  # noqa: F401
    ba,
    depthfusion,
    geometry,
    posegraph,
    resumable,
)
