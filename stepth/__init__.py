"""stepth — a stereo-depth and mapping engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
library nikilark/stepth (see SURVEY.md): depth-from-stereo block matching,
depth-map analytics and segmentation, mask algebra and masked adjustments, and
stereo photometric normalization — designed as pure functions over arrays
with an exact NumPy oracle anchoring parity — plus the greenfield extensions:
hierarchical and semi-global cost-volume matching with a Pallas refine kernel
for NVIDIA GPUs, spatial tile sharding with halo exchange, temporal video ops,
and multi-frame fusion with distributed Schur-complement bundle adjustment.

Layer map (SURVEY.md §7):
  core/      frames (DepthFrame/MaskFrame pytrees) + image I/O
  oracle/    exact NumPy reference semantics (parity anchor)
  native/    C++ host engine (subdivision + ring search, ctypes)
  ops/       single-device ops: mask algebra, k-means, resize, photometric,
             temporal, rectification
  match/     depth engines: parity, dense, SGM, pyramid + refine kernel
  parallel/  mesh + shard_map tile sharding with ppermute halos
  fusion/    SE(3), depth fusion, pose graph, distributed Schur BA
  models/    configured estimators (StereoModel, flagship)
  utils/     tracing, metrics, checkpoint, scenes, compile cache
"""

from stepth import config
from stepth.core.frame import MASK_FALSE, MASK_TRUE, DepthFrame, MaskFrame

__version__ = "0.5.0"

__all__ = [
    "DepthFrame",
    "MaskFrame",
    "MASK_TRUE",
    "MASK_FALSE",
    "config",
    "__version__",
]
