"""Accuracy evaluation: EPE of every matcher backend on synthetic
ground-truth pairs, and cross-backend depth agreement on the reference assets.

    JAX_PLATFORMS=cpu python examples/evaluate.py
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from stepth.config import MatchConfig, PyramidConfig
from stepth.models import StereoModel
from stepth.utils import metrics


def make_pair(rng, h, w, shift):
    tex = rng.uniform(0, 255, (h, w + shift)).astype(np.float32)
    k = np.ones(5) / 5
    for ax in (0, 1):
        tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), ax, tex)
    return tex[:, :w], tex[:, shift:]


rng = np.random.default_rng(0)
shift = 7
left, right = make_pair(rng, 96, 256, shift)
gt = np.full(left.shape, float(shift))

match = MatchConfig(num_disparities=16, window=9)
pyr = PyramidConfig(levels=3, coarsest_disparities=8)

print(f"{'backend':22s} {'EPE':>7s} {'bad1':>7s} {'bad3':>7s}")
for backend in (
    "dense", "hierarchical", "hierarchical-sgm", "sgm",
):
    model = StereoModel(backend=backend, match=match, pyramid=pyr)
    res = model(left, right)
    m = metrics.end_point_error(
        np.asarray(res.disparity)[10:-10, 20:-20], gt[10:-10, 20:-20]
    )
    print(f"{backend:22s} {m['epe']:7.3f} {m['bad1']:7.3f} {m['bad3']:7.3f}")
