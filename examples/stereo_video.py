"""Batched stereo video over a sharded mesh with temporal post-processing
(BASELINE.md config 4). Uses synthetic frames; swap in real decoded frames for
production. Run on any backend (CPU works via the virtual mesh):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/stereo_video.py
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from stepth.config import MatchConfig
from stepth.ops import temporal
from stepth.parallel import mesh as mesh_mod, sharded
from stepth.match import dense

T, H, W, SHIFT = 8, 64, 128, 6
rng = np.random.default_rng(0)
tex = rng.uniform(0, 255, (T, H, W + SHIFT)).astype(np.float32)
lefts = jnp.asarray(tex[:, :, :W])
rights = jnp.asarray(tex[:, :, SHIFT:])

n = len(jax.devices())
mesh = mesh_mod.make_mesh(data=min(4, n), tile=max(1, n // min(4, n)))
cfg = MatchConfig(num_disparities=16, window=9)

disp = sharded.match_batch_sharded(lefts, rights, cfg, mesh)  # [T, H, W]
depth = jax.vmap(lambda d: dense.disparity_to_depth_u8(d, 16))(disp)

smoothed = temporal.temporal_median_depth(depth, window=3)
moving = temporal.motion_mask(depth.astype(jnp.float32), threshold=8.0)

print("disparity median:", float(jnp.median(disp)))
print("moving fraction:", float((moving == 255).mean()))

# Sequential-clip fast path: non-keyframe frames skip the coarse pyramid and
# run only the full-resolution refine seeded by the previous frame's
# disparity.
from stepth.config import PyramidConfig
from stepth.models import StereoModel

model = StereoModel(
    backend="hierarchical",
    match=MatchConfig(num_disparities=16, window=9),
    pyramid=PyramidConfig(levels=2, coarsest_disparities=8),
)
res = model.video(keyframe_interval=4)(lefts, rights)
print("temporal-video disparity median:", float(jnp.median(res.disparity)))
