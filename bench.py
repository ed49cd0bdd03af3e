"""Benchmark harness. Prints ONE JSON line:

    {"metric": "stereo frames/s/chip at 1080p", "value": N,
     "unit": "frames/s", "vs_baseline": R, "device": {...}, ...}

``value`` is the steady-state frames/s of the recommended backend on one
device at 1080p: the best of the SAD ``hierarchical`` pyramid (the flagship)
and ``hierarchical-sgm`` (SGM at the coarsest level), both measured in the
same run (:func:`select_headline`). The one line also carries ``edge_fps``
(the flagship on the edge-heavy box scene) and ``production`` (the
documented deployment configuration: hierarchical-sgm, census cost,
full-resolution LR check, on both scenes). ``vs_baseline`` is the speedup
over the multithreaded C++ implementation of the same hierarchical pipeline
(:func:`stepth.native.hier_disparity`, 8 threads), measured in the same run.

Needs an accelerator: on the CPU it exits non-zero without a JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

H, W = 1088, 1920  # 1080p rounded to /32 for clean pyramid levels


def select_headline(partial, flagship_fps):
    """Pick the JSON headline: best of the flagship and the hierarchical-sgm
    secondary row, both measured this run.

    Mutates ``partial``: records ``flagship_fps`` (always, so the flagship
    stays regression-tracked) and ``headline_backend`` (the winner). Returns
    the headline fps. A missing/invalid hier_sgm row falls back to the
    flagship. Unit-pinned by tests/test_bench_headline.py.
    """
    partial.setdefault("flagship_fps", round(float(flagship_fps), 2))
    try:
        hs_fps = float(partial.get("hier_sgm", {}).get("smooth_fps", 0.0))
    except (TypeError, ValueError, AttributeError):
        hs_fps = 0.0
    if hs_fps > flagship_fps:
        partial["headline_backend"] = "hierarchical-sgm"
        return hs_fps
    partial["headline_backend"] = "hierarchical"
    return float(flagship_fps)


def make_pair(h, w, shift=24, seed=0):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 255, size=(h, w + shift)).astype(np.float32)
    k = np.ones(9, np.float32) / 9
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 1, tex)
    tex = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), 0, tex)
    return tex[:, :w], tex[:, shift : shift + w]


def native_baseline_fps(left_np, right_np):
    """Multithreaded C++ hierarchical matcher (8 threads), median of 3; None
    without a C++ toolchain."""
    try:
        from stepth import native

        native.hier_disparity(left_np, right_np)  # build + warm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            native.hier_disparity(left_np, right_np)
            times.append(time.perf_counter() - t0)
        return 1.0 / sorted(times)[1]
    except Exception as e:  # noqa: BLE001 — no toolchain
        print(f"[bench] native C++ baseline unavailable: {e}", file=sys.stderr)
        return None


def frames_per_s(model, left, right, reps=20):
    """Steady-state frames/s of ``model`` on one pair: one warm call, then
    ``reps`` calls ended by ``block_until_ready``."""
    import jax

    fn = jax.jit(lambda l, r: model(l, r).disparity)
    jax.block_until_ready(fn(left, right))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(left, right)
    jax.block_until_ready(out)
    return reps / (time.perf_counter() - t0)


def main():
    import jax
    import jax.numpy as jnp

    from stepth.config import MatchConfig, PyramidConfig
    from stepth.match.sgm import SGMConfig
    from stepth.models import StereoModel
    from stepth.utils import scenes
    from stepth.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py measures an accelerator; JAX found only the CPU")
    enable_compile_cache()

    left_np, right_np = make_pair(H, W)
    baseline_fps = native_baseline_fps(left_np, right_np)
    left, right = jnp.asarray(left_np), jnp.asarray(right_np)
    sc = scenes.make_scene("box", H, W, 128, seed=1)
    le, re_ = jnp.asarray(sc.left), jnp.asarray(sc.right)

    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    sad = MatchConfig(num_disparities=128, window=9, cost="sad")
    census = MatchConfig(num_disparities=128, window=9, cost="census")
    flagship = StereoModel(backend="hierarchical", match=sad, pyramid=pyr)
    hier_sgm = StereoModel(backend="hierarchical-sgm", match=sad, pyramid=pyr,
                           sgm=SGMConfig(directions=4))
    production = StereoModel(backend="hierarchical-sgm", match=census,
                             pyramid=pyr, lr_check=True)

    partial = {}
    fps = frames_per_s(flagship, left, right)
    partial["edge_fps"] = round(frames_per_s(flagship, le, re_), 2)
    partial["hier_sgm"] = {"smooth_fps": round(frames_per_s(hier_sgm, left, right), 2)}
    partial["production"] = {
        "config": "hierarchical-sgm census+lr",
        "smooth_fps": round(frames_per_s(production, left, right), 2),
        "edge_fps": round(frames_per_s(production, le, re_), 2),
    }
    best = select_headline(partial, fps)
    obj = {
        "metric": "stereo frames/s/chip at 1080p",
        "value": round(float(best), 2),
        "unit": "frames/s",
        "vs_baseline": (
            round(float(best / baseline_fps), 1) if baseline_fps else None
        ),
        "baseline_fps": baseline_fps,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **partial,
    }
    print(json.dumps(obj), flush=True)


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    main()
