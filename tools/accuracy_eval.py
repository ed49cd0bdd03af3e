"""Per-backend accuracy table on the procedural ground-truth scenes.

The honest accuracy harness (round-3 mandate): every matcher backend on every
scene family in stepth.utils.scenes, reporting EPE / bad1 / bad3 on
non-occluded pixels, the same triple restricted to the disparity-edge band,
the validity-mask density, and how well the matcher flags occlusions.

    JAX_PLATFORMS=cpu python tools/accuracy_eval.py --size small
    python tools/accuracy_eval.py --size vga          # on the GPU
    python tools/accuracy_eval.py --size 1080p --backends hierarchical,dense

Prints a markdown table (docs/ACCURACY_*.md are generated from such runs)
and exits non-zero if any backend crashes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SIZES = {
    # h, w, dmax, levels, coarsest
    "small": (160, 256, 32, 3, 8),
    "vga": (480, 640, 64, 3, 16),
    "1080p": (1088, 1920, 128, 4, 16),
}

DEFAULT_BACKENDS = (
    "dense",
    "hierarchical",
    "hierarchical-sgm",
    "sgm",
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=SIZES, default="small")
    ap.add_argument("--backends", default=",".join(DEFAULT_BACKENDS))
    ap.add_argument("--scenes", default=None,
                    help="comma list; default: all scene families")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--window", type=int, default=9)
    ap.add_argument("--texture", choices=("procedural", "photo"),
                    default="procedural",
                    help="'photo' textures every layer with crops of the "
                    "reference's bundled photographs (real image "
                    "statistics, exact GT)")
    ap.add_argument("--jpeg", type=int, default=None,
                    help="JPEG-recompress the right view at this quality "
                    "(camera-stream degradation)")
    ap.add_argument("--cost", default="sad", choices=("sad", "ssd", "census"))
    ap.add_argument("--lr", action=argparse.BooleanOptionalAction, default=True,
                    help="LR consistency: non-pyramid backends switch via "
                    "MatchConfig.lr_threshold (on by default); --lr also "
                    "passes lr_check=True to the pyramid backends (their "
                    "full-resolution right view)")
    args = ap.parse_args()

    import jax  # noqa: E402 (after argparse so --help is fast)

    from stepth.config import MatchConfig, PyramidConfig
    from stepth.utils.cache import enable_compile_cache
    from stepth.models import StereoModel
    from stepth.utils import scenes

    enable_compile_cache()
    h, w, dmax, levels, coarsest = SIZES[args.size]
    match = MatchConfig(num_disparities=dmax, window=args.window,
                        cost=args.cost)
    # radius/windows left at the PyramidConfig defaults so the table always
    # scores what the framework ships
    pyr = PyramidConfig(levels=levels, coarsest_disparities=coarsest)
    assert coarsest * 2 ** (levels - 1) >= dmax

    scene_names = (
        tuple(args.scenes.split(",")) if args.scenes else scenes.SCENE_NAMES
    )
    backends = tuple(args.backends.split(","))

    print(f"platform={jax.default_backend()} size={args.size} "
          f"({h}x{w}, D={dmax}) window={args.window} cost={args.cost} "
          f"pyramid={levels}lv/{coarsest}c texture={args.texture}"
          + (f" jpeg={args.jpeg}" if args.jpeg else ""))
    hdr = (f"| {'scene':12s} | {'backend':20s} | {'EPE':>6s} | {'bad1':>6s} "
           f"| {'bad3':>6s} | {'edge3':>6s} | {'dens':>5s} | {'occ✓':>5s} |")
    print(hdr)
    print("|" + "-" * (len(hdr) - 2) + "|")

    failures = 0
    for name in scene_names:
        sc = scenes.make_scene(name, h, w, dmax, seed=args.seed,
                               texture=args.texture, jpeg_right=args.jpeg)
        for backend in backends:
            t0 = time.time()
            try:
                lr_check = args.lr and backend.startswith("hierarchical")
                model = StereoModel(backend=backend, match=match, pyramid=pyr,
                                    lr_check=lr_check)
                res = model(sc.left, sc.right)
                disp = np.asarray(res.disparity)
                valid = np.asarray(res.valid)
            except Exception as e:  # pragma: no cover - harness robustness
                print(f"| {name:12s} | {backend:20s} | FAILED: {e!r}")
                failures += 1
                continue
            st = scenes.evaluate_disparity(sc, disp, valid)
            occ = st.get("occ_flagged", float("nan"))
            print(
                f"| {name:12s} | {backend:20s} | {st['epe']:6.3f} "
                f"| {st['bad1']:6.3f} | {st['bad3']:6.3f} "
                f"| {st['edge_bad3']:6.3f} | {st['density']:5.3f} "
                f"| {occ:5.3f} |"
                f"  # {time.time() - t0:.1f}s"
            )
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
