"""Command-line interface.

The reference ships no binary (SURVEY.md §1: library only); this CLI is a
convenience wrapper over the same public API a library user calls.

    python -m stepth depth MAIN ADD OUT         # reference-parity depth
    python -m stepth depth MAIN ADD OUT --backend native
    python -m stepth stereo LEFT RIGHT OUT      # dense fast path
    python -m stepth video 'l/*.png' 'r/*.png' OUTDIR   # depth stream
    python -m stepth foreground MAIN ADD OUT    # README foreground flow
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _cmd_depth(args) -> int:
    from stepth.core import io

    main = io.open_rgb(args.main)
    add = io.open_rgb(args.additional)
    prec = (args.precision,) * 3
    if args.backend == "native":
        from stepth import native

        depth = native.depth_from_additional(main, add, prec)
    elif args.backend == "oracle":
        from stepth.oracle import pipeline

        depth = pipeline.depth_from_additional_oracle(main, add, prec)
    else:
        from stepth.match import parity

        depth = np.asarray(parity.depth_from_additional(main, add, prec))
    io.save(args.out, depth)
    print(f"wrote {args.out} ({depth.shape[1]}x{depth.shape[0]})")
    return 0


def _cmd_stereo(args) -> int:
    from stepth.core import io
    from stepth.match import dense
    from stepth.models import StereoModel
    from stepth.config import MatchConfig

    left = io.open_rgb(args.left)
    right = io.open_rgb(args.right)
    model = StereoModel(
        backend=args.backend,
        match=MatchConfig(num_disparities=args.disparities, window=args.window,
                          cost=args.cost),
        lr_check=args.lr_check,
    )
    res = model(left, right)
    depth = np.asarray(dense.disparity_to_depth_u8(res.disparity, args.disparities))
    io.save(args.out, depth)
    print(f"wrote {args.out} ({depth.shape[1]}x{depth.shape[0]})")
    return 0


def _cmd_foreground(args) -> int:
    from stepth import DepthFrame
    from stepth.core import io

    frame = DepthFrame.open(args.main).open_depth_from_additional(
        args.additional, (args.precision,) * 3
    )
    out = frame.invert_depth().select_foreground().apply_mask()
    out.save(args.out)  # quirk Q7: saves the masked image, like the reference
    print(f"wrote {args.out}")
    return 0


def _cmd_video(args) -> int:
    """Stereo video serving: frame streams in, a depth stream out.

    Left/right frames come from globs (sorted) or directories; decode +
    host staging rides :class:`stepth.core.loader.PrefetchLoader`
    worker threads, and matching runs chunk-at-a-time through
    ``StereoModel.video`` — the temporally-seeded path (one dispatch per
    chunk; non-keyframe frames skip the coarse pyramid, seeded by the
    previous frame's disparity). Chunk boundaries restart at a keyframe.
    ``--shard-tiles N`` runs the row-tile-sharded temporal twin over an
    N-device mesh instead."""
    import glob as globmod
    import os

    import jax.numpy as jnp

    from stepth.config import MatchConfig, PyramidConfig
    from stepth.core import io
    from stepth.core.loader import PrefetchLoader
    from stepth.match import dense
    from stepth.models import StereoModel

    def expand(pat):
        if os.path.isdir(pat):
            names = sorted(
                os.path.join(pat, n)
                for n in os.listdir(pat)
                if n.lower().endswith((".png", ".jpg", ".jpeg"))
            )
        else:
            names = sorted(globmod.glob(pat))
        if not names:
            raise SystemExit(f"no frames match {pat!r}")
        return names

    lefts = expand(args.left)
    rights = expand(args.right)
    if len(lefts) != len(rights):
        raise SystemExit(
            f"frame count mismatch: {len(lefts)} left vs {len(rights)} right"
        )
    os.makedirs(args.out, exist_ok=True)

    match = MatchConfig(
        num_disparities=args.disparities, window=args.window, cost=args.cost
    )
    pyr = PyramidConfig(levels=args.levels, coarsest_disparities=args.coarsest)
    if args.coarsest << (args.levels - 1) < args.disparities:
        raise SystemExit(
            f"coarsest*2^(levels-1) = {args.coarsest << (args.levels - 1)} "
            f"< disparities {args.disparities}: raise --coarsest or --levels"
        )
    model = StereoModel(
        backend=args.backend, match=match, pyramid=pyr, lr_check=args.lr_check
    )

    if args.shard_tiles:
        from stepth.parallel import mesh as mesh_mod, sharded

        mesh = mesh_mod.make_mesh(data=1, tile=args.shard_tiles)
        import jax

        run = jax.jit(lambda ls, rs: sharded.match_temporal_sharded(  # noqa: E731
            ls, rs, match, pyr, mesh,
            keyframe_interval=args.keyframe_interval, lr_check=args.lr_check,
            coarse_backend=model.coarse_backend, sgm=model.sgm,
        ))
    else:
        import jax

        # one trace per distinct clip length (the full chunks share one)
        run = jax.jit(model.video(keyframe_interval=args.keyframe_interval))

    def load_pair(i):
        return io.open_rgb(lefts[i]), io.open_rgb(rights[i])

    loader = PrefetchLoader(
        range(len(lefts)), load_pair, num_threads=args.threads,
        buffer=2 * args.chunk,
    )
    it = iter(loader)
    n_done = 0
    chunk_l, chunk_r = [], []

    def flush():
        nonlocal n_done
        if not chunk_l:
            return
        ls = jnp.asarray(np.stack(chunk_l).astype(np.float32))
        rs = jnp.asarray(np.stack(chunk_r).astype(np.float32))
        res = run(ls, rs)
        disp = np.asarray(res.disparity)
        valid = np.asarray(res.valid)
        for t in range(disp.shape[0]):
            i = n_done + t
            if args.format == "png":
                d8 = np.asarray(
                    dense.disparity_to_depth_u8(
                        jnp.asarray(disp[t]), args.disparities
                    )
                )
                io.save(os.path.join(args.out, f"depth_{i:05d}.png"), d8)
            else:
                np.savez(
                    os.path.join(args.out, f"depth_{i:05d}.npz"),
                    disparity=disp[t], valid=valid[t],
                )
        n_done += disp.shape[0]
        chunk_l.clear()
        chunk_r.clear()

    for l_img, r_img in it:
        chunk_l.append(l_img)
        chunk_r.append(r_img)
        if len(chunk_l) == args.chunk:
            flush()
    flush()
    print(f"wrote {n_done} depth frames to {args.out} ({args.format})")
    return 0


def main(argv=None) -> int:
    from stepth.utils.cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="stepth", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("depth", help="reference-parity depth from an additional view")
    d.add_argument("main")
    d.add_argument("additional")
    d.add_argument("out")
    d.add_argument("--precision", type=int, default=36)
    d.add_argument("--backend", choices=["jax", "native", "oracle"], default="jax")
    d.set_defaults(fn=_cmd_depth)

    s = sub.add_parser("stereo", help="dense rectified-stereo disparity")
    s.add_argument("left")
    s.add_argument("right")
    s.add_argument("out")
    s.add_argument("--disparities", type=int, default=64)
    s.add_argument("--window", type=int, default=9)
    s.add_argument("--cost", choices=["sad", "ssd", "census"], default="sad",
                   help="census is the exposure-robust production cost")
    s.add_argument("--lr-check", action="store_true", dest="lr_check",
                   help="flag occlusions via the left-right consistency "
                   "check (pyramid backends: the final refine level's "
                   "right view; others switch via the cost volume)")
    s.add_argument(
        "--backend",
        choices=["dense", "hierarchical", "hierarchical-sgm", "sgm"],
        default="dense",
    )
    s.set_defaults(fn=_cmd_stereo)

    v = sub.add_parser(
        "video",
        help="stereo video -> depth stream (temporally-seeded serving path)",
    )
    v.add_argument("left", help="glob or directory of left frames")
    v.add_argument("right", help="glob or directory of right frames")
    v.add_argument("out", help="output directory")
    v.add_argument("--backend",
                   choices=["hierarchical", "hierarchical-sgm"],
                   default="hierarchical")
    v.add_argument("--disparities", type=int, default=128)
    v.add_argument("--window", type=int, default=9)
    v.add_argument("--cost", choices=["sad", "ssd", "census"], default="sad",
                   help="census is the exposure-robust production cost")
    v.add_argument("--lr-check", action="store_true", dest="lr_check")
    v.add_argument("--levels", type=int, default=4)
    v.add_argument("--coarsest", type=int, default=16,
                   help="coarsest-level disparity range")
    v.add_argument("--keyframe-interval", type=int, default=8,
                   dest="keyframe_interval")
    v.add_argument("--chunk", type=int, default=8,
                   help="frames per dispatch (chunk boundaries restart at a "
                   "keyframe)")
    v.add_argument("--threads", type=int, default=4,
                   help="decode/prefetch worker threads")
    v.add_argument("--format", choices=["png", "npz"], default="png",
                   help="png: u8 depth frames; npz: f32 disparity + validity")
    v.add_argument("--shard-tiles", type=int, default=0, dest="shard_tiles",
                   help="row-tile-shard each frame over this many devices")
    v.set_defaults(fn=_cmd_video)

    f = sub.add_parser("foreground", help="README foreground-extraction flow")
    f.add_argument("main")
    f.add_argument("additional")
    f.add_argument("out")
    f.add_argument("--precision", type=int, default=36)
    f.set_defaults(fn=_cmd_foreground)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
