"""Refine kernel against the plain ``jnp`` reference on the GPU.

Checks the compiled Triton kernel against the reference at 1080p refine level
0 (1080×1920, max_base 128) and level 1 (540×960, max_base 64) on the box
scene's prior, times both per level (host clock and profiler device time),
and times the 1080p production pipeline with each implementation.

    python tools/refine_bench.py [--reps 10] [--check-only | --e2e-only] [--out FILE]

Needs a GPU. Prints one JSON object per measurement and, with ``--out``,
writes them all to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stepth.config import MatchConfig, PyramidConfig  # noqa: E402
from chip_smoke import compare  # noqa: E402
from stepth.match import dense, pyramid  # noqa: E402
from stepth.match.sgm import SGMConfig  # noqa: E402
from stepth.utils import scenes, tracing  # noqa: E402
from stepth.utils.cache import enable_compile_cache  # noqa: E402

H, W, D = 1080, 1920, 128
R, NW, TILE = 2, 16, 64


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except OSError:
        return "unknown"


def timed(fn, args, reps):
    out = fn(*args)
    jax.block_until_ready(out)
    t = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t) / reps * 1e3


def traced(fn, args, reps):
    """One traced window of ``reps`` calls: device busy time, the device
    span (first event start to last event end) and the host-clock wall of
    the same window, each per call in ms; the idle share is 1 − busy/span;
    and the top events by device time."""
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        t = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        wall = time.perf_counter() - t
        jax.profiler.stop_trace()
        busy, span, per_name = tracing.device_time_ns(d)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "device_ms": busy / reps / 1e6,
        "device_span_ms": span / reps / 1e6,
        "traced_wall_ms": wall / reps * 1e3,
        "idle_share": 1.0 - busy / span if span else None,
        "top": {k: v / reps / 1e6 for k, v in top},
    }


def level_inputs(sc, lvl):
    lg = dense.grayscale(jnp.asarray(sc.left))
    rg = dense.grayscale(jnp.asarray(sc.right))
    for _ in range(lvl):
        lg, rg = pyramid.downsample2(lg), pyramid.downsample2(rg)
    h, w = lg.shape
    f = 2 ** (lvl + 1)
    coarse = jnp.asarray(sc.disparity[::f, ::f] / f, jnp.float32)
    prior = pyramid.upsample2_disparity(coarse, h, w)
    return lg, rg, prior, D >> lvl


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--check-only", action="store_true",
                    help="compile and compare at level 0, no timing")
    ap.add_argument("--e2e-only", action="store_true",
                    help="only the end-to-end production comparison")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    rows = []

    def emit(row):
        row = {"device": dev.device_kind, "card": card_name, **row}
        print(json.dumps(row), flush=True)
        rows.append(row)

    card_name = card()
    sc = scenes.make_scene("box", H, W, D)
    for lvl in () if args.e2e_only else (0,) if args.check_only else (0, 1):
        lg, rg, prior, mb = level_inputs(sc, lvl)
        for cost in ("sad", "census"):
            cfg = MatchConfig(num_disparities=D, window=9, cost=cost)
            for lr in (False, True):
                cmp = compare(lg, rg, prior, cfg, R, mb, TILE, lr, NW)
                row = dict(phase="check", level=lvl, cost=cost, lr=lr, **cmp)
                for impl in () if args.check_only else ("triton", "reference"):
                    fn = jax.jit(
                        lambda l, r, p, impl=impl: pyramid.refine_level(
                            l, r, p, cfg, R, mb, TILE, lr=lr, max_windows=NW,
                            impl=impl,
                        )
                    )
                    row[f"{impl}_ms"] = timed(fn, (lg, rg, prior), args.reps)
                    tr = traced(fn, (lg, rg, prior), 3)
                    row[f"{impl}_device_ms"] = tr["device_ms"]
                    row[f"{impl}_top"] = tr["top"]
                emit(row)
    if args.check_only:
        return
    # end to end: the production configuration, kernel vs reference in turns
    model_cfg = MatchConfig(num_disparities=D, window=9, cost="census")
    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    left, right = jnp.asarray(sc.left), jnp.asarray(sc.right)
    original = pyramid.refine_impl
    e2e = {}
    for n, impl in enumerate(("triton", "reference", "reference", "triton")):
        pyramid.refine_impl = lambda interpret=False, impl=impl: impl
        jax.clear_caches()
        fn = jax.jit(
            lambda l, r: pyramid.match_hierarchical(
                l, r, model_cfg, pyr, "sgm", SGMConfig(), True
            ).disparity
        )
        e2e.setdefault(f"{impl}_ms", []).append(timed(fn, (left, right), args.reps))
        if n < 2:
            e2e[f"{impl}_trace"] = traced(fn, (left, right), args.reps)
    pyramid.refine_impl = original
    emit(dict(phase="e2e", config="hierarchical-sgm census lr_check 1080p", **e2e))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
