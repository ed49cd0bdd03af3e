"""Run the stereo engine's main path once on an NVIDIA GPU and check it.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded paths only

One GPU, in order:
  1. device: JAX must find a GPU (there is no CPU fallback); prints the card
  2. the refine kernel against its plain jnp reference at 1080p levels 0/1
  3. production stereo (hierarchical-sgm, census, LR check) at 1080×1920 on
     the box scene: accuracy bounds, then ms/frame over 20 warm frames
  4. the other backends at 1080p against ground truth
  5. video (keyframe interval 8, 16 frames) and the batched path
  6. the reference flow (DepthFrame → depth) against the native engine
  7. bundle adjustment at 32 cams / 4,096 points / 65,536 observations

Four GPUs: the production configuration row-sharded over 4 cards (1024 of
the 1080 rows: 1080 rows do not split into 4 whole-level shards), the
data-parallel batch of 8 1080p frames over 4 cards, and the sharded bundle
adjuster, each against its one-card result.

Any failed check exits non-zero. The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

H, W, D = 1080, 1920, 128


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def check(cond, what):
    print(f"  {'ok  ' if cond else 'FAIL'} {what}", flush=True)
    if not cond:
        raise SystemExit(f"check failed: {what}")


def timed_ms(fn, *args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    t = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t) / reps * 1e3


def production_model():
    from stepth.config import MatchConfig, PyramidConfig
    from stepth.models import StereoModel

    return StereoModel(
        backend="hierarchical-sgm",
        match=MatchConfig(num_disparities=D, window=9, cost="census"),
        pyramid=PyramidConfig(levels=4, coarsest_disparities=16),
        lr_check=True,
    )


def _plain_cost(left_g, right_g, y, x, s, window, squared):
    """Box-aggregated sad/ssd cost at left pixels (y, x) for integer
    disparities s (numpy, float64, edge-clamped samples): the tie test of
    :func:`compare`."""
    h, w = left_g.shape
    r = window // 2
    tot = np.zeros(len(y), np.float64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            yy, xx = y + dy, x + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yc, xc = np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)
            xr = xx - s
            d = left_g[yc, xc] - right_g[yc, np.clip(xr, 0, w - 1)]
            c = d * d if squared else np.abs(d)
            c = np.where((xr < 0) | (xr >= w), 1e6, c)
            tot += np.where(ok, c, 0.0)
    return tot


def compare(left_g, right_g, prior, cfg, radius, max_base, tile_rows=64,
            lr=False, max_windows=16):
    """Run the compiled refine kernel and the ``jnp`` reference on one level
    and compare them; returns a dict of counts with ``ok``.

    Census costs are integer Hamming sums, exact in f32, so the disparities
    must be bit-equal. On float gray (sad, ssd) the two may sum in another
    order (the GPU compiler can fuse ``d·d + acc`` into one FMA), so at most
    1e-4 of the pixels may differ by more than 0.01 px, and only where the
    two integer winners differ and their costs tie to within 1e-5 relative.
    """
    import jax

    from stepth.match import pyramid

    run, out = {}, {"ok": True}
    for impl in ("triton", "reference"):
        fn = jax.jit(
            lambda l, r, p, impl=impl: pyramid.refine_level(
                l, r, p, cfg, radius, max_base, tile_rows, lr=lr,
                max_windows=max_windows, impl=impl,
            )
        )
        t = time.perf_counter()
        compiled = fn.lower(left_g, right_g, prior).compile()
        out[f"{impl}_compile_s"] = time.perf_counter() - t
        run[impl] = compiled(left_g, right_g, prior)
    k, ref = run["triton"], run["reference"]
    pairs = [("disp", k[0], ref[0]), ("disp_r", k[1], ref[1])] if lr else [
        ("disp", k, ref)
    ]
    lg, rg = np.asarray(left_g, np.float64), np.asarray(right_g, np.float64)
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        neq = int(np.sum(a != b))
        out[f"{name}_neq"] = neq
        if not (np.isfinite(a).all() and a.shape == b.shape):
            out["ok"] = False
        if cfg.cost == "census":
            out["ok"] &= neq == 0
            continue
        far = np.abs(a - b) > 0.01
        out[f"{name}_far"] = int(far.sum())
        if far.mean() > 1e-4:
            out["ok"] = False
            continue
        y, x = np.nonzero(far)
        sa, sb = np.round(a[far]).astype(int), np.round(b[far]).astype(int)
        if name == "disp_r":  # costR(u, s) = costL(u + s, s)
            ca = _plain_cost(lg, rg, y, x + sa, sa, cfg.window, cfg.cost == "ssd")
            cb = _plain_cost(lg, rg, y, x + sb, sb, cfg.window, cfg.cost == "ssd")
        else:
            ca = _plain_cost(lg, rg, y, x, sa, cfg.window, cfg.cost == "ssd")
            cb = _plain_cost(lg, rg, y, x, sb, cfg.window, cfg.cost == "ssd")
        # one winner (same integer) leaves no tie to explain a subpixel gap
        ties = (sa != sb) & (
            np.abs(ca - cb) <= 1e-5 * np.maximum(np.maximum(ca, cb), 1e-30)
        )
        out[f"{name}_untied"] = int((~ties).sum())
        out["ok"] &= bool(ties.all())
    return out


def phase_refine(sc):
    """The compiled kernel against the reference at the tolerance of
    :func:`compare`."""
    import jax.numpy as jnp

    from stepth.config import MatchConfig
    from stepth.match import dense, pyramid

    lg, rg = dense.grayscale(jnp.asarray(sc.left)), dense.grayscale(jnp.asarray(sc.right))
    for lvl in (0, 1):
        if lvl:
            lg, rg = pyramid.downsample2(lg), pyramid.downsample2(rg)
        h, w = lg.shape
        f = 2 ** (lvl + 1)
        prior = pyramid.upsample2_disparity(
            jnp.asarray(sc.disparity[::f, ::f] / f, jnp.float32), h, w
        )
        for cost in ("sad", "ssd", "census"):
            cfg = MatchConfig(num_disparities=D, window=9, cost=cost)
            for lr in (False, True):
                r = compare(lg, rg, prior, cfg, 2, D >> lvl, 64, lr, 16)
                check(r.pop("ok"), f"refine level {lvl} ({h}x{w}) {cost} lr={lr}: {r}")


def phase_production(sc, name):
    import jax

    from stepth.utils import scenes

    model = production_model()
    fn = jax.jit(lambda l, r: model(l, r))
    res = fn(sc.left, sc.right)
    d, v = np.asarray(res.disparity), np.asarray(res.valid)
    check(d.shape == (H, W) and np.isfinite(d).all(), f"production output {d.shape} finite")
    st = scenes.evaluate_disparity(sc, d, v)
    check(st["bad3"] < 0.10, f"production bad3 {st['bad3']:.4f} < 0.10")
    check(st["occ_flagged"] > 0.7, f"production occ_flagged {st['occ_flagged']:.4f} > 0.7")
    ms = timed_ms(lambda l, r: fn(l, r).disparity, sc.left, sc.right)
    print(f"  production hierarchical-sgm census+LR 1080x1920: {ms:.3f} ms/frame "
          f"over 20 warm frames on {name} (information only)", flush=True)


def phase_backends(sc, sc64):
    import jax

    from stepth.config import MatchConfig, PyramidConfig
    from stepth.match.sgm import SGMConfig
    from stepth.models import StereoModel
    from stepth.utils import scenes

    pyr = PyramidConfig(levels=4, coarsest_disparities=16)
    sad = MatchConfig(num_disparities=D, window=9, cost="sad")
    runs = (
        ("hierarchical", StereoModel(backend="hierarchical", match=sad, pyramid=pyr), sc, 0.10),
        ("hierarchical-sgm sad", StereoModel(backend="hierarchical-sgm", match=sad,
                                             pyramid=pyr), sc, 0.10),
        ("sgm D=64 4 dirs", StereoModel(backend="sgm", match=MatchConfig(
            num_disparities=64, window=9), sgm=SGMConfig(directions=4)), sc64, 0.10),
        ("dense", StereoModel(backend="dense", match=MatchConfig(
            num_disparities=D, window=9)), sc, 0.05),
    )
    for name, model, scene, bad3 in runs:
        res = jax.jit(lambda l, r, m=model: m(l, r))(scene.left, scene.right)
        d = np.asarray(res.disparity)
        st = scenes.evaluate_disparity(scene, d, np.asarray(res.valid))
        check(d.shape == (H, W) and np.isfinite(d).all()
              and st["bad3"] < bad3,
              f"{name}: bad3 {st['bad3']:.4f} < {bad3} (epe {st['epe']:.3f})")


def drifting_clip(n, shifts, seed=0):
    """Constant-texture clip whose planted disparity is ``shifts[t]``."""
    from scipy.ndimage import uniform_filter

    rng = np.random.default_rng(seed)
    pad = max(shifts) + 2
    tex = uniform_filter(rng.uniform(0, 255, (H, W + pad)).astype(np.float32), 3)
    lefts = np.stack([tex[:, :W]] * n)
    rights = np.stack([tex[:, s : s + W] for s in shifts])
    return lefts, rights


def phase_video():
    import jax
    import jax.numpy as jnp

    model = production_model()
    shifts = [20 + (t if t < 8 else 16 - t) for t in range(16)]  # ±1 px/frame
    lefts, rights = drifting_clip(16, shifts)
    res = jax.jit(model.video(keyframe_interval=8))(jnp.asarray(lefts), jnp.asarray(rights))
    d = np.asarray(res.disparity)
    check(d.shape == (16, H, W) and np.isfinite(d).all(), "video output finite")
    meds = [float(np.median(d[t, 16:-16, 64:-16])) for t in range(16)]
    err = max(abs(m - s) for m, s in zip(meds, shifts))
    check(err <= 0.75, f"video frames track the planted drift (max |median - shift| {err:.3f})")

    lb, rb = jnp.asarray(lefts[:4]), jnp.asarray(rights[:4])
    out = jax.jit(model.batched())(lb, rb)
    single = jax.jit(lambda l, r: model(l, r))
    same = all(
        np.array_equal(np.asarray(out.disparity[i]), np.asarray(single(lb[i], rb[i]).disparity))
        for i in range(4)
    )
    check(same, "batched() on 4 frames equals per-frame calls")


def phase_reference_flow():
    from scipy.ndimage import uniform_filter

    from stepth import native
    from stepth.core.frame import DepthFrame

    rng = np.random.default_rng(3)
    base = uniform_filter(rng.uniform(0, 255, (400, 612, 3)), (5, 5, 1))
    main = base[:, :600].astype(np.uint8)
    add = base[:, 12:612].astype(np.uint8)
    got = np.asarray(DepthFrame.from_array(main).load_depth_from_additional(add, (36,) * 3).depth)
    want = native.depth_from_additional(main, add, (36, 36, 36))
    check(got.shape == (400, 600) and np.array_equal(got, want),
          "reference flow depth == native engine (600x400)")


def phase_ba():
    from stepth.fusion import ba

    prob = ba.synthetic_problem(32, 4096, 65536)
    st = ba.solve(prob, iters=10, cg_iters=10)
    cost = float(st.cost)
    check(np.isfinite(cost) and cost < 1e-3, f"BA 32/4096/65536 cost {cost:.3e} < 1e-3")


def four_cards(sc, rows=1024):
    import jax
    import jax.numpy as jnp

    from stepth.fusion import ba
    from stepth.parallel import sharded
    from stepth.parallel.mesh import make_mesh

    model = production_model()
    # row sharding needs 4 shards of whole coarse levels and whole 64-row
    # refine tiles: 1024 rows split so, 1080 rows do not (270-row shards)
    left, right = jnp.asarray(sc.left[:rows]), jnp.asarray(sc.right[:rows])
    one = jax.jit(lambda l, r: model(l, r))(left, right)
    four = jax.jit(model.sharded(make_mesh(1, 4)))(left, right)
    check(np.array_equal(np.asarray(one.disparity), np.asarray(four.disparity))
          and np.array_equal(np.asarray(one.valid), np.asarray(four.valid)),
          f"production config row-sharded over 4 cards == one card {left.shape}")

    # 8 distinct full 1080p frames: the scene rolled down by 120·i rows
    full_l, full_r = jnp.asarray(sc.left), jnp.asarray(sc.right)
    lefts = jnp.stack([jnp.roll(full_l, 120 * i, axis=0) for i in range(8)])
    rights = jnp.stack([jnp.roll(full_r, 120 * i, axis=0) for i in range(8)])
    batch = sharded.match_batch_hierarchical_sharded(
        lefts, rights, model.match, model.pyramid, make_mesh(4, 1), lr_check=True,
        coarse_backend="sgm", sgm=model.sgm,
    )
    single = jax.jit(lambda l, r: model(l, r))
    same = all(
        np.array_equal(np.asarray(batch.disparity[i]),
                       np.asarray(single(lefts[i], rights[i]).disparity))
        for i in range(8)
    )
    check(same, f"data-parallel batch of 8 {tuple(lefts.shape[1:3])} frames over 4 cards "
                "== per-frame one card")

    prob = ba.synthetic_problem(32, 4096, 65536)
    st1 = ba.solve(prob, iters=10, cg_iters=10)
    st4 = ba.solve_sharded(prob, make_mesh(4, 1), iters=10, cg_iters=10)
    c1, c4 = float(st1.cost), float(st4.cost)
    dp = float(jnp.max(jnp.abs(st1.poses - st4.poses)))
    check(c4 < 1e-3 and abs(c4 - c1) <= 1e-3 * max(c1, 1e-12) + 1e-9 and dp < 1e-3,
          f"BA sharded over 4 cards: cost {c4:.3e} vs one card {c1:.3e}, "
          f"max pose diff {dp:.2e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the sharded paths on four GPUs instead")
    args = ap.parse_args()

    import jax

    from stepth.utils.cache import enable_compile_cache
    from stepth.utils import scenes

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke needs a GPU; JAX found {dev.platform!r}")
    n_dev = len(jax.devices())
    want = 4 if args.four_cards else 1
    if n_dev < want:
        sys.exit(f"needs {want} GPUs, found {n_dev}")
    enable_compile_cache()
    name = card()
    print(name, flush=True)

    t0 = time.perf_counter()
    sc = scenes.make_scene("box", H, W, D)
    phases = [("four cards", lambda: four_cards(sc))] if args.four_cards else [
        ("refine kernel vs reference", lambda: phase_refine(sc)),
        ("production stereo", lambda: phase_production(sc, name)),
        ("other backends", lambda: phase_backends(sc, scenes.make_scene("box", H, W, 64))),
        ("video and batched", phase_video),
        ("reference flow", phase_reference_flow),
        ("bundle adjustment", phase_ba),
    ]
    for title, run in phases:
        print(f"[{time.perf_counter() - t0:7.1f}s] {title}", flush=True)
        run()
    print(f"[{time.perf_counter() - t0:7.1f}s] done", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_dev,
    }}), flush=True)


if __name__ == "__main__":
    main()
