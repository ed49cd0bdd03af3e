"""CLI smoke tests and utils.debug tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from stepth import cli
from stepth.core import io
from stepth.utils import debug


@pytest.fixture
def small_pair(tmp_path, rng):
    main = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    add = np.roll(main, 3, axis=1)
    mp, ap = str(tmp_path / "m.png"), str(tmp_path / "a.png")
    io.save(mp, main)
    io.save(ap, add)
    return mp, ap


def test_cli_depth_native(small_pair, tmp_path):
    mp, ap = small_pair
    out = str(tmp_path / "d.png")
    assert cli.main(["depth", mp, ap, out, "--backend", "native"]) == 0
    assert io.open_luma(out).shape == (24, 32)


def test_cli_depth_oracle(small_pair, tmp_path):
    mp, ap = small_pair
    out = str(tmp_path / "d2.png")
    assert cli.main(["depth", mp, ap, out, "--backend", "oracle"]) == 0


def test_cli_stereo(small_pair, tmp_path):
    mp, ap = small_pair
    out = str(tmp_path / "s.png")
    assert cli.main(["stereo", mp, ap, out, "--disparities", "8", "--window", "5"]) == 0
    assert io.open_luma(out).shape == (24, 32)


def test_checked_catches_nan():
    def f(x):
        return jnp.log(x)  # NaN for negative input

    g = debug.checked(f)
    np.testing.assert_allclose(np.asarray(g(jnp.asarray([1.0]))), [0.0], atol=1e-6)
    from jax.experimental import checkify

    with pytest.raises(checkify.JaxRuntimeError):
        g(jnp.asarray([-1.0]))


def test_assert_finite():
    debug.assert_finite({"a": np.ones(3)})
    with pytest.raises(AssertionError):
        debug.assert_finite({"a": np.array([1.0, np.nan])})


def test_cli_video(tmp_path, rng):
    """`python -m stepth video` (VERDICT r4 #8): globs in, a depth
    stream out, through the temporally-seeded serving path; npz format
    carries f32 disparity + validity. Chunking must cover a partial tail."""
    h, w, shift, n = 64, 96, 3, 5
    ldir, rdir = tmp_path / "l", tmp_path / "r"
    ldir.mkdir(), rdir.mkdir()
    base = rng.integers(0, 255, (h, w + shift, 3), dtype=np.uint8)
    for i in range(n):
        f = np.clip(base.astype(np.int16) + (i % 3), 0, 255).astype(np.uint8)
        io.save(str(ldir / f"{i:03d}.png"), f[:, :w])
        io.save(str(rdir / f"{i:03d}.png"), f[:, shift : shift + w])
    out = tmp_path / "depth"
    rc = cli.main([
        "video", str(ldir), str(rdir), str(out),
        "--disparities", "8", "--window", "5", "--levels", "2",
        "--coarsest", "4", "--chunk", "3", "--keyframe-interval", "2",
        "--format", "npz",
    ])
    assert rc == 0
    files = sorted(out.iterdir())
    assert len(files) == n, files
    data = np.load(files[0])
    assert data["disparity"].shape == (h, w)
    interior = data["disparity"][8:-8, 16:-16]
    assert abs(np.median(interior) - shift) <= 1.0, np.median(interior)


def test_cli_video_frame_count_mismatch(tmp_path, rng):
    ldir, rdir = tmp_path / "l2", tmp_path / "r2"
    ldir.mkdir(), rdir.mkdir()
    img = rng.integers(0, 255, (16, 32, 3), dtype=np.uint8)
    io.save(str(ldir / "0.png"), img)
    io.save(str(ldir / "1.png"), img)
    io.save(str(rdir / "0.png"), img)
    with pytest.raises(SystemExit, match="mismatch"):
        cli.main(["video", str(ldir), str(rdir), str(tmp_path / "o")])


def test_cli_video_sharded(tmp_path, rng):
    """--shard-tiles N routes through the row-tile-sharded temporal twin on
    the fake device mesh."""
    h, w, shift, n = 64, 96, 3, 3
    ldir, rdir = tmp_path / "ls", tmp_path / "rs"
    ldir.mkdir(), rdir.mkdir()
    base = rng.integers(0, 255, (h, w + shift, 3), dtype=np.uint8)
    for i in range(n):
        io.save(str(ldir / f"{i}.png"), base[:, :w])
        io.save(str(rdir / f"{i}.png"), base[:, shift : shift + w])
    out = tmp_path / "ds"
    rc = cli.main([
        "video", str(ldir), str(rdir), str(out),
        "--disparities", "8", "--window", "5", "--levels", "2",
        "--coarsest", "4", "--chunk", "3", "--format", "npz",
        "--shard-tiles", "2",
    ])
    assert rc == 0
    files = sorted(out.iterdir())
    assert len(files) == n
    dd = np.load(files[-1])["disparity"]
    assert abs(np.median(dd[8:-8, 16:-16]) - shift) <= 1.0
