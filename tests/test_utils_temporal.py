"""Tests for utils (tracing, metrics, checkpoint) and temporal video ops."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from stepth.ops import temporal
from stepth.utils import checkpoint, metrics, tracing


# ---- temporal ops -----------------------------------------------------------

def test_temporal_median_removes_flicker():
    d = np.full((5, 4, 4), 10.0, np.float32)
    d[2] = 90.0  # one-frame glitch
    out = np.asarray(temporal.temporal_median_depth(jnp.asarray(d), 3))
    np.testing.assert_allclose(out, 10.0)


def test_ema_depth_converges():
    d = np.zeros((10, 2, 2), np.float32)
    d[5:] = 100.0
    out = np.asarray(temporal.ema_depth(jnp.asarray(d), alpha=0.5))
    assert out[0].max() == 0.0
    assert 95.0 < out[-1].min() <= 100.0


def test_mask_stabilize_votes():
    m = np.zeros((5, 3, 3), np.uint8)
    m[2] = 255  # single-frame true → flicker, should be removed with min_votes=2
    out = np.asarray(temporal.mask_stabilize(jnp.asarray(m), 3, 2))
    assert (out == 0).all()
    m2 = np.full((5, 3, 3), 255, np.uint8)
    m2[2] = 0  # single-frame false → healed
    out2 = np.asarray(temporal.mask_stabilize(jnp.asarray(m2), 3, 2))
    assert (out2 == 255).all()


def test_mask_and_or_video_gray_is_false():
    a = np.full((2, 2, 2), 255, np.uint8)
    g = np.full((2, 2, 2), 128, np.uint8)  # gray: not TRUE (docs/SEMANTICS §6)
    assert (np.asarray(temporal.mask_and_video(jnp.asarray(a), jnp.asarray(g))) == 0).all()
    assert (np.asarray(temporal.mask_or_video(jnp.asarray(a), jnp.asarray(g))) == 255).all()


def test_motion_mask():
    d = np.zeros((3, 2, 2), np.float32)
    d[1, 0, 0] = 50.0
    out = np.asarray(temporal.motion_mask(jnp.asarray(d), threshold=4.0))
    assert out[0].max() == 0
    assert out[1, 0, 0] == 255 and out[1, 1, 1] == 0
    assert out[2, 0, 0] == 255  # moved back


# ---- metrics ----------------------------------------------------------------

def test_end_point_error():
    gt = np.full((4, 4), 5.0)
    est = gt.copy()
    est[0, 0] = 9.0  # 4px error
    m = metrics.end_point_error(est, gt)
    assert m["bad3"] == pytest.approx(1 / 16)
    assert m["epe"] == pytest.approx(4.0 / 16)


def test_depth_agreement_exact():
    a = np.zeros((3, 3), np.uint8)
    m = metrics.depth_agreement(a, a)
    assert m == {"exact": 1.0, "mean_abs": 0.0, "max_abs": 0}


def test_ate_rmse():
    a = np.zeros((3, 6), np.float32)
    b = a.copy()
    b[:, 3] = 2.0
    assert metrics.ate_rmse(a, b) == pytest.approx(2.0)


# ---- tracing ----------------------------------------------------------------

def test_stage_times_accumulate():
    st = tracing.StageTimes()
    with st.stage("a"):
        pass
    with st.stage("a"):
        pass
    s = st.summary()
    assert s["a"]["count"] == 2
    assert s["a"]["total_s"] >= 0


def test_annotate_decorator_passthrough():
    @tracing.annotate("x")
    def f(v):
        return v + 1

    assert f(1) == 2


@pytest.mark.parametrize("intervals,busy,span", [
    ([], 0, 0),
    ([(10, 20)], 10, 10),
    ([(30, 40), (10, 20)], 20, 30),  # a gap: idle share 1/3
    ([(10, 25), (20, 30), (22, 24)], 20, 20),  # overlaps count once
])
def test_busy_and_span(intervals, busy, span):
    assert tracing.busy_and_span_ns(intervals) == (busy, span)


# ---- checkpoint -------------------------------------------------------------

def test_checkpoint_roundtrip_npz(tmp_path):
    state = {"poses": np.arange(12, dtype=np.float32).reshape(2, 6),
             "cost": np.float32(0.5)}
    p = str(tmp_path / "ck.npz")
    checkpoint.save(p, state, metadata={"round": 1})
    back = checkpoint.restore(p, like=state)
    np.testing.assert_array_equal(back["poses"], state["poses"])
    assert checkpoint.metadata(p) == {"round": 1}


def test_checkpoint_orbax_roundtrip(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    state = {"a": np.ones((3, 2), np.float32), "b": np.int32(7)}
    p = str(tmp_path / "orbax_ck")
    checkpoint.save(p, state, metadata={"k": "v"})
    back = checkpoint.restore(p, like=state)
    np.testing.assert_array_equal(back["a"], state["a"])
