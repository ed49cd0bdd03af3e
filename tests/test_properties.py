"""Property-based parity tests (hypothesis; SURVEY.md §4 "property tests for
the quirk edge cases"). Shapes are FIXED inside each property (only contents
vary) so jit caches one compile per test; randomness explores the content
space including the degenerate corners the quirks live in (constant planes,
gray mask values, saturated channels).
"""

import os

import numpy as np
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

from stepth.ops import kmeans, mask as mask_ops
from stepth.oracle import kmeans as oracle_kmeans
from stepth.ops import resize as resize_ops
from stepth.oracle import resize as oracle_resize
from stepth.match import parity
from stepth.oracle import subdivision as oracle_sub

# STEPTH_HYP_EXAMPLES=300 (say) runs a deep fuzz; default stays CI-fast
_N = int(os.environ.get("STEPTH_HYP_EXAMPLES", "15"))
_SET = dict(max_examples=_N, deadline=None)

u8 = st.integers(0, 255)


def u8_arr(shape):
    return hnp.arrays(np.uint8, shape, elements=u8)


# ---------------------------------------------------------------------------
# depth_split (reference src/depth_image.rs:162-218, quirk Q5 guarded)
# ---------------------------------------------------------------------------


@settings(**_SET)
@given(depth=u8_arr((8, 12)), zones=st.integers(2, 5))
def test_depth_split_matches_oracle(depth, zones):
    got = kmeans.depth_split(depth, zones)
    exp = oracle_kmeans.depth_split_oracle(depth, zones)
    assert got == exp, (got, exp)


@settings(**_SET)
@given(lo=u8, span=st.integers(0, 4), zones=st.integers(2, 5))
def test_depth_split_narrow_range(lo, span, zones):
    """max - min < zones - 1: the reference's step_by(0) panic corner (Q5);
    the guarded behavior must still agree between JAX and oracle."""
    hi = min(lo + span, 255)
    depth = np.linspace(lo, hi, 24, dtype=np.float64).astype(np.uint8)
    depth = depth.reshape(4, 6)
    got = kmeans.depth_split(depth, zones)
    exp = oracle_kmeans.depth_split_oracle(depth, zones)
    assert got == exp, (got, exp)


# ---------------------------------------------------------------------------
# Mask algebra under quirk Q6 (truth = exact equality with 255; NOT is the
# bitwise 255-complement, so gray values stay gray)
# ---------------------------------------------------------------------------


@settings(**_SET)
@given(a=u8_arr((10, 14)), b=u8_arr((10, 14)))
def test_mask_algebra_matches_numpy_twin(a, b):
    T = np.uint8(255)
    and_np = np.where((a == T) & (b == T), 255, 0).astype(np.uint8)
    or_np = np.where((a == T) | (b == T), 255, 0).astype(np.uint8)
    not_np = (T - a).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(mask_ops.mask_and(a, b)), and_np)
    np.testing.assert_array_equal(np.asarray(mask_ops.mask_or(a, b)), or_np)
    np.testing.assert_array_equal(np.asarray(mask_ops.mask_not(a)), not_np)
    # commutativity + involution
    np.testing.assert_array_equal(
        np.asarray(mask_ops.mask_and(a, b)), np.asarray(mask_ops.mask_and(b, a))
    )
    np.testing.assert_array_equal(
        np.asarray(mask_ops.mask_not(mask_ops.mask_not(a))), a
    )


@settings(**_SET)
@given(img=u8_arr((10, 14, 4)), m=u8_arr((10, 14)))
def test_apply_and_highlight_match_numpy_twin(img, m):
    # apply: zero where mask == 0 EXACTLY; any nonzero (incl. gray) keeps
    keep = (m != 0)[..., None]
    apply_np = np.where(keep, img, np.uint8(0))
    np.testing.assert_array_equal(np.asarray(mask_ops.apply(img, m)), apply_np)
    # highlight: r*2 clamped, g/2, b/2 where TRUE exactly
    t = (m == 255)[..., None]
    hi = np.stack(
        [
            np.minimum(img[..., 0].astype(np.int32) * 2, 255).astype(np.uint8),
            (img[..., 1] // 2).astype(np.uint8),
            (img[..., 2] // 2).astype(np.uint8),
            img[..., 3],
        ],
        axis=-1,
    )
    hl_np = np.where(t, hi, img)
    np.testing.assert_array_equal(np.asarray(mask_ops.highlight(img, m)), hl_np)


# ---------------------------------------------------------------------------
# Q15 Gaussian resample parity with the image-rs 0.23 oracle
# ---------------------------------------------------------------------------


@settings(**_SET)
@given(img=u8_arr((11, 17)))
def test_resample_matches_oracle(img):
    got = np.asarray(resize_ops.resample_exact(jnp.asarray(img), 7, 9, "gaussian"))
    exp = oracle_resize.resample_exact_np(img, 7, 9, "gaussian")
    np.testing.assert_array_equal(got, exp)


@settings(**_SET)
@given(img=u8_arr((6, 9)))
def test_resample_upscale_matches_oracle(img):
    got = np.asarray(
        resize_ops.resample_exact(jnp.asarray(img), 13, 20, "gaussian")
    )
    exp = oracle_resize.resample_exact_np(img, 13, 20, "gaussian")
    np.testing.assert_array_equal(got, exp)


# ---------------------------------------------------------------------------
# disage-equivalent subdivision parity (inferred contract, docs/SEMANTICS.md §2)
# ---------------------------------------------------------------------------


@settings(max_examples=max(10, _N // 2), deadline=None)
@given(
    img=u8_arr((16, 20, 3)),
    prec=st.integers(1, 80),
    min_s=st.integers(2, 4),
    max_s=st.integers(5, 8),
)
def test_subdivision_matches_oracle(img, prec, min_s, max_s):
    p = np.array([prec, prec, prec], np.int32)
    got = parity.subdivide(img, p, min_splits=min_s, max_splits=max_s)
    exp = oracle_sub.subdivide(img, p, min_splits=min_s, max_splits=max_s)
    np.testing.assert_array_equal(np.asarray(got.level), exp.level)
    np.testing.assert_array_equal(np.asarray(got.value), exp.value.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(got.seed_x), exp.seed_x)
    np.testing.assert_array_equal(np.asarray(got.seed_y), exp.seed_y)


def test_depth_split_merged_empty_cluster_regression():
    """Regression (hypothesis counterexample): an emptied cluster's mean (0)
    collides with an existing center NON-adjacently in slot order; without a
    sort before the adjacent-dedupe the duplicate survives and the reference's
    HashMap merge semantics are violated."""
    depth = np.full((8, 12), 11, np.uint8)
    depth[0, 0] = 27
    depth[0, 1] = 0
    depth[0, 2] = 5
    got = kmeans.depth_split(depth, 4)
    exp = oracle_kmeans.depth_split_oracle(depth, 4)
    assert got == exp == [(0, 5), (11, 11), (27, 27)]


# ---------------------------------------------------------------------------
# Photometric normalization (reference src/operations.rs:3-80) + adjustments
# ---------------------------------------------------------------------------


@settings(**_SET)
@given(
    a=hnp.arrays(np.uint16, (6, 9), elements=st.integers(0, 65535)),
    b=hnp.arrays(np.uint16, (6, 9), elements=st.integers(1, 65535)),
    percent=st.floats(0.0, 0.5),
)
def test_luma16_normalization_matches_reference_twin(a, b, percent):
    """Independent recomputation of the reference's integer-floor means, f64
    gain, truncating u16 cast, and the no-op tolerance window."""
    from stepth.ops import photometric

    got = photometric.normalize_brightness_luma16_exact(a, b, percent)
    fbr = np.float64(int(a.sum(dtype=np.uint64)) // a.size)
    sbr = np.float64(int(b.sum(dtype=np.uint64)) // b.size)
    with np.errstate(divide="ignore", invalid="ignore"):
        gain = sbr / fbr
    if abs(1.0 - gain) < percent:
        exp = a.copy()
    else:
        x = a.astype(np.float64) * gain
        # Rust `as u16`: truncate, saturate, NaN -> 0
        exp = np.where(
            np.isnan(x), 0.0, np.clip(np.trunc(x), 0.0, 65535.0)
        ).astype(np.uint16)
    np.testing.assert_array_equal(got, exp)


@settings(**_SET)
@given(img=u8_arr((7, 9, 4)), value=st.integers(-300, 300))
def test_brighten_matches_numpy_twin(img, value):
    from stepth.ops import adjust

    got = np.asarray(adjust.brighten(img, value))
    rgb = np.clip(img[..., :3].astype(np.int64) + value, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got[..., :3], rgb)
    np.testing.assert_array_equal(got[..., 3], img[..., 3])  # alpha untouched


@settings(**_SET)
@given(img=u8_arr((7, 9, 4)), c=st.floats(-99.0, 100.0))
def test_contrast_matches_numpy_twin(img, c):
    from stepth.ops import adjust

    got = np.asarray(adjust.contrast(img, np.float32(c)))
    percent = np.float32(((100.0 + np.float32(c)) / 100.0) ** 2)
    v = img[..., :3].astype(np.float32) / 255.0
    d = ((v - 0.5) * percent + 0.5) * 255.0
    exp = np.clip(d, 0.0, 255.0).astype(np.uint8)
    # XLA fuses (v-0.5)*p+0.5 into an FMA; at exact truncation boundaries the
    # extra rounding step in the numpy twin can flip the floor by one level
    diff = np.abs(got[..., :3].astype(np.int32) - exp.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    np.testing.assert_array_equal(got[..., 3], img[..., 3])
