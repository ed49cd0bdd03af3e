"""Native host engine bindings (ctypes).

Builds the committed ``engine.cc`` on demand with the system C++ toolchain
(g++, -O3) into a cached shared object under ``.native_build/`` in the checkout
(or ``$STEPTH_NATIVE_CACHE``) and exposes the reference pipeline's hot loops — the
native equivalent of the reference's Rust core (SURVEY.md §2.2). Falls back
gracefully: ``available()`` is False when no toolchain is present, and callers
(bench, tests) use the NumPy oracle instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "engine.cc")
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


_CHECKOUT = os.path.dirname(os.path.dirname(_HERE))


def _so_path() -> str:
    cache = os.environ.get(
        "STEPTH_NATIVE_CACHE", os.path.join(_CHECKOUT, ".native_build")
    )
    return os.path.join(cache, "stepth_native_engine.so")


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    so = _so_path()
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"  # concurrent builders each rename in
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
            _SRC, "-o", tmp,
        ]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:  # no toolchain
            _build_error = str(e)
            return None
        if proc.returncode != 0:
            _build_error = proc.stderr[-2000:]
            return None
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.stepth_native_version.restype = ctypes.c_int
    lib.stepth_raw_disparity.restype = ctypes.c_int
    lib.stepth_raw_disparity.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.stepth_sgm_disparity.restype = ctypes.c_int
    lib.stepth_sgm_disparity.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.stepth_hier_disparity.restype = ctypes.c_int
    lib.stepth_hier_disparity.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    with _LOCK:
        if _lib is None and _build_error is None:
            _lib = _build()
        return _lib


def available() -> bool:
    return _get() is not None


def build_error() -> Optional[str]:
    _get()
    return _build_error


def raw_disparity(
    main_rgb: np.ndarray,
    add_rgb: np.ndarray,
    precision,
    min_splits: int = 16,
    max_splits: Optional[int] = None,
    max_radius: int = 255,
    n_threads: int = 8,
) -> np.ndarray:
    """Native twin of ``oracle.pipeline.raw_disparity_map`` (pre-normalization)."""
    lib = _get()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    main_rgb = np.ascontiguousarray(main_rgb, dtype=np.uint8)
    add_rgb = np.ascontiguousarray(add_rgb, dtype=np.uint8)
    h, w, _ = main_rgb.shape
    ah, aw, _ = add_rgb.shape
    prec = np.ascontiguousarray(np.asarray(precision, dtype=np.int32).reshape(3))
    out = np.empty((h, w), dtype=np.uint8)
    rc = lib.stepth_raw_disparity(
        main_rgb.ctypes.data, add_rgb.ctypes.data,
        h, w, ah, aw,
        prec.ctypes.data,
        int(min_splits), -1 if max_splits is None else int(max_splits),
        int(max_radius), int(n_threads),
        out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"stepth_raw_disparity failed rc={rc}")
    return out


def depth_from_additional(
    main_rgb: np.ndarray,
    add_rgb: np.ndarray,
    precision,
    min_splits: int = 16,
    max_splits: Optional[int] = None,
    max_radius: int = 255,
    n_threads: int = 8,
) -> np.ndarray:
    """Full native pipeline: C++ subdivision + ring search, then the shared
    exact normalization/resample (oracle semantics, quirk Q3 guarded)."""
    from stepth.oracle.resize import resample_exact_np

    raw = raw_disparity(
        main_rgb, add_rgb, precision, min_splits, max_splits, max_radius, n_threads
    )
    m = int(raw.max())
    norm = (
        np.zeros_like(raw)
        if m == 0
        else ((raw.astype(np.uint64) * 255) // m).astype(np.uint8)
    )
    return resample_exact_np(norm, raw.shape[0], raw.shape[1], "gaussian")


def hier_disparity(
    left: np.ndarray,
    right: np.ndarray,
    levels: int = 4,
    coarsest_disparities: int = 16,
    refine_radius: int = 4,
    window: int = 9,
    n_threads: int = 8,
) -> np.ndarray:
    """Multithreaded C++ hierarchical matcher — the same coarse-to-fine
    pipeline bench.py measures on the accelerator, serving as the honest CPU
    baseline
    (the reference would have been compiled Rust + 8-way rayon,
    reference src/depth_image.rs:111-123, Cargo.toml:12)."""
    lib = _get()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    left = np.ascontiguousarray(left, dtype=np.float32)
    right = np.ascontiguousarray(right, dtype=np.float32)
    h, w = left.shape
    out = np.empty((h, w), dtype=np.float32)
    rc = lib.stepth_hier_disparity(
        left.ctypes.data, right.ctypes.data, h, w,
        int(levels), int(coarsest_disparities), int(refine_radius),
        int(window), int(n_threads),
        out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"stepth_hier_disparity failed rc={rc}")
    return out


def sgm_disparity(
    left: np.ndarray,
    right: np.ndarray,
    num_disparities: int = 64,
    window: int = 5,
    p1: float = 8.0,
    p2: float = 32.0,
    directions: int = 4,
    lr_threshold: Optional[float] = 1.0,
    subpixel: bool = True,
    n_threads: int = 8,
):
    """Multithreaded C++ SGM — the accuracy backend's honest CPU baseline
    (same pipeline as stepth/match/sgm.py::match_pair_sgm). On u8-valued
    gray inputs the outputs are bit-identical to the XLA backend (every
    intermediate is an exact small integer in f32; tests/test_native.py).
    Returns (disparity f32[H,W], valid bool[H,W])."""
    lib = _get()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")
    left = np.ascontiguousarray(left, dtype=np.float32)
    right = np.ascontiguousarray(right, dtype=np.float32)
    h, w = left.shape
    disp = np.empty((h, w), dtype=np.float32)
    valid = np.empty((h, w), dtype=np.uint8)
    rc = lib.stepth_sgm_disparity(
        left.ctypes.data, right.ctypes.data, h, w,
        int(num_disparities), int(window),
        float(p1), float(p2), int(directions),
        -1.0 if lr_threshold is None else float(lr_threshold),
        1 if subpixel else 0, int(n_threads),
        disp.ctypes.data, valid.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"stepth_sgm_disparity failed rc={rc}")
    return disp, valid.astype(bool)
