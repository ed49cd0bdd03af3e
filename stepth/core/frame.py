"""Immutable frame containers (pytrees).

Functional recast of the reference's mutable image objects: ``DepthImage``
(reference src/depth_image.rs:7-10) and ``MaskImage`` (src/mask_image.rs:7-10)
become frozen pytrees of u8 arrays; every reference method that mutated ``self``
returns a new frame here. The containers carry no compute — ops live in
``stepth.ops`` / ``stepth.match`` — but expose the reference's full method
surface as thin functional wrappers so a stepth user finds everything in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import numpy as np

from stepth.core import io as _io

MASK_TRUE: int = 255  # reference src/mask_image.rs:3
MASK_FALSE: int = 0  # reference src/mask_image.rs:4


def _hw(arr) -> Tuple[int, int]:
    return int(arr.shape[0]), int(arr.shape[1])


def _frame(cls):
    """Frozen dataclass registered as a pytree (every field is a leaf), with
    ``replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)


@_frame
class DepthFrame:
    """RGBA image + Luma8 depth pair (reference src/depth_image.rs:7-10)."""

    image: jax.Array | np.ndarray  # u8[H, W, 4]
    depth: jax.Array | np.ndarray  # u8[H, W]

    # -- constructors -------------------------------------------------------
    @classmethod
    def open(cls, path) -> "DepthFrame":
        """reference src/depth_image.rs:13-21 (zero depth)."""
        return cls.from_array(_io.open_rgba(path))

    @classmethod
    def from_array(cls, image) -> "DepthFrame":
        """reference ``from_image`` src/depth_image.rs:23-27; accepts RGB or RGBA."""
        image = np.asarray(image, dtype=np.uint8)
        if image.ndim != 3 or image.shape[-1] not in (3, 4):
            raise ValueError(f"expected u8[H,W,3|4] image, got {image.shape}")
        if image.shape[-1] == 3:
            image = _io.rgb_to_rgba(image)
        depth = np.zeros(image.shape[:2], dtype=np.uint8)
        return cls(image=image, depth=depth)

    # -- geometry ------------------------------------------------------------
    @property
    def width(self) -> int:  # src/depth_image.rs:138-140
        return int(self.image.shape[1])

    @property
    def height(self) -> int:  # src/depth_image.rs:142-144
        return int(self.image.shape[0])

    @property
    def dimensions(self) -> Tuple[int, int]:
        """(height, width) — src/depth_image.rs:155-160."""
        return _hw(self.image)

    # -- depth loading -------------------------------------------------------
    def with_depth(self, depth) -> "DepthFrame":
        """Strict size check (reference ``load_depth`` src/depth_image.rs:37-49)."""
        if _hw(depth) != self.dimensions:
            raise ValueError("Sizes don't match")
        return self.replace(depth=depth)

    def open_depth(self, path) -> "DepthFrame":
        """reference src/depth_image.rs:65-74."""
        return self.with_depth(_io.open_luma(path))

    def open_depth_from_additional(self, path, precision, method: str = "parity") -> "DepthFrame":
        """reference src/depth_image.rs:76-89."""
        return self.load_depth_from_additional(_io.open_rgb(path), precision, method)

    def load_depth_from_additional(
        self, add_image, precision, method: str = "parity"
    ) -> "DepthFrame":
        """The core pipeline (reference src/depth_image.rs:91-136).

        ``method``: ``"parity"`` (default — bit-exact reference semantics on
        device), ``"native"`` (C++ host engine, same output), or any
        :class:`stepth.models.StereoModel` backend name (``"dense"``,
        ``"hierarchical"``, ``"hierarchical-sgm"``, ``"sgm"``) for the
        production rectified-stereo path (disparity scaled to u8 depth)."""
        main_rgb = _io.rgba_to_rgb(np.asarray(self.image))
        add_rgb = np.asarray(add_image, dtype=np.uint8)[..., :3]
        if method == "parity":
            from stepth.match import parity

            depth = parity.depth_from_additional(main_rgb, add_rgb, precision=precision)
        elif method == "native":
            from stepth import native

            depth = native.depth_from_additional(main_rgb, add_rgb, precision)
        else:
            from stepth.models import StereoModel

            depth = StereoModel(backend=method).depth_u8(main_rgb, add_rgb)
        return self.with_depth(np.asarray(depth))

    # -- depth utilities (reference parity surface) ---------------------------
    def highlight_depth(self):
        """reference src/depth_image.rs:51-63 → RGBA array."""
        from stepth.ops import depth as depth_ops

        return depth_ops.highlight_depth(self.image, self.depth)

    def invert_depth(self) -> "DepthFrame":
        """reference src/depth_image.rs:225-227."""
        from stepth.ops import depth as depth_ops

        return self.replace(depth=depth_ops.invert(self.depth))

    def depth_split(self, zones: int):
        """reference src/depth_image.rs:162-218 → [(min, max)] per zone."""
        from stepth.ops import kmeans

        return kmeans.depth_split(self.depth, zones)

    def slice(self, lo: Optional[int], hi: Optional[int]) -> "MaskFrame":
        """reference src/depth_image.rs:229-245."""
        from stepth.ops import depth as depth_ops

        mask = depth_ops.slice_mask(self.depth, lo, hi)
        return MaskFrame(image=self.image, mask=mask)

    def select_foreground(self) -> "MaskFrame":
        """reference src/depth_image.rs:220-223."""
        lo, hi = self.depth_split(2)[0]
        return self.slice(lo, hi)

    def resize(self, height: int, width: int) -> "DepthFrame":
        """Gaussian resize of both planes (reference src/depth_image.rs:146-153)."""
        from stepth.ops import resize as resize_ops

        return DepthFrame(
            image=resize_ops.resize_u8(self.image, height, width),
            depth=resize_ops.resize_u8(self.depth, height, width),
        )

    # -- I/O -----------------------------------------------------------------
    def save_depth(self, path) -> None:
        _io.save(path, np.asarray(self.depth))

    def save_image(self, path) -> None:
        _io.save(path, np.asarray(self.image))


@_frame
class MaskFrame:
    """RGBA image + Luma8 boolean mask (reference src/mask_image.rs:7-10)."""

    image: jax.Array | np.ndarray  # u8[H, W, 4]
    mask: jax.Array | np.ndarray  # u8[H, W]; 255 = true, 0 = false

    # -- constructors ----------------------------------------------------------
    @classmethod
    def open(cls, path) -> "MaskFrame":
        """reference src/mask_image.rs:13-15."""
        return cls.from_array(_io.open_rgba(path))

    @classmethod
    def from_array(cls, image) -> "MaskFrame":
        """reference ``from_image`` src/mask_image.rs:17-21 (all-true mask)."""
        image = np.asarray(image, dtype=np.uint8)
        if image.shape[-1] == 3:
            image = _io.rgb_to_rgba(image)
        mask = np.full(image.shape[:2], MASK_TRUE, dtype=np.uint8)
        return cls(image=image, mask=mask)

    # -- geometry --------------------------------------------------------------
    @property
    def width(self) -> int:
        return int(self.image.shape[1])

    @property
    def height(self) -> int:
        return int(self.image.shape[0])

    @property
    def dimensions(self) -> Tuple[int, int]:
        return _hw(self.image)

    # -- mask loading (lenient: quirk Q6, docs/SEMANTICS.md §6) -----------------
    def load_mask(self, mask, rebinarize: bool = False) -> "MaskFrame":
        """reference src/mask_image.rs:31-44: silently Gaussian-resizes on size
        mismatch. ``rebinarize`` (deviation, default off) re-thresholds at 128."""
        from stepth.ops import mask as mask_ops

        return self.replace(mask=mask_ops.conform(mask, self.dimensions, rebinarize))

    def load_mask_from_file(self, path, rebinarize: bool = False) -> "MaskFrame":
        """reference src/mask_image.rs:46-55."""
        return self.load_mask(_io.open_luma(path), rebinarize)

    # -- mask algebra ------------------------------------------------------------
    def mask_and(self, other: "MaskFrame") -> "MaskFrame":
        from stepth.ops import mask as mask_ops

        return self.replace(
            mask=mask_ops.mask_and(self.mask, mask_ops.conform(other.mask, self.dimensions))
        )

    def mask_or(self, other: "MaskFrame") -> "MaskFrame":
        from stepth.ops import mask as mask_ops

        return self.replace(
            mask=mask_ops.mask_or(self.mask, mask_ops.conform(other.mask, self.dimensions))
        )

    def mask_not(self) -> "MaskFrame":
        from stepth.ops import mask as mask_ops

        return self.replace(mask=mask_ops.mask_not(self.mask))

    def mask_copy(self, other: "MaskFrame") -> "MaskFrame":
        """reference src/mask_image.rs:143-145."""
        return self.load_mask(other.mask)

    def mask_reset(self) -> "MaskFrame":
        from stepth.ops import mask as mask_ops

        return self.replace(mask=mask_ops.reset(self.dimensions))

    def apply_mask(self) -> "MaskFrame":
        from stepth.ops import mask as mask_ops

        return self.replace(image=mask_ops.apply(self.image, self.mask))

    def highlight_mask(self):
        from stepth.ops import mask as mask_ops

        return mask_ops.highlight(self.image, self.mask)

    # -- masked image adjustments --------------------------------------------
    def image_replace(self, other: "MaskFrame", start_yx=(0, 0)) -> "MaskFrame":
        from stepth.ops import mask as mask_ops

        return self.replace(
            image=mask_ops.image_replace(self.image, self.mask, other.image, start_yx)
        )

    def image_brightness(self, value: int) -> "MaskFrame":
        from stepth.ops import adjust, mask as mask_ops

        out = adjust.brighten(self.image, value)
        return self.replace(image=mask_ops.image_replace(self.image, self.mask, out, (0, 0)))

    def image_contrast(self, value: float) -> "MaskFrame":
        from stepth.ops import adjust, mask as mask_ops

        out = adjust.contrast(self.image, float(value))
        return self.replace(image=mask_ops.image_replace(self.image, self.mask, out, (0, 0)))

    def image_sharpness(self, value: float) -> "MaskFrame":
        from stepth.ops import adjust, mask as mask_ops

        out = adjust.unsharpen(self.image, float(value), 20)
        return self.replace(image=mask_ops.image_replace(self.image, self.mask, out, (0, 0)))

    def image_blur(self, value: float) -> "MaskFrame":
        from stepth.ops import adjust, mask as mask_ops

        out = adjust.blur(self.image, float(value))
        return self.replace(image=mask_ops.image_replace(self.image, self.mask, out, (0, 0)))

    def resize(self, height: int, width: int) -> "MaskFrame":
        from stepth.ops import resize as resize_ops

        return MaskFrame(
            image=resize_ops.resize_u8(self.image, height, width),
            mask=resize_ops.resize_u8(self.mask, height, width),
        )

    # -- I/O (quirk Q7: save() writes the image, not the mask) -------------------
    def save(self, path) -> None:
        """reference src/mask_image.rs:197-199."""
        _io.save(path, np.asarray(self.image))

    def save_mask(self, path) -> None:
        _io.save(path, np.asarray(self.mask))
