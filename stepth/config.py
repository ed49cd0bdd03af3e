"""Frozen configuration dataclasses.

The reference keeps all tuning as function arguments (SURVEY.md §5): matching
``precision: [u8;3]`` (reference ``src/depth_image.rs:79``), ``zones`` (:162), slice
ranges (:229), and hard-coded constants ``min_splits=16`` / ring ``max=255``
(:102, :119). We keep that spirit — small frozen dataclasses passed explicitly, no
global config files — and add the device-mesh knobs the reference has no analog for.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SubdivisionConfig:
    """disage-equivalent subdivision bounds (reference src/depth_image.rs:101-109).

    ``max_splits`` defaults to ceil(log2(H*W)) at call time when None.
    """

    min_splits: int = 16
    max_splits: Optional[int] = None

    def resolved_max(self, height: int, width: int) -> int:
        if self.max_splits is not None:
            return self.max_splits
        return int(math.ceil(math.log2(float(height * width))))


@dataclasses.dataclass(frozen=True)
class RingSearchConfig:
    """Expanding ring-search bounds (reference src/helpers.rs:9-54).

    ``max_radius`` mirrors the hard-coded ``max=255`` at src/depth_image.rs:119
    (rings 0..max-1 inclusive).
    """

    max_radius: int = 255


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Dense stereo matcher (the fast path; SURVEY.md §7 step 4).

    A rectified-stereo recast of the reference's brightness matching: cost volume
    over ``num_disparities`` horizontal shifts, aggregated over a ``window`` box,
    winner-take-all with optional subpixel refinement.
    """

    num_disparities: int = 64
    window: int = 9
    cost: str = "sad"  # "sad" | "ssd" | "census"
    census_window: int = 7
    subpixel: bool = True
    # Left-right consistency check threshold in disparity units; None disables.
    lr_threshold: Optional[float] = 1.0
    # Uniqueness ratio check (best vs. second-best cost); None disables.
    uniqueness: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Coarse-to-fine hierarchy replacing disage's adaptive recursion
    (SURVEY.md §2.1 C7 recast)."""

    levels: int = 4
    # Disparity search half-window around the upsampled coarse estimate, per
    # level. A refine window covers 2R+1 disparities with 2R+1 offsets, so
    # coverage-per-offset is independent of R: narrow windows cut the flat
    # per-offset cost while contested tiles keep their span through a
    # proportionally deeper multi-window cover, and narrow windows sit closer
    # to the true disparity modes at depth edges.
    refine_radius: int = 2
    coarsest_disparities: int = 32
    # Cap on adaptive per-tile base windows in the refiner: tiles whose prior
    # spans a disparity discontinuity search up to this many base ± R
    # windows; 1 restores one base per tile. 16 at R=2 covers a 1080p/D=128
    # tile's whole range; windows beyond a tile's plan are not run.
    refine_windows: int = 16
    # Final (full-resolution) level overrides; None inherits refine_radius /
    # refine_windows (so a user-tuned refine_windows applies at every level).
    refine_radius_final: Optional[int] = None
    refine_windows_final: Optional[int] = None

    @property
    def final_radius(self) -> int:
        return (
            self.refine_radius
            if self.refine_radius_final is None
            else self.refine_radius_final
        )

    @property
    def final_windows(self) -> int:
        return (
            self.refine_windows
            if self.refine_windows_final is None
            else self.refine_windows_final
        )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape for spatial tile sharding (greenfield; SURVEY.md §2.3)."""

    # Axis names: data (batch), tile (image-row tiles).
    data: int = 1
    tile: int = 1
    axis_names: Tuple[str, str] = ("data", "tile")


DEFAULT_PRECISION: Tuple[int, int, int] = (255 // 7,) * 3  # Readme.md:14
