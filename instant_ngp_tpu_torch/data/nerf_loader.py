"""Host-side NeRF dataset containers (counterpart of the dataclasses of
instant_ngp_tpu/data/nerf_loader.py): numpy arrays per image, as a loader
or a scene generator fills them. Reading `transforms.json` captures and
image files (`load_nerf`) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

NERF_SCALE = 0.33


@dataclasses.dataclass
class Lens:
    """Lens distortion model: mode and up to 7 parameters."""

    mode: str = "Perspective"
    params: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(7, np.float32))


@dataclasses.dataclass
class FrameMetadata:
    """Per-image camera data."""

    resolution: Tuple[int, int]  # (W, H)
    focal_length: np.ndarray     # (2,)
    principal_point: np.ndarray  # (2,), uv in [0,1]
    rolling_shutter: np.ndarray  # (4,) [A, B, C, motionblur]
    lens: Lens
    light_dir: Optional[np.ndarray] = None


@dataclasses.dataclass
class NerfDataset:
    """Host-side dataset. Pixels stay uint8 or float16 until batching."""

    paths: List[str]
    images: List[np.ndarray]            # (H, W, 4) uint8 or float16
    depths: List[Optional[np.ndarray]]  # (H, W) float32 metric depth
    rays: List[Optional[np.ndarray]]    # (H, W, 6) float32 o+d, NGP space
    metadata: List[FrameMetadata]
    xforms_start: np.ndarray            # (N, 3, 4) NGP-space camera
    xforms_end: np.ndarray              # (N, 3, 4)
    scale: float = NERF_SCALE
    offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5], np.float32))
    aabb_scale: int = 1
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    from_mitsuba: bool = False
    is_hdr: bool = False
    wants_importance_sampling: bool = True
    has_rays: bool = False
    n_extra_learnable_dims: int = 0
    has_light_dirs: bool = False
    envmap: Optional[np.ndarray] = None
    sharpen_amount: float = 0.0

    @property
    def n_images(self) -> int:
        return len(self.images)

    @property
    def n_extra_dims(self) -> int:
        return (3 if self.has_light_dirs else 0) + self.n_extra_learnable_dims
