"""Shared enums (modes, losses, activations, colour spaces, tonemap curves,
render and ground-truth modes, SDF modes, lenses), the NeRF grid and
cone-stepping constants, the host-side `Ray` and `BoundingBox`, the sRGB
transfer functions on numpy, and `next_multiple` and `powi`.

Counterpart of instant_ngp_tpu/common.py; values and names are kept so
configs and snapshots written by either package read the same.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field

import numpy as np


class TestbedMode(enum.Enum):
    Nerf = "nerf"
    Sdf = "sdf"
    Image = "image"
    Volume = "volume"
    Geometry = "geometry"
    NONE = "none"


class LossType(enum.Enum):
    L2 = "L2"
    L1 = "L1"
    Mape = "MAPE"
    Smape = "SMAPE"
    Huber = "Huber"
    LogL1 = "LogL1"
    RelativeL2 = "RelativeL2"


class Activation(enum.Enum):
    NONE = "None"
    ReLU = "ReLU"
    Logistic = "Logistic"
    Exponential = "Exponential"
    Sine = "Sine"
    Squareplus = "Squareplus"
    Softplus = "Softplus"


class ColorSpace(enum.Enum):
    Linear = "Linear"
    SRGB = "SRGB"


class TonemapCurve(enum.Enum):
    Identity = "Identity"
    ACES = "ACES"
    Hable = "Hable"
    Reinhard = "Reinhard"


class RenderMode(enum.Enum):
    AO = "AO"
    Shade = "Shade"
    Normals = "Normals"
    Positions = "Positions"
    Depth = "Depth"
    Distance = "Distance"
    Stepsize = "Stepsize"
    Distortion = "Distortion"
    Cost = "Cost"
    Slice = "Slice"
    EncodingVis = "EncodingVis"


class GroundTruthRenderMode(enum.Enum):
    Render = "Render"
    PSNR = "PSNR"
    SSIM = "SSIM"


class SDFGroundTruthMode(enum.Enum):
    RaytracedMesh = "RaytracedMesh"
    SpheretracedMesh = "SpheretracedMesh"
    SDFBricks = "SDFBricks"


class MeshSdfMode(enum.Enum):
    Watertight = "Watertight"
    Raystab = "Raystab"
    PathEscape = "PathEscape"


class LensMode(enum.Enum):
    Perspective = "Perspective"
    OpenCV = "OpenCV"
    FTheta = "FTheta"
    LatLong = "LatLong"
    OpenCVFisheye = "OpenCVFisheye"
    Equirectangular = "Equirectangular"


NERF_GRIDSIZE = 128                    # occupancy grid resolution per cascade
NERF_CASCADES = 8                      # max number of cascaded grids (mips)
NERF_GRID_N_CELLS = NERF_GRIDSIZE ** 3

SQRT3 = math.sqrt(3.0)
STEPS_PER_UNIT = 1024.0                # finest steps across the unit cube
MIN_CONE_STEPSIZE = SQRT3 / STEPS_PER_UNIT
# the largest step is the width of the coarsest cascade's cell
MAX_CONE_STEPSIZE = SQRT3 * (1 << (NERF_CASCADES - 1)) / STEPS_PER_UNIT

NERF_MIN_OPTICAL_THICKNESS = 0.01      # density threshold for the bitfield

# the constant loss scale of mixed-precision training
DEFAULT_LOSS_SCALE = 128.0


@dataclass
class Ray:
    """A ray with origin o and direction d (host side)."""

    o: np.ndarray
    d: np.ndarray

    def at(self, t: float) -> np.ndarray:
        return self.o + t * self.d


@dataclass
class BoundingBox:
    """Axis-aligned box on the host (scene setup, the loader's
    `render_aabb`)."""

    min: np.ndarray = field(
        default_factory=lambda: np.full(3, np.inf, np.float32))
    max: np.ndarray = field(
        default_factory=lambda: np.full(3, -np.inf, np.float32))

    @staticmethod
    def unit() -> "BoundingBox":
        return BoundingBox(np.zeros(3, np.float32), np.ones(3, np.float32))

    @staticmethod
    def from_points(pts: np.ndarray) -> "BoundingBox":
        return BoundingBox(pts.min(0).astype(np.float32),
                           pts.max(0).astype(np.float32))

    def enlarge(self, other: "BoundingBox") -> None:
        self.min = np.minimum(self.min, other.min)
        self.max = np.maximum(self.max, other.max)

    def inflate(self, amount: float) -> None:
        self.min = self.min - amount
        self.max = self.max + amount

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.min + self.max)

    @property
    def diag(self) -> np.ndarray:
        return self.max - self.min

    def relative_pos(self, p: np.ndarray) -> np.ndarray:
        return (p - self.min) / np.maximum(self.diag, 1e-12)

    def contains(self, p: np.ndarray) -> np.ndarray:
        return np.all((p >= self.min) & (p <= self.max), axis=-1)


def srgb_to_linear(x):
    """sRGB -> linear, elementwise, on numpy."""
    x = np.asarray(x)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    """linear -> sRGB, elementwise, on numpy."""
    x = np.asarray(x)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.maximum(x, 1e-12) ** (1.0 / 2.4) - 0.055)


def next_multiple(value: int, divisor: int) -> int:
    return ((value + divisor - 1) // divisor) * divisor


def powi(base: float, exp: int) -> float:
    return float(base) ** int(exp)
