"""pyngp compatibility: `import instant_ngp_tpu_torch.pyngp_compat as ngp`
gives scripts written against instant-ngp's pybind11 module the same names
(counterpart of instant_ngp_tpu/pyngp_compat.py): `Testbed`, the enums,
the mode constants and `free_temporary_memory`. Geometry mode is exposed
too."""

from .common import (Activation, ColorSpace,  # noqa: F401
                     GroundTruthRenderMode, LensMode, LossType,
                     MeshSdfMode, RenderMode, SDFGroundTruthMode,
                     TestbedMode, TonemapCurve)
from .testbed import Testbed, mode_from_scene  # noqa: F401

# pyngp spells the mode enum values like this
NerfMode = TestbedMode.Nerf
SdfMode = TestbedMode.Sdf
ImageMode = TestbedMode.Image
VolumeMode = TestbedMode.Volume
GeometryMode = TestbedMode.Geometry


def free_temporary_memory() -> None:
    """Release the cached blocks of PyTorch's CUDA allocator
    (nothing to do without a card)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
