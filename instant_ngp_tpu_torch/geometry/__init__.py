"""Geometry mode: scenes of meshes and NeRFs (the fork's
src/testbed_geometry.cu, src/geometry_bvh.cu)."""

from .geometry_bvh import GeometryBvh  # noqa: F401
from .testbed_geometry import GeometryTestbed  # noqa: F401
