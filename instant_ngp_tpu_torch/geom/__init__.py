"""Geometry and acceleration structures: the triangle BVH (host C++ through
ctypes), the triangle octree, marching cubes and tetrahedra, mesh files."""

from .triangle_bvh import TriangleBvh, load_obj  # noqa: F401
