"""Object-level BVH over the AABBs of a scene's objects (counterpart of
instant_ngp_tpu/geometry/geometry_bvh.py, the fork's GeometryBvh).

One object per leaf; an inner node splits its objects at the median of
their centres along the axis of widest centre spread. Scenes hold at most
dozens of objects, so the traversal runs on the host in numpy and returns,
per ray, the objects whose boxes it can hit; the per-object intersection
then runs in the triangle BVH or the NeRF march.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class _Node:
    lo: np.ndarray
    hi: np.ndarray
    left: int = -1      # child index or -1
    right: int = -1
    obj: int = -1       # leaf: object index


class GeometryBvh:
    """Binary AABB BVH with one object per leaf."""

    def __init__(self, aabbs: Sequence[Tuple[np.ndarray, np.ndarray]]):
        self.aabbs = [(np.asarray(lo, np.float32), np.asarray(hi, np.float32))
                      for lo, hi in aabbs]
        self.nodes: List[_Node] = []
        if self.aabbs:
            self._build(list(range(len(self.aabbs))))

    def _build(self, idxs: List[int]) -> int:
        node_id = len(self.nodes)
        lo = np.min([self.aabbs[i][0] for i in idxs], axis=0)
        hi = np.max([self.aabbs[i][1] for i in idxs], axis=0)
        self.nodes.append(_Node(lo, hi))
        if len(idxs) == 1:
            self.nodes[node_id].obj = idxs[0]
            return node_id
        centers = np.array([(self.aabbs[i][0] + self.aabbs[i][1]) * 0.5
                            for i in idxs])
        axis = int(np.argmax(centers.max(0) - centers.min(0)))
        order = np.argsort(centers[:, axis])
        mid = len(idxs) // 2
        left = self._build([idxs[i] for i in order[:mid]])
        right = self._build([idxs[i] for i in order[mid:]])
        self.nodes[node_id].left = left
        self.nodes[node_id].right = right
        return node_id

    @staticmethod
    def _ray_box(o, inv_d, lo, hi):
        t1 = (lo - o) * inv_d
        t2 = (hi - o) * inv_d
        return np.minimum(t1, t2).max(-1), np.maximum(t1, t2).min(-1)

    def intersect_mask(self, origins: np.ndarray, dirs: np.ndarray
                       ) -> np.ndarray:
        """(R, n_objects) bool: which object AABBs each ray can hit."""
        out = np.zeros((len(origins), len(self.aabbs)), bool)
        if not self.nodes:
            return out
        inv_d = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
        stack = [0]
        while stack:
            node = self.nodes[stack.pop()]
            tmin, tmax = self._ray_box(origins, inv_d, node.lo, node.hi)
            hit = tmax >= np.maximum(tmin, 0.0)
            if not hit.any():
                continue
            if node.obj >= 0:
                out[:, node.obj] |= hit
            else:
                stack.append(node.left)
                stack.append(node.right)
        return out
