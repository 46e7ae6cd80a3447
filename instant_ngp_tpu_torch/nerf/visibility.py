"""Camera-visibility culling of occupancy cells (counterpart of
instant_ngp_tpu/nerf/visibility.py).

A grid cell is trainable if at least one training camera sees any of its 8
corners: the corner lies in front of the camera and projects inside
(0, 1)^2 of its image, through the OpenCV or fisheye distortion where the
lens is one of them. The f-theta, latlong and equirectangular lenses are
taken to see everything. Run once per dataset, in chunks of cells, with a
loop over the cameras.
"""

from __future__ import annotations

import torch

from ..camera import (LENS_EQUIRECT, LENS_FTHETA, LENS_LATLONG, LENS_OPENCV,
                      LENS_OPENCV_FISHEYE,
                      opencv_fisheye_lens_distortion_delta,
                      opencv_lens_distortion_delta)
from ..common import NERF_GRID_N_CELLS, NERF_GRIDSIZE
from .dataset import NerfSceneConfig, NerfTrainingData
from .march import morton3d_coords


@torch.no_grad()
def compute_visible_cells(data: NerfTrainingData, scene: NerfSceneConfig,
                          chunk: int = 1 << 18) -> torch.Tensor:
    """-> (n_cascades * 128^3,) bool visibility, on the data's device."""
    dev = data.xforms_start.device
    n_total = NERF_GRID_N_CELLS * (scene.max_cascade + 1)
    if scene.lens_mode in (LENS_FTHETA, LENS_LATLONG, LENS_EQUIRECT):
        return torch.ones(n_total, dtype=torch.bool, device=dev)
    distortion = {LENS_OPENCV: opencv_lens_distortion_delta,
                  LENS_OPENCV_FISHEYE: opencv_fisheye_lens_distortion_delta
                  }.get(scene.lens_mode)
    offs = torch.tensor([[cx, cy, cz] for cx in (0, 1) for cy in (0, 1)
                         for cz in (0, 1)], dtype=torch.float32, device=dev)
    out = torch.zeros(n_total, dtype=torch.bool, device=dev)
    for start in range(0, n_total, chunk):
        flat = torch.arange(start, min(start + chunk, n_total), device=dev)
        level = flat // NERF_GRID_N_CELLS
        grid = torch.stack(morton3d_coords(flat % NERF_GRID_N_CELLS), -1)
        mip = torch.exp2(level.float())[:, None]
        base = (grid.float() / NERF_GRIDSIZE - 0.5) * mip + 0.5
        corners = base[:, None, :] + (mip / NERF_GRIDSIZE)[:, None, :] \
            * offs[None]                                     # (n, 8, 3)
        seen = torch.zeros(flat.shape[0], dtype=torch.bool, device=dev)
        for i in range(data.n_images):
            xform = data.xforms_start[i]
            rot, cam_o = xform[:3, :3], xform[:3, 3]
            dx, dy, dz = (corners - cam_o).unbind(dim=-1)
            # camera-frame components through R^T
            cx = rot[0, 0] * dx + rot[1, 0] * dy + rot[2, 0] * dz
            cy = rot[0, 1] * dx + rot[1, 1] * dy + rot[2, 1] * dz
            cz = rot[0, 2] * dx + rot[1, 2] * dy + rot[2, 2] * dz
            norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
            in_front = cz / norm.clamp(min=1e-9) > 1e-4
            safe_z = torch.where(cz.abs() < 1e-9, 1e-9, cz)
            fl, res, pp = (data.focal_lengths[i], data.resolutions[i],
                           data.principal_points[i])
            px, py = cx / safe_z, cy / safe_z
            if distortion is not None:
                du, dv = distortion(data.lens_params[i], px, py)
                px, py = px + du, py + dv
            u = px * fl[0] / res[0] + pp[0]
            v = py * fl[1] / res[1] + pp[1]
            inside = (u > 0) & (u < 1) & (v > 0) & (v < 1)
            seen |= (in_front & inside).any(dim=-1)
        out[start:start + chunk] = seen
    return out
