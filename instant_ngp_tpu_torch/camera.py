"""uv -> ray for the pinhole lens, and the per-pixel camera of a rolling
shutter (counterpart of instant_ngp_tpu/camera.py::uv_to_ray, perspective
branch, and xform_with_rolling_shutter).

Conventions: uv in [0,1]^2 with x right and y DOWN; the camera matrix is
(3, 4) [R|t] with columns x-right, y-down, z-forward in NGP world space;
directions land on the z = 1 plane in camera space. The OpenCV, fisheye,
f-theta, latlong and equirectangular lenses, the distortion map and the
aperture are not ported yet: any lens but the pinhole raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

LENS_PERSPECTIVE = 0
LENS_OPENCV = 1
LENS_FTHETA = 2
LENS_LATLONG = 3
LENS_OPENCV_FISHEYE = 4
LENS_EQUIRECT = 5

_LENS_MODE_FROM_STR = {
    "Perspective": LENS_PERSPECTIVE, "OpenCV": LENS_OPENCV,
    "FTheta": LENS_FTHETA, "LatLong": LENS_LATLONG,
    "OpenCVFisheye": LENS_OPENCV_FISHEYE, "Equirectangular": LENS_EQUIRECT,
}


def lens_mode_id(name: str) -> int:
    return _LENS_MODE_FROM_STR[name]


def uv_to_ray(uv: torch.Tensor, resolution, focal_length: torch.Tensor,
              camera_matrix: torch.Tensor, screen_center=(0.5, 0.5),
              lens_mode: int = LENS_PERSPECTIVE
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uv (N, 2) -> (origin (N, 3), UNnormalized dir (N, 3), valid (N,)).
    resolution (w, h), focal_length (2,) and camera_matrix (3, 4) are one
    camera's, or carry a leading N for a camera per ray."""
    if lens_mode != LENS_PERSPECTIVE:
        raise NotImplementedError(f"lens mode {lens_mode} is not ported yet "
                                  f"(only the pinhole lens)")
    res = torch.as_tensor(resolution, dtype=torch.float32, device=uv.device)
    x = (uv[:, 0] - float(screen_center[0])) * res[..., 0] \
        / focal_length[..., 0]
    y = (uv[:, 1] - float(screen_center[1])) * res[..., 1] \
        / focal_length[..., 1]
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rot = camera_matrix[..., :3, :3]
    d = (rot * d[:, None, :]).sum(dim=-1)
    origin = camera_matrix[..., :3, 3].expand_as(d)
    return origin, d, torch.ones(uv.shape[0], dtype=torch.bool,
                                 device=uv.device)


def _mat3_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) unit quaternion (w, x, y, z), by
    Shepperd's method: all four forms, the numerically best selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp(min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1,
                                           torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _mat3_slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor
                ) -> torch.Tensor:
    """Rotation slerp through quaternions; t (..., 1)."""
    qa, qb = _mat3_to_quat(a), _mat3_to_quat(b)
    dot = (qa * qb).sum(dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)
    dot = dot.abs()
    theta = torch.arccos(dot.clamp(-1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-5            # nearly parallel: nlerp
    safe_sin = torch.where(near, 1.0, sin_theta)
    w_a = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w_b = torch.where(near, t, torch.sin(t * theta) / safe_sin)
    q = w_a * qa + w_b * qb
    return _quat_to_mat3(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def camera_slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor
                 ) -> torch.Tensor:
    """(..., 3, 4) cameras: rotation slerp and translation mix at t (...)."""
    t = t[..., None, None]
    rot = _mat3_slerp(a[..., :3, :3], b[..., :3, :3], t[..., 0])
    trans = a[..., :3, 3:] * (1 - t) + b[..., :3, 3:] * t
    return torch.cat([rot, trans], dim=-1)


def xform_with_rolling_shutter(xform_start: torch.Tensor,
                               xform_end: torch.Tensor,
                               rolling_shutter: torch.Tensor,
                               uv: torch.Tensor,
                               motionblur_time: torch.Tensor) -> torch.Tensor:
    """Per-pixel camera matrix at t = A + B*u + C*v + D*motionblur_time."""
    t = (rolling_shutter[..., 0]
         + rolling_shutter[..., 1] * uv[..., 0]
         + rolling_shutter[..., 2] * uv[..., 1]
         + rolling_shutter[..., 3] * motionblur_time)
    return camera_slerp(xform_start, xform_end, t)
