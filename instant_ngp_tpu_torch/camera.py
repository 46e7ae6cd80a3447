"""Camera and lens math: uv <-> ray through every lens model, and the
per-pixel camera of a rolling shutter (counterpart of
instant_ngp_tpu/camera.py).

- OpenCV radial/tangential distortion and the OpenCV fisheye model, undone
  by a fixed number of Newton steps with a central-difference Jacobian;
- the f-theta polynomial, latlong and equirectangular direction maps;
- `uv_to_ray`: the pixel plane at z = 1 in camera space, an optional
  trained distortion map added on the image plane, an optional aperture;
- `pos_to_uv`: the forward projection (distortion applied, not undone).

Conventions: uv in [0,1]^2 with x right and y DOWN; the camera matrix is
(3, 4) [R|t] with columns x-right, y-down, z-forward in NGP world space.
Everything is plain differentiable tensor code: autograd reaches the
distortion map and the camera through it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

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

_F32_EPS = float(torch.finfo(torch.float32).eps)
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def lens_mode_id(name: str) -> int:
    return _LENS_MODE_FROM_STR[name]


def opencv_lens_distortion_delta(params: torch.Tensor, u: torch.Tensor,
                                 v: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """params (..., >= 4) = (k1, k2, p1, p2): the displacement (du, dv) the
    lens adds to the undistorted image-plane point (u, v)."""
    k1, k2, p1, p2 = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
    return du, dv


def opencv_fisheye_lens_distortion_delta(params: torch.Tensor,
                                         u: torch.Tensor, v: torch.Tensor
                                         ) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """params (..., >= 4) = (k1, k2, k3, k4) of the fisheye polynomial."""
    k1, k2, k3, k4 = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    r = torch.sqrt(u * u + v * v)
    safe_r = r.clamp(min=1e-12)
    theta = torch.arctan(safe_r)
    t2 = theta * theta
    thetad = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r > 1e-12, thetad / safe_r - 1.0, 0.0)
    return u * scale, v * scale


def iterative_lens_undistortion(params: torch.Tensor, u: torch.Tensor,
                                v: torch.Tensor, distortion_fn: Callable,
                                n_iterations: int = 12
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The undistorted point whose distorted image is (u, v): a fixed
    number of Newton steps with a central-difference Jacobian whose step is
    max(eps, |1e-6 x|), and a guard on a vanishing determinant."""
    rel = 1e-6
    x0u, x0v = u, v
    xu, xv = u, v
    for _ in range(n_iterations):
        s0 = (rel * xu).abs().clamp(min=_F32_EPS)
        s1 = (rel * xv).abs().clamp(min=_F32_EPS)
        du, dv = distortion_fn(params, xu, xv)
        du0b, dv0b = distortion_fn(params, xu - s0, xv)
        du0f, dv0f = distortion_fn(params, xu + s0, xv)
        du1b, dv1b = distortion_fn(params, xu, xv - s1)
        du1f, dv1f = distortion_fn(params, xu, xv + s1)
        j00 = 1 + (du0f - du0b) / (2 * s0)
        j01 = (du1f - du1b) / (2 * s1)
        j10 = (dv0f - dv0b) / (2 * s0)
        j11 = 1 + (dv1f - dv1b) / (2 * s1)
        fu = xu + du - x0u
        fv = xv + dv - x0v
        det = j00 * j11 - j01 * j10
        det = torch.where(det.abs() < 1e-20, 1e-20, det)
        xu = xu - (j11 * fu - j01 * fv) / det
        xv = xv - (-j10 * fu + j00 * fv) / det
    return xu, xv


def f_theta_undistortion(uv: torch.Tensor, params: torch.Tensor
                         ) -> torch.Tensor:
    """uv (..., 2), relative to the screen centre -> direction (..., 3);
    the zero vector marks a pixel the lens does not see. params (..., 7):
    the polynomial's five coefficients, then the width and height."""
    xpix = uv[..., 0] * params[..., 5]
    ypix = uv[..., 1] * params[..., 6]
    norm = torch.sqrt(xpix * xpix + ypix * ypix)
    alpha = params[..., 0] + norm * (params[..., 1] + norm * (
        params[..., 2] + norm * (params[..., 3] + norm * params[..., 4])))
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    ok = (cos_a > _F32_TINY) & (norm > 0)
    s = sin_a / norm.clamp(min=1e-12)
    d = torch.stack([s * xpix, s * ypix, cos_a], dim=-1)
    return torch.where(ok[..., None], d, 0.0)


def latlong_to_dir(uv: torch.Tensor) -> torch.Tensor:
    theta = (uv[..., 1] - 0.5) * math.pi
    phi = (uv[..., 0] - 0.5) * math.pi * 2.0
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([sp * ct, st, cp * ct], dim=-1)


def equirectangular_to_dir(uv: torch.Tensor) -> torch.Tensor:
    ct = (uv[..., 1] - 0.5) * 2.0
    st = torch.sqrt((1.0 - ct * ct).clamp(min=0.0))
    phi = (uv[..., 0] - 0.5) * math.pi * 2.0
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([sp * st, ct, cp * st], dim=-1)


def square2disk_shirley(s: torch.Tensor) -> torch.Tensor:
    """Shirley's concentric map of the square [-1, 1]^2 onto the disk."""
    x, y = s[..., 0], s[..., 1]
    use_x = x.abs() > y.abs()

    def safe(a):
        return torch.where(a.abs() < 1e-12, 1e-12, a)

    r = torch.where(use_x, x, y)
    phi = torch.where(use_x, (math.pi / 4) * (y / safe(x)),
                      (math.pi / 2) - (math.pi / 4) * (x / safe(y)))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def _pair(value, device) -> torch.Tensor:
    """(w, h), a screen centre or a focal length as a float32 tensor (2,)
    or (N, 2) on `device`."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def uv_to_ray(uv: torch.Tensor, resolution, focal_length: torch.Tensor,
              camera_matrix: torch.Tensor, screen_center=(0.5, 0.5),
              lens_mode: int = LENS_PERSPECTIVE,
              lens_params: Optional[torch.Tensor] = None,
              near_distance: float = 0.0,
              aperture_size: float = 0.0, focus_z: float = 1.0,
              aperture_samples: Optional[torch.Tensor] = None,
              distortion_map: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uv (N, 2) -> (origin (N, 3), UNnormalized dir (N, 3), valid (N,)).
    resolution (w, h), focal_length (2,), screen_center (2,), lens_params
    (7,) and camera_matrix (3, 4) are one camera's, or carry a leading N
    for a camera per ray. `distortion_map` (H, W, 2) is sampled bilinearly
    at uv and added to the direction's x and y on the z = 1 plane;
    `aperture_samples` (N, 2) in [0, 1) place each origin on the aperture's
    disk and refocus its direction on the plane at `focus_z`."""
    dev = uv.device
    res = _pair(resolution, dev)
    center = _pair(screen_center, dev)
    valid = torch.ones(uv.shape[:-1], dtype=torch.bool, device=dev)

    if lens_mode == LENS_FTHETA:
        d = f_theta_undistortion(uv - center, lens_params)
        valid = (d != 0.0).any(dim=-1)
    elif lens_mode == LENS_LATLONG:
        d = latlong_to_dir(uv)
    elif lens_mode == LENS_EQUIRECT:
        d = equirectangular_to_dir(uv)
    else:
        x = (uv[..., 0] - center[..., 0]) * res[..., 0] \
            / focal_length[..., 0]
        y = (uv[..., 1] - center[..., 1]) * res[..., 1] \
            / focal_length[..., 1]
        if lens_mode == LENS_OPENCV:
            x, y = iterative_lens_undistortion(
                lens_params, x, y, opencv_lens_distortion_delta)
        elif lens_mode == LENS_OPENCV_FISHEYE:
            x, y = iterative_lens_undistortion(
                lens_params, x, y, opencv_fisheye_lens_distortion_delta)
        d = torch.stack([x, y, torch.ones_like(x)], dim=-1)

    if distortion_map is not None:
        from .ops.trainable_buffer import bilerp_2d

        delta = bilerp_2d(distortion_map, uv)
        d = torch.cat([d[..., :2] + delta, d[..., 2:]], dim=-1)

    rot = camera_matrix[..., :3, :3]
    d = (rot * d[..., None, :]).sum(dim=-1)
    origin = camera_matrix[..., :3, 3].expand_as(d)

    if aperture_size != 0.0 and aperture_samples is not None:
        lookat = origin + d * focus_z
        blur = aperture_size * square2disk_shirley(
            aperture_samples * 2.0 - 1.0)
        origin = origin + (rot[..., :2] * blur[..., None, :]).sum(dim=-1)
        d = (lookat - origin) / focus_z

    origin = origin + d * near_distance
    return origin, d, valid


def pos_to_uv(pos: torch.Tensor, resolution, focal_length: torch.Tensor,
              camera_matrix: torch.Tensor, screen_center=(0.5, 0.5),
              lens_mode: int = LENS_PERSPECTIVE,
              lens_params: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World positions (N, 3) -> (uv (N, 2), depth along the camera's z):
    the forward projection, through the OpenCV and fisheye distortions
    where the lens is one of them (the other lenses project as a
    pinhole)."""
    dev = pos.device
    res = _pair(resolution, dev)
    center = _pair(screen_center, dev)
    rot = camera_matrix[..., :3, :3]
    d = pos - camera_matrix[..., :3, 3]
    d_cam = (rot * d[..., :, None]).sum(dim=-2)          # R^T d
    z = d_cam[..., 2]
    safe_z = torch.where(z.abs() < 1e-12, 1e-12, z)
    x = d_cam[..., 0] / safe_z
    y = d_cam[..., 1] / safe_z
    if lens_mode == LENS_OPENCV:
        du, dv = opencv_lens_distortion_delta(lens_params, x, y)
        x, y = x + du, y + dv
    elif lens_mode == LENS_OPENCV_FISHEYE:
        du, dv = opencv_fisheye_lens_distortion_delta(lens_params, x, y)
        x, y = x + du, y + dv
    u = x * focal_length[..., 0] / res[..., 0] + center[..., 0]
    v = y * focal_length[..., 1] / res[..., 1] + center[..., 1]
    return torch.stack([u, v], dim=-1), z


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
