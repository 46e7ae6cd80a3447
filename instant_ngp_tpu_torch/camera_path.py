"""Camera paths: keyframes, a Catmull-Rom spline, JSON save and load, and
video (counterpart of instant_ngp_tpu/camera_path.py; instant-ngp's
camera_path.h and src/camera_path.cu).

A keyframe holds a rotation quaternion (w, x, y, z), a translation and the
slice, scale, fov and aperture; `CameraPath.eval(t)` blends four
neighbouring keyframes (quaternions sign-aligned first), with optional
looping. The JSON schema is instant-ngp's, so saved paths interchange.
`render_video` writes one PNG per frame and assembles video.mp4 with
ffmpeg where ffmpeg exists.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional

import numpy as np


def quat_to_mat3(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def mat3_to_quat(m: np.ndarray) -> np.ndarray:
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s], np.float32)
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12)) * 2
    q = np.empty(4, np.float32)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


@dataclasses.dataclass
class CameraKeyframe:
    R: np.ndarray                      # quaternion (w, x, y, z)
    T: np.ndarray                      # translation
    slice: float = 0.0
    scale: float = 1.0
    fov: float = 50.0
    aperture_size: float = 0.0
    glow_mode: int = 0
    glow_y_cutoff: float = 0.0

    @classmethod
    def from_matrix(cls, m: np.ndarray, **kw) -> "CameraKeyframe":
        m = np.asarray(m, np.float32)
        return cls(R=mat3_to_quat(m[:3, :3]), T=m[:3, 3].copy(), **kw)

    def matrix(self) -> np.ndarray:
        rot = quat_to_mat3(self.R)
        return np.concatenate([rot, self.T[:, None]], axis=1)

    def scaled(self, f: float) -> "CameraKeyframe":
        return CameraKeyframe(self.R * f, self.T * f, self.slice * f,
                              self.scale * f, self.fov * f,
                              self.aperture_size * f, self.glow_mode,
                              self.glow_y_cutoff * f)

    def added(self, o: "CameraKeyframe") -> "CameraKeyframe":
        r = o.R if np.dot(self.R, o.R) >= 0 else -o.R
        return CameraKeyframe(self.R + r, self.T + o.T,
                              self.slice + o.slice, self.scale + o.scale,
                              self.fov + o.fov,
                              self.aperture_size + o.aperture_size,
                              self.glow_mode,
                              self.glow_y_cutoff + o.glow_y_cutoff)

    def to_json(self) -> dict:
        return {"R": [float(v) for v in self.R],
                "T": [float(v) for v in self.T],
                "slice": self.slice, "scale": self.scale, "fov": self.fov,
                "aperture_size": self.aperture_size,
                "glow_mode": self.glow_mode,
                "glow_y_cutoff": self.glow_y_cutoff}

    @classmethod
    def from_json(cls, d: dict) -> "CameraKeyframe":
        return cls(np.asarray(d["R"], np.float32),
                   np.asarray(d["T"], np.float32),
                   float(d.get("slice", 0.0)), float(d.get("scale", 1.0)),
                   float(d.get("fov", 50.0)),
                   float(d.get("aperture_size", d.get("dof", 0.0))),
                   int(d.get("glow_mode", 0)),
                   float(d.get("glow_y_cutoff", 0.0)))


def spline(t: float, p0: CameraKeyframe, p1: CameraKeyframe,
           p2: CameraKeyframe, p3: CameraKeyframe) -> CameraKeyframe:
    """Catmull-Rom blend of four keyframes."""
    t2, t3 = t * t, t * t * t
    w0 = 0.5 * (-t3 + 2 * t2 - t)
    w1 = 0.5 * (3 * t3 - 5 * t2 + 2)
    w2 = 0.5 * (-3 * t3 + 4 * t2 + t)
    w3 = 0.5 * (t3 - t2)
    out = p0.scaled(w0).added(p1.scaled(w1)).added(p2.scaled(w2)) \
        .added(p3.scaled(w3))
    out.R = out.R / np.linalg.norm(out.R)
    return out


class CameraPath:
    def __init__(self):
        self.keyframes: List[CameraKeyframe] = []
        self.loop = False
        self.play_time = 0.0
        # instant-ngp's render settings defaults
        self.resolution = (1920, 1080)
        self.spp = 8
        self.fps = 60.0
        self.duration_seconds = 5.0
        self.shutter_fraction = 0.5

    def get_keyframe(self, i: int) -> CameraKeyframe:
        n = len(self.keyframes)
        if self.loop:
            return self.keyframes[(i + n) % n]
        return self.keyframes[min(max(i, 0), n - 1)]

    def eval(self, t: float) -> CameraKeyframe:
        """t in [0, 1] along the whole path."""
        if not self.keyframes:
            raise ValueError("empty camera path")
        n = len(self.keyframes)
        t = t * (n if self.loop else n - 1)
        i = int(math.floor(t))
        return spline(t - i, self.get_keyframe(i - 1), self.get_keyframe(i),
                      self.get_keyframe(i + 1), self.get_keyframe(i + 2))

    def n_frames(self) -> int:
        return int(self.duration_seconds * self.fps)

    # -- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({
                "loop": self.loop,
                "time": self.play_time,
                "path": [k.to_json() for k in self.keyframes],
                "render_settings": {
                    "resolution": list(self.resolution), "spp": self.spp,
                    "fps": self.fps,
                    "duration_seconds": self.duration_seconds,
                    "shutter_fraction": self.shutter_fraction,
                },
            }, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "CameraPath":
        with open(path) as f:
            data = json.load(f)
        cp = cls()
        cp.loop = bool(data.get("loop", False))
        cp.play_time = float(data.get("time", 0.0))
        cp.keyframes = [CameraKeyframe.from_json(k)
                        for k in data.get("path", [])]
        rs = data.get("render_settings", {})
        cp.resolution = tuple(rs.get("resolution", [1920, 1080]))
        cp.spp = int(rs.get("spp", 8))
        cp.fps = float(rs.get("fps", 60.0))
        cp.duration_seconds = float(rs.get("duration_seconds", 5.0))
        cp.shutter_fraction = float(rs.get("shutter_fraction", 0.5))
        return cp


def render_video(testbed, camera_path: CameraPath, out_dir: str,
                 width: Optional[int] = None, height: Optional[int] = None,
                 spp: Optional[int] = None, make_mp4: bool = True) -> str:
    """Render `camera_path` through `testbed.render` into frame PNGs in
    `out_dir`, and assemble video.mp4 with ffmpeg where it exists (else
    the directory of frames is returned)."""
    from .data.images import write_image

    os.makedirs(out_dir, exist_ok=True)
    w = width or camera_path.resolution[0]
    h = height or camera_path.resolution[1]
    n = camera_path.n_frames()
    for i in range(n):
        kf = camera_path.eval(i / max(n - 1, 1))
        img = testbed.render(w, h, spp=spp or camera_path.spp,
                             camera_matrix=kf.matrix())
        write_image(os.path.join(out_dir, f"frame_{i:05d}.png"),
                    img.astype(np.float32))
    video = os.path.join(out_dir, "video.mp4")
    if make_mp4:
        import subprocess

        try:
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", str(camera_path.fps),
                 "-i", os.path.join(out_dir, "frame_%05d.png"),
                 "-c:v", "libx264", "-pix_fmt", "yuv420p", video],
                check=True, capture_output=True)
        except (FileNotFoundError, subprocess.CalledProcessError):
            return out_dir  # frames only: no ffmpeg
    return video
