"""NeRF dataset loader: transforms.json -> NerfDataset (own copy of
instant_ngp_tpu/data/nerf_loader.py; a capture loads to the same fields in
both packages).

- several transforms*.json merge into one dataset;
- frames are natural-sorted by file_path; `n_frames` culls the list, and
  `sharpness_discard_threshold` drops frames blurrier than their
  neighbourhood;
- NeRF -> NGP coordinates: the scene is scaled by 0.33 and offset by
  (0.5, 0.5, 0.5) into the unit cube, the axes cycled xyz <- yzx and the
  camera matrix's columns 1 and 2 negated; Mitsuba-convention datasets
  flip instead;
- lens parameters: k1..k4 / p1 / p2 (OpenCV or fisheye), f-theta
  polynomials, latlong / equirectangular flags, with per-frame overrides;
- focal length from x_fov (degrees), fl_x, or camera_angle_x (radians);
- the `aabb` key remaps an arbitrary world box into the unit cube;
- depth maps through `integer_depth_scale` and a per-frame depth_path;
  per-pixel ray files rays_<name>.dat; alpha and dynamic-mask sidecars;
- EXR frames mark the dataset HDR.

Images decode in a thread pool and stay uint8 (LDR) or float16 (HDR). PIL
is imported only where an LDR file is read.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import BoundingBox, srgb_to_linear
from ..config import loads_json

NERF_SCALE = 0.33

_SUPPORTED_FORMATS = ["png", "jpg", "jpeg", "bmp", "gif", "tga", "pic",
                      "pnm", "psd", "exr"]


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", s)]


def fov_to_focal_length(resolution: int, degrees: float) -> float:
    return 0.5 * resolution / math.tan(0.5 * math.radians(degrees))


def focal_length_to_fov(resolution: int, focal_length: float) -> float:
    return 2.0 * math.degrees(math.atan(0.5 * resolution / focal_length))


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
    render_aabb: Optional[BoundingBox] = None
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

    # -- coordinate conventions ------------------------------------------
    def nerf_matrix_to_ngp(self, m: np.ndarray) -> np.ndarray:
        """(3,4) NeRF camera-to-world → NGP convention."""
        result = np.array(m, np.float32, copy=True)
        result[:, 1] *= -1.0
        result[:, 2] *= -1.0
        result[:, 3] = result[:, 3] * self.scale + self.offset
        if self.from_mitsuba:
            result[:, 0] *= -1.0
            result[:, 2] *= -1.0
        else:
            result = result[[1, 2, 0], :]  # cycle rows xyz <- yzx
        return result

    def ngp_matrix_to_nerf(self, m: np.ndarray) -> np.ndarray:
        result = np.array(m, np.float32, copy=True)
        if self.from_mitsuba:
            result[:, 0] *= -1.0
            result[:, 2] *= -1.0
        else:
            result = result[[2, 0, 1], :]  # cycle rows xyz -> yzx
        result[:, 1] *= -1.0
        result[:, 2] *= -1.0
        result[:, 3] = (result[:, 3] - self.offset) / self.scale
        return result

    def nerf_position_to_ngp(self, pos: np.ndarray) -> np.ndarray:
        rv = np.asarray(pos, np.float32) * self.scale + self.offset
        return rv if self.from_mitsuba else rv[..., [1, 2, 0]]

    def ngp_position_to_nerf(self, pos: np.ndarray) -> np.ndarray:
        p = np.asarray(pos, np.float32)
        if not self.from_mitsuba:
            p = p[..., [2, 0, 1]]
        return (p - self.offset) / self.scale

    def nerf_direction_to_ngp(self, d: np.ndarray) -> np.ndarray:
        d = np.asarray(d, np.float32)
        return -d if self.from_mitsuba else d[..., [1, 2, 0]]


def _resolve_path(base: str, local: str) -> str:
    path = local if os.path.isabs(local) else os.path.join(base, local)
    if not os.path.splitext(path)[1] and not os.path.exists(path):
        for ext in _SUPPORTED_FORMATS:
            cand = path + "." + ext
            if os.path.exists(cand):
                return cand
    return path


def _read_lens(node: Dict[str, Any], lens: Lens, principal_point: np.ndarray,
               rolling_shutter: np.ndarray, resolution=None) -> None:
    """Parse a node's lens keys in place."""
    mode = "Perspective"
    opencv_mode = "OpenCVFisheye" if node.get("is_fisheye", False) else "OpenCV"
    for name, idx in [("k1", 0), ("k2", 1), ("k3", 2), ("k4", 3),
                      ("p1", 2), ("p2", 3)]:
        if name in node:
            lens.params[idx] = float(node[name])
            if lens.params[idx] != 0.0:
                mode = opencv_mode
    if "cx" in node:
        principal_point[0] = float(node["cx"]) / float(node["w"])
    if "cy" in node:
        principal_point[1] = float(node["cy"]) / float(node["h"])
    if "rolling_shutter" in node:
        rs = node["rolling_shutter"]
        rolling_shutter[:3] = [float(rs[0]), float(rs[1]), float(rs[2])]
        rolling_shutter[3] = float(rs[3]) if len(rs) >= 4 else 0.0
    if "ftheta_p0" in node:
        for i in range(5):
            lens.params[i] = float(node[f"ftheta_p{i}"])
        lens.params[5] = float(node["w"])
        lens.params[6] = float(node["h"])
        mode = "FTheta"
    if "latlong" in node:
        mode = "LatLong"
    if "equirectangular" in node:
        mode = "Equirectangular"
    if mode != "Perspective":
        lens.mode = mode


def _read_focal_length(node: Dict[str, Any], res: Tuple[int, int]
                       ) -> Optional[np.ndarray]:
    """x_fov is in degrees, camera_angle_x in radians."""

    def axis_fl(resolution: int, axis: str) -> float:
        if axis + "_fov" in node:
            return fov_to_focal_length(resolution, float(node[axis + "_fov"]))
        if "fl_" + axis in node:
            return float(node["fl_" + axis])
        if "camera_angle_" + axis in node:
            return fov_to_focal_length(
                resolution, math.degrees(float(node["camera_angle_" + axis])))
        return 0.0

    x_fl = axis_fl(res[0], "x")
    y_fl = axis_fl(res[1], "y")
    if x_fl != 0:
        return np.array([x_fl, y_fl if y_fl != 0 else x_fl], np.float32)
    if y_fl != 0:
        return np.array([y_fl, y_fl], np.float32)
    return None


def _load_frame_image(path: str) -> Tuple[np.ndarray, bool]:
    """Returns ((H,W,4) uint8|float16, is_hdr)."""
    if path.lower().endswith(".exr"):
        from .exr import read_exr

        img, _ = read_exr(path)
        if img.shape[2] < 4:
            pad = np.ones((*img.shape[:2], 4 - img.shape[2]), img.dtype)
            img = np.concatenate([img, pad], axis=-1)
        return img[..., :4].astype(np.float16), True
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGBA")
        arr = np.asarray(im, np.uint8)
    return arr, False


def load_nerf(jsonpaths, sharpen_amount: float = 0.0,
              max_workers: int = 16) -> NerfDataset:
    """Load one dataset from one or more transforms.json paths."""
    if isinstance(jsonpaths, (str, os.PathLike)):
        jsonpaths = [jsonpaths]
    if not jsonpaths:
        raise ValueError("cannot load NeRF data from an empty set of paths")

    jsons = []
    for p in jsonpaths:
        with open(p) as f:
            jsons.append(loads_json(f.read()))

    ds = NerfDataset(paths=[], images=[], depths=[], rays=[], metadata=[],
                     xforms_start=np.zeros((0, 3, 4), np.float32),
                     xforms_end=np.zeros((0, 3, 4), np.float32))
    ds.sharpen_amount = sharpen_amount

    # global (per-json, last-wins) settings pass
    enable_ray_loading = True
    enable_depth_loading = True
    white_transparent = False
    black_transparent = False
    depth_scale = -1.0
    for node, jp in zip(jsons, jsonpaths):
        if "normal_mts_args" in node:
            ds.from_mitsuba = True
        if ds.from_mitsuba:
            ds.scale = 0.66
            ds.offset = np.full(3, 0.25 * ds.scale, np.float32)
        if "enable_ray_loading" in node:
            enable_ray_loading = bool(node["enable_ray_loading"])
        if "enable_depth_loading" in node:
            enable_depth_loading = bool(node["enable_depth_loading"])
        if "render_aabb" in node:
            ra = node["render_aabb"]
            ds.render_aabb = BoundingBox(
                np.array(ra[0], np.float32), np.array(ra[1], np.float32))
        if "sharpen" in node:
            ds.sharpen_amount = float(node["sharpen"])
        if "white_transparent" in node:
            white_transparent = bool(node["white_transparent"])
        if "black_transparent" in node:
            black_transparent = bool(node["black_transparent"])
        if "scale" in node:
            ds.scale = float(node["scale"])
        if "importance_sampling" in node:
            ds.wants_importance_sampling = bool(node["importance_sampling"])
        if "n_extra_learnable_dims" in node:
            ds.n_extra_learnable_dims = int(node["n_extra_learnable_dims"])
        if "integer_depth_scale" in node:
            depth_scale = float(node["integer_depth_scale"])
        if "aabb_scale" in node:
            ds.aabb_scale = int(node["aabb_scale"])
        if "offset" in node:
            off = node["offset"]
            ds.offset = (np.array(off, np.float32) if isinstance(off, list)
                         else np.full(3, float(off), np.float32))
        if "aabb" in node:
            # remap the given world box into the unit cube
            aabb = np.array(node["aabb"], np.float32)
            length = max(1e-6, np.abs(aabb[1] - aabb[0]).max())
            ds.scale = 1.0 / length
            ds.offset = (aabb[1] + aabb[0]) * 0.5 * -ds.scale + 0.5
        if "up" in node:
            u = node["up"]
            ds.up = np.array([u[1], u[2], u[0]], np.float32)
        if "envmap" in node:
            # the dataset's lat-long environment map: an EXR loads linear
            # and marks the dataset HDR; an LDR image goes through
            # sRGB -> linear, so the stored radiance is linear either way.
            # It sizes and seeds the testbed's trainable envmap.
            epath = _resolve_path(os.path.dirname(os.path.abspath(jp)),
                                  str(node["envmap"]))
            if not os.path.exists(epath):
                raise FileNotFoundError(
                    f"Environment map {epath!r} does not exist")
            img, env_hdr = _load_frame_image(epath)
            rgba = np.asarray(img, np.float32)
            if env_hdr:
                ds.is_hdr = True
            else:
                rgba /= 255.0
                rgba[..., :3] = srgb_to_linear(rgba[..., :3])
            ds.envmap = rgba

    # per-json frame list assembly
    work = []  # (json_index, frame_dict, base_path, base_lens_info)
    for ji, (node, jp) in enumerate(zip(jsons, jsonpaths)):
        frames = node.get("frames")
        if not isinstance(frames, list):
            continue
        base_path = os.path.dirname(os.path.abspath(jp))
        frames = sorted(frames, key=lambda fr: _natural_key(
            str(fr.get("file_path", ""))))
        for fr in frames:
            fr["file_path"] = str(fr.get("file_path", "")).replace("\\", "/")
            if "depth_path" in fr:
                fr["depth_path"] = str(fr["depth_path"]).replace("\\", "/")
        if "n_frames" in node:
            frames = frames[:int(node["n_frames"])]
        if frames and "sharpness" in frames[0]:
            thresh = float(node.get("sharpness_discard_threshold", 0.0))
            kept = []
            nbh = 3
            for i, fr in enumerate(frames):
                lo, hi = max(0, i - nbh), min(i + nbh, len(frames) - 1)
                window = frames[lo:hi] or [fr]
                mean_sharp = (sum(float(f.get("sharpness", 1.0))
                                  for f in window) / max(len(window), 1))
                path_ok = os.path.exists(
                    _resolve_path(base_path, fr["file_path"]))
                if path_ok and float(fr.get("sharpness", 1.0)) > \
                        thresh * mean_sharp:
                    kept.append(fr)
            frames = kept

        base_lens = Lens()
        base_pp = np.array([0.5, 0.5], np.float32)
        base_rs = np.zeros(4, np.float32)
        _read_lens(node, base_lens, base_pp, base_rs)
        for fr in frames:
            work.append((ji, fr, base_path, (base_lens, base_pp, base_rs)))

    if not work:
        raise ValueError("no training images found for NeRF training")

    def load_one(item):
        ji, frame, base_path, (base_lens, base_pp, base_rs) = item
        node = jsons[ji]
        path = _resolve_path(base_path, frame["file_path"])
        if not os.path.exists(path):
            raise FileNotFoundError(f"could not find image file {path!r}")
        img, is_hdr = _load_frame_image(path)
        h, w = img.shape[:2]
        res = (w, h)

        # alpha sidecar: <file>.alpha.<ext> red channel becomes alpha
        ext = os.path.splitext(path)[1]
        alphapath = os.path.join(base_path,
                                 frame["file_path"] + ".alpha" + ext)
        if os.path.exists(alphapath) and img.dtype == np.uint8:
            a, _ = _load_frame_image(alphapath)
            img = img.copy()
            img[..., 3] = np.asarray(
                255.0 * srgb_to_linear(a[..., 0] / 255.0), np.uint8)

        # dynamic mask: dynamic_mask_<name>.png → hot pink mask color
        maskpath = os.path.join(
            os.path.dirname(path),
            "dynamic_mask_" + os.path.splitext(os.path.basename(path))[0]
            + ".png")
        if os.path.exists(maskpath) and img.dtype == np.uint8:
            m, _ = _load_frame_image(maskpath)
            masked = (m[..., :3] != 0).any(-1)
            img = img.copy()
            img[masked] = np.array([255, 0, 255, 0], np.uint8)  # hot pink

        depth = None
        if enable_depth_loading and depth_scale > 0 and "depth_path" in frame:
            dpath = _resolve_path(base_path, frame["depth_path"])
            if os.path.exists(dpath):
                from PIL import Image

                with Image.open(dpath) as dim:
                    depth = np.asarray(dim).astype(np.float32) * depth_scale

        rays = None
        rayspath = os.path.join(
            os.path.dirname(path),
            "rays_" + os.path.splitext(os.path.basename(path))[0] + ".dat")
        if enable_ray_loading and os.path.exists(rayspath):
            raw = np.fromfile(rayspath, np.float32).reshape(h, w, 6)
            o = raw[..., :3] * ds.scale + ds.offset
            d = raw[..., 3:]
            rays = np.concatenate([o[..., [1, 2, 0]], d[..., [1, 2, 0]]],
                                  axis=-1)

        fl = _read_focal_length(node, res)
        frame_fl = _read_focal_length(frame, res)
        if frame_fl is not None:
            fl = frame_fl
        if fl is None:
            raise ValueError("couldn't read fov")

        lens = Lens(base_lens.mode, base_lens.params.copy())
        pp = base_pp.copy()
        rs = base_rs.copy()
        _read_lens(frame, lens, pp, rs)

        m_start = np.array(
            frame.get("transform_matrix_start",
                      frame.get("transform_matrix")), np.float32)[:3, :4]
        m_end_src = frame.get("transform_matrix_end")
        m_end = (np.array(m_end_src, np.float32)[:3, :4]
                 if m_end_src is not None else m_start)

        light_dir = None
        if "driver_parameters" in frame:
            dp = frame["driver_parameters"]
            ld = np.array([dp.get("LightX", 0.0), dp.get("LightY", 0.0),
                           dp.get("LightZ", 0.0)], np.float32)
            n = np.linalg.norm(ld)
            light_dir = ds.nerf_direction_to_ngp(ld / max(n, 1e-9))

        meta = FrameMetadata(resolution=res, focal_length=fl,
                             principal_point=pp, rolling_shutter=rs,
                             lens=lens, light_dir=light_dir)
        return (frame["file_path"], img, is_hdr, depth, rays, meta,
                ds.nerf_matrix_to_ngp(m_start), ds.nerf_matrix_to_ngp(m_end),
                white_transparent, black_transparent)

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(load_one, work))

    xs, xe = [], []
    for (path, img, is_hdr, depth, rays, meta, m_start, m_end,
         wt, bt) in results:
        ds.paths.append(path)
        if wt or bt:
            img = apply_transparency(img, wt, bt)
        ds.images.append(img)
        ds.is_hdr = ds.is_hdr or is_hdr
        ds.depths.append(depth)
        ds.rays.append(rays)
        ds.has_rays = ds.has_rays or rays is not None
        ds.metadata.append(meta)
        if meta.light_dir is not None:
            ds.has_light_dirs = True
            ds.n_extra_learnable_dims = 0
        xs.append(m_start)
        xe.append(m_end)
    ds.xforms_start = np.stack(xs)
    ds.xforms_end = np.stack(xe)
    return ds


def apply_transparency(img: np.ndarray, white_transparent: bool,
                       black_transparent: bool) -> np.ndarray:
    """white/black_transparent: fully white or black pixels get alpha 0."""
    img = img.copy()
    if img.dtype == np.uint8:
        rgb = img[..., :3]
        if white_transparent:
            img[(rgb == 255).all(-1), 3] = 0
        if black_transparent:
            img[(rgb == 0).all(-1), 3] = 0
    else:
        rgb = img[..., :3].astype(np.float32)
        if white_transparent:
            img[(rgb >= 1.0).all(-1), 3] = 0
        if black_transparent:
            img[(rgb <= 0.0).all(-1), 3] = 0
    return img
