"""Geometry mode: render scenes of several meshes and NeRFs (counterpart of
instant_ngp_tpu/geometry/testbed_geometry.py, the fork's
src/testbed_geometry.cu).

A scene JSON `{"geometry": [{"type": "Mesh" | "Nerf", "path", "center",
"scale"}]}` places objects. Mesh objects are ray-traced on the host
through their triangle BVHs (`geom/triangle_bvh.py`) and shaded with the
Disney BRDF (`sdf/brdf.py`); NeRF objects are snapshots (`.ingp`) of a
NeRF, marched on the device with 128 fixed steps between their box's
entry and the nearer of its exit and the mesh hit, through the fused MLP
kernel, and composited in front of the meshes. Training is a no-op, as in
the fork.

As in the JAX package, a NeRF object renders with the snapshot's raw
parameters (`trainer.params`, not the Ema copy a NeRF testbed renders
with) and ignores its density grid. Unlike the JAX package, which marches
bands of 2^15 rays (4.2 M samples) whatever their size, the march here
takes only the rays that enter an object's box before the mesh, in chunks
of at most `nerf_chunk_samples` samples (2^21, 16,384 rays); rays that
miss the box add nothing in either package, so the frame is the same.

Snapshots are self-contained: mesh objects embed their triangles and BRDF,
NeRF objects their config, parameters and density grid, in the JAX
package's layout, so a scene saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..common import TestbedMode
from ..config import loads_json
from ..convert import geometry_objects_from_jax, params_to_jax
from ..geom.triangle_bvh import TriangleBvh, load_obj
from ..sdf.brdf import BRDFParams, evaluate_shading
from .geometry_bvh import GeometryBvh

#: fixed march steps per ray through a NeRF object's box
NERF_OBJECT_STEPS = 128


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for but none is "
                           "available")
    return dev


class MeshObject:
    """A mesh placed in the scene: `scale` about the mesh's own centroid,
    then moved by `center` (the fork's MeshData)."""

    def __init__(self, path: str, center, scale: float = 1.0):
        tris = load_obj(path) if path else np.zeros((0, 3, 3), np.float32)
        center = np.asarray(center, np.float32)
        if len(tris) and scale != 1.0:
            centroid = tris.reshape(-1, 3).mean(0)
            tris = (tris - centroid) * float(scale) + centroid
        self._place(center, (tris + center).astype(np.float32), BRDFParams())

    @classmethod
    def from_state(cls, center, triangles, brdf: BRDFParams) -> "MeshObject":
        m = cls.__new__(cls)
        m._place(np.asarray(center, np.float32),
                 np.asarray(triangles, np.float32), brdf)
        return m

    def _place(self, center, triangles, brdf) -> None:
        self.center = center
        self.triangles = triangles
        if len(triangles):
            flat = triangles.reshape(-1, 3)
            self.aabb = (flat.min(0), flat.max(0))
            self.scale = float((self.aabb[1] - self.aabb[0]).max())
            self.bvh: Optional[TriangleBvh] = TriangleBvh(triangles,
                                                          leaf_size=8)
        else:
            self.aabb = (np.zeros(3, np.float32), np.zeros(3, np.float32))
            self.scale = 1.0
            self.bvh = None
        self.brdf = brdf


class NerfObject:
    """A NeRF snapshot placed in the scene: the port's `NerfNetwork` at the
    snapshot's own config and `aabb_scale`, on `device`, its box the unit
    cube scaled by min(aabb_scale, 128) about 0.5, moved by `center`. A
    path that is not a snapshot on disk, or `load=False`, gives an empty
    object."""

    def __init__(self, path: str, center, device=None, load: bool = True):
        from ..data.snapshot import load_snapshot

        self.center = np.asarray(center, np.float32)
        self.path = path
        self.device = _device(device)
        self.model = None
        self.config = None
        self.aabb = (self.center + 0.0, self.center + 1.0)
        if load and path.endswith((".ingp", ".msgpack")) \
                and os.path.exists(path):
            snap = load_snapshot(path)
            # the raw parameters, as the JAX object takes them
            self._init_model(snap["config"], int(snap["aabb_scale"]),
                             snap["trainer"]["params"],
                             snap["density_grid"].numpy())

    def _init_model(self, cfg, aabb_scale: int, params, density_grid
                    ) -> None:
        """`params`: the port's tree (tensors, interleaved grid)."""
        from ..nerf.model import NerfNetwork

        self.config = cfg
        self.aabb_scale = aabb_scale
        self.model = NerfNetwork(
            3, 3, 0, cfg["encoding"],
            cfg.get("dir_encoding",
                    {"otype": "SphericalHarmonics", "degree": 4}),
            cfg["network"], cfg.get("rgb_network", cfg["network"]),
            aabb_scale=aabb_scale, compute_dtype=torch.bfloat16)
        self.model.load_params(params)
        self.model.to(self.device)
        self.density_grid = np.asarray(density_grid, np.float32)
        side = min(aabb_scale, 128)
        lo = np.full(3, 0.5 - side / 2, np.float32) + self.center
        hi = np.full(3, 0.5 + side / 2, np.float32) + self.center
        self.aabb = (lo, hi)


class GeometryTestbed:
    mode = TestbedMode.Geometry
    #: most samples (rays x 128 steps) of one chunk of a NeRF object's march
    nerf_chunk_samples = 1 << 21

    def __init__(self, scene_path: str, network_config=None,
                 seed: int = 1337, device=None):
        self.device = _device(device)
        with open(scene_path) as f:
            scene = loads_json(f.read())
        base = os.path.dirname(os.path.abspath(scene_path))
        self.meshes: List[MeshObject] = []
        self.nerfs: List[NerfObject] = []
        for g in scene.get("geometry", []):
            path = g.get("path", "")
            if path and not os.path.isabs(path):
                path = os.path.join(base, path)
            elif path and not os.path.exists(path):
                # scene files may name absolute paths of another machine:
                # look for the basename in objs/ beside the scene
                cand = os.path.join(base, "objs", os.path.basename(path))
                if os.path.exists(cand):
                    path = cand
            center = g.get("center", [0.0, 0.0, 0.0])
            if g.get("type") == "Mesh":
                self.meshes.append(MeshObject(path, center,
                                              g.get("scale", 1.0)))
            elif g.get("type") == "Nerf":
                self.nerfs.append(NerfObject(path, center, self.device))
        self._init_state()

    def _init_state(self) -> None:
        self._build_bvhs()
        self.training_step = 0
        self.loss_scalar = float("nan")
        self.sun_dir = np.array([0.577, -0.577, 0.577], np.float32)
        # points TOWARD the light (the shading convention)
        self.light_dir = np.array([0.577, 0.577, 0.577], np.float32)
        self.background_color = np.array([1.0, 1.0, 1.0], np.float32)
        #: NeRF-object samples of the last frame
        self.last_frame_n_samples = 0

    def _build_bvhs(self) -> None:
        self.mesh_bvh = GeometryBvh([m.aabb for m in self.meshes]) \
            if self.meshes else None
        self.nerf_bvh = GeometryBvh([n.aabb for n in self.nerfs]) \
            if self.nerfs else None

    def train(self, n_steps: int = 1, **kw) -> float:
        """A no-op: nothing is trained in Geometry mode."""
        return self.loss_scalar

    def trace_meshes(self, origins: np.ndarray, dirs: np.ndarray):
        """Nearest mesh hit over all objects: (t, object, triangle), -1
        where none is hit."""
        n = len(origins)
        best_t = np.full(n, 1e10, np.float32)
        best_obj = np.full(n, -1, np.int32)
        best_tri = np.full(n, -1, np.int32)
        if not self.meshes:
            return best_t, best_obj, best_tri
        mask = self.mesh_bvh.intersect_mask(origins, dirs)
        for oi, mesh in enumerate(self.meshes):
            if mesh.bvh is None:
                continue
            sel = np.nonzero(mask[:, oi])[0]
            if len(sel) == 0:
                continue
            t, tri = mesh.bvh.ray_trace(origins[sel], dirs[sel])
            hit = (tri >= 0) & (t < best_t[sel])
            upd = sel[hit]
            best_t[upd] = t[hit]
            best_obj[upd] = oi
            best_tri[upd] = tri[hit]
        return best_t, best_obj, best_tri

    def _shade(self, mesh: MeshObject, view: np.ndarray, normals: np.ndarray
               ) -> np.ndarray:
        dev = self.device

        def vec(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        light = self.light_dir / np.linalg.norm(self.light_dir)
        shade = evaluate_shading(
            vec(mesh.brdf.basecolor),
            vec(np.maximum(mesh.brdf.ambientcolor, 0.08)),
            torch.ones(3, device=dev), mesh.brdf, vec(light), vec(view),
            vec(normals))
        return shade.cpu().numpy()

    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length: Optional[float] = None,
                     render_mode: str = "Shade") -> np.ndarray:
        """(H, W, 4) linear RGBA. Meshes ray-traced and shaded (or their
        normals, or depth), NeRF objects composited in front of them, the
        background behind."""
        from ..nerf.render import camera_rays_for_frame

        fl = focal_length or width * 1.1
        origins_t, dirs_t = camera_rays_for_frame(
            width, height, (fl, fl), np.asarray(camera_matrix, np.float32),
            device=self.device)
        origins = origins_t.cpu().numpy()
        dirs = dirs_t.cpu().numpy()

        t, obj, tri = self.trace_meshes(origins, dirs)
        hit = obj >= 0
        normals = np.zeros_like(origins)
        color = np.zeros((len(origins), 3), np.float32)
        for oi, mesh in enumerate(self.meshes):
            sel = np.nonzero(hit & (obj == oi))[0]
            if len(sel) == 0:
                continue
            n = mesh.bvh.triangle_normals()[tri[sel]]
            # face normals toward the viewer
            flip = np.sum(n * dirs[sel], -1) > 0
            n[flip] = -n[flip]
            normals[sel] = n
            color[sel] = self._shade(mesh, -dirs[sel], n)

        if render_mode == "Normals":
            color = np.where(hit[:, None], normals * 0.5 + 0.5, color)
        elif render_mode == "Depth":
            color = np.repeat(np.where(hit, t, 0.0)[:, None], 3, -1)

        alpha = hit.astype(np.float32)
        self.last_frame_n_samples = 0
        for nerf in self.nerfs:
            if nerf.model is None:
                continue
            rgb_n, alpha_n, _ = self._march_nerf_object(
                nerf, origins, dirs, np.where(hit, t, 1e10))
            in_front = alpha_n > 1e-3
            color = np.where(in_front[:, None],
                             rgb_n + (1 - alpha_n[:, None]) * color, color)
            alpha = np.where(in_front, alpha_n + (1 - alpha_n) * alpha,
                             alpha)

        color = np.where(alpha[:, None] > 0,
                         color + (1 - alpha[:, None]) * self.background_color,
                         self.background_color)
        rgba = np.concatenate([color, alpha[:, None]], -1)
        return rgba.reshape(height, width, 4).astype(np.float32)

    def _march_nerf_object(self, nerf: NerfObject, origins: np.ndarray,
                           dirs: np.ndarray, t_max: np.ndarray,
                           chunk_samples: Optional[int] = None):
        """Fixed-step march of one NeRF object -> numpy (rgb (R, 3), alpha
        (R,), depth (R,)).

        Each ray takes NERF_OBJECT_STEPS steps between the box's entry and
        min(box exit, t_max), in the object's own frame, through the density
        and RGB nets under `torch.no_grad()` (the fused kernel on the card),
        Exponential density, Logistic colour, composited with a cumulative
        product. Only rays with a step longer than 0 are evaluated, in chunks
        of at most `chunk_samples` samples; the others add nothing."""
        from ..nerf.march import (ray_intersect_aabb, warp_direction,
                                  warp_position)
        from ..nerf.model import network_to_density, network_to_rgb

        steps = NERF_OBJECT_STEPS
        chunk = max(1, (chunk_samples or self.nerf_chunk_samples) // steps)
        dev = self.device
        n = len(origins)
        rgb_out = np.zeros((n, 3), np.float32)
        alpha_out = np.zeros(n, np.float32)
        depth_out = np.zeros(n, np.float32)

        center = torch.as_tensor(nerf.center, device=dev)
        lo = torch.as_tensor(nerf.aabb[0], device=dev)
        hi = torch.as_tensor(nerf.aabb[1], device=dev)
        o_all = torch.as_tensor(np.asarray(origins, np.float32), device=dev)
        d_all = torch.as_tensor(np.asarray(dirs, np.float32), device=dev)
        tmin, tmax_box = ray_intersect_aabb(o_all, d_all, lo, hi)
        tmin = tmin.clamp(min=0.0)
        tmax = torch.minimum(tmax_box, torch.as_tensor(
            np.asarray(t_max, np.float32), device=dev))
        dt_all = (tmax - tmin) / steps
        live = torch.nonzero(dt_all > 0).squeeze(1)
        offsets = torch.arange(steps, device=dev, dtype=torch.float32) + 0.5
        parts = []
        with torch.no_grad():
            for start in range(0, live.numel(), chunk):
                idx = live[start:start + chunk]
                o, d, dt = o_all[idx], d_all[idx], dt_all[idx]
                ts = tmin[idx, None] + offsets[None, :] * dt[:, None]
                pos = o[:, None, :] + ts[..., None] * d[:, None, :]
                warped = warp_position(pos - center, lo - center,
                                       hi - center)
                dirs_w = warp_direction(d)[:, None, :].expand_as(pos)
                raw = nerf.model.apply_components(
                    warped.reshape(-1, 3), dirs_w.reshape(-1, 3)
                ).reshape(len(idx), steps, 4)
                sigma = network_to_density(raw[..., 3], "Exponential")
                rgb = network_to_rgb(raw[..., :3], "Logistic")
                alpha = 1.0 - torch.exp(-sigma * dt[:, None])
                trans = torch.cumprod(1.0 - alpha, dim=-1)
                t_before = torch.cat([torch.ones_like(trans[:, :1]),
                                      trans[:, :-1]], dim=-1)
                w = alpha * t_before
                parts.append((idx, (w[..., None] * rgb).sum(1), w.sum(1),
                              (w * ts).sum(1)))
        self.last_frame_n_samples += live.numel() * steps
        for idx, rgb_r, alpha_r, depth_r in parts:
            i = idx.cpu().numpy()
            rgb_out[i] = rgb_r.cpu().numpy()
            alpha_out[i] = alpha_r.cpu().numpy()
            depth_out[i] = depth_r.cpu().numpy()
        return rgb_out, alpha_out, depth_out

    # -- snapshots ------------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        """The scene, self-contained, in the JAX package's format."""
        from ..data.snapshot import save_snapshot as _save

        objects: List[Dict[str, Any]] = []
        for m in self.meshes:
            objects.append({
                "type": "Mesh",
                "center": np.asarray(m.center, np.float32),
                "triangles": (m.triangles
                              - m.center[None, None, :]).astype(np.float32),
                "brdf": dataclasses.asdict(m.brdf),
            })
        for n in self.nerfs:
            entry: Dict[str, Any] = {
                "type": "Nerf",
                "center": np.asarray(n.center, np.float32),
                "path": n.path,
            }
            if n.model is not None:
                entry["nerf"] = {
                    "config": n.config,
                    "aabb_scale": n.aabb_scale,
                    "params": params_to_jax(n.model.param_tree()),
                    "density_grid": n.density_grid,
                }
            objects.append(entry)
        _save(path, {
            "mode": "geometry",
            "objects": objects,
            "sun_dir": self.sun_dir,
            "light_dir": self.light_dir,
            "background_color": self.background_color,
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        """A Geometry snapshot's payload (arrays as numpy, as
        `data/snapshot.py::load_snapshot` returns it) replaces the scene."""
        self.meshes, self.nerfs = [], []
        for entry in geometry_objects_from_jax(snapshot.get("objects", [])):
            center = np.asarray(entry["center"], np.float32)
            if entry["type"] == "Mesh":
                brdf = BRDFParams(**{
                    k: tuple(v) if isinstance(v, (list, np.ndarray)) else v
                    for k, v in entry.get("brdf", {}).items()})
                self.meshes.append(MeshObject.from_state(
                    center, np.asarray(entry["triangles"], np.float32)
                    + center[None, None, :], brdf))
            elif entry["type"] == "Nerf":
                n = NerfObject(entry.get("path", ""), center, self.device,
                               load=False)
                if "nerf" in entry:
                    state = entry["nerf"]
                    n._init_model(state["config"], int(state["aabb_scale"]),
                                  state["params"], state["density_grid"])
                self.nerfs.append(n)
        self._build_bvhs()
        for k in ("sun_dir", "light_dir", "background_color"):
            if k in snapshot:
                setattr(self, k, np.asarray(snapshot[k], np.float32))

    @classmethod
    def from_snapshot(cls, snapshot: Dict[str, Any], device=None
                      ) -> "GeometryTestbed":
        tb = cls.__new__(cls)
        tb.device = _device(device)
        tb.meshes, tb.nerfs = [], []
        tb._init_state()
        tb.load_snapshot_state(snapshot)
        return tb
