"""Plain NeRF of the reference: training rays from the images, the march
through the occupancy bitfield, ray-major compaction, the density update,
the camera-visibility mask, the network, the composite with its Huber loss
and regularizers, and the front-to-back render of a frame.

The geometry (rays, stepping space, Morton order, the bitfield) is a
frozen copy of the arithmetic of the port's plain modules (`camera.py`,
`nerf/march.py`, `nerf/sampler.py`, `nerf/occupancy.py`,
`nerf/visibility.py`, `nerf/training.py`, `nerf/render.py`), operation for
operation, so that the same inputs on the same device give the same
rays, cells and samples; it imports nothing of the program. The networks
run in float32 (`nets.py`), or in the control's precision; the position
and direction encodings are the configuration's, built by their `otype`
(`encodings/`).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch

from . import encodings
from .nets import FP32, Adam, Precision, huber, layer_dims, mlp, xavier

GRIDSIZE = 128
CASCADES = 8
N_CELLS = GRIDSIZE ** 3
MIN_STEP = math.sqrt(3.0) / 1024.0
MIN_OPTICAL_THICKNESS = 0.01
TRAIN_EPSILON = 1e-4
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------- geometry
def _expand_bits(v):
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(x, y, z):
    return (_expand_bits(x.long() & M32) | (_expand_bits(y.long() & M32) << 1)
            | (_expand_bits(z.long() & M32) << 2))


def morton3d_invert(i):
    x = i.long() & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton3d_coords(idx):
    return morton3d_invert(idx), morton3d_invert(idx >> 1), \
        morton3d_invert(idx >> 2)


def to_stepping_space(t, cone_angle):
    if cone_angle > 1e-5:
        raise NotImplementedError("the reference covers unit scenes (cone 0)")
    return t / MIN_STEP


def from_stepping_space(n, cone_angle):
    if cone_angle > 1e-5:
        raise NotImplementedError("the reference covers unit scenes (cone 0)")
    return n * MIN_STEP


def advance_n_steps(t, cone_angle, n):
    return from_stepping_space(to_stepping_space(t, cone_angle) + n,
                               cone_angle)


def calc_dt(t, cone_angle):
    return advance_n_steps(t, cone_angle, 1.0) - t


def ray_intersect_aabb(o, d, lo, hi):
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    idir = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
    t1 = (lo - o) * idir
    t2 = (hi - o) * idir
    return torch.minimum(t1, t2).amax(dim=-1), \
        torch.maximum(t1, t2).amin(dim=-1)


def mip_from_pos(pos, max_cascade):
    maxval = (pos - 0.5).abs().amax(dim=-1)
    _, exponent = torch.frexp(maxval)
    return (exponent + 1).clamp(0, max_cascade)


def mip_from_dt(dt, pos, max_cascade):
    mip = mip_from_pos(pos, max_cascade)
    d = dt * 2 * GRIDSIZE
    _, exponent = torch.frexp(d)
    return torch.where(d < 1.0, mip,
                       torch.maximum(mip, exponent).clamp(max=max_cascade))


def occupied_at(pos, bitfield, mip):
    mip_scale = torch.exp2(-mip.float())[..., None]
    p = (pos - 0.5) * mip_scale + 0.5
    i = torch.floor(p * GRIDSIZE).long()
    valid = ((i >= 0) & (i < GRIDSIZE)).all(dim=-1)
    i = i.clamp(0, GRIDSIZE - 1)
    idx = morton3d(i[..., 0], i[..., 1], i[..., 2])
    byte = bitfield[idx // 8 + mip.long() * (N_CELLS // 8)]
    return valid & (((byte.long() >> (idx % 8)) & 1) != 0)


# ------------------------------------------------------------------ cameras
def _mat3_to_quat(m):
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
    q = torch.where((tr > 0)[..., None], q0, torch.where(
        ((m00 > m11) & (m00 > m22))[..., None], q1,
        torch.where((m11 > m22)[..., None], q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def _quat_to_mat3(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _mat3_slerp(a, b, t):
    qa, qb = _mat3_to_quat(a), _mat3_to_quat(b)
    dot = (qa * qb).sum(dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)
    dot = dot.abs()
    theta = torch.arccos(dot.clamp(-1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = sin_theta < 1e-5
    safe_sin = torch.where(near, 1.0, sin_theta)
    w_a = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w_b = torch.where(near, t, torch.sin(t * theta) / safe_sin)
    q = w_a * qa + w_b * qb
    return _quat_to_mat3(q / torch.linalg.norm(q, dim=-1, keepdim=True))


def camera_at(xs, xe, rolling, uv, mb_time):
    """The per-pixel camera (rolling shutter + motion blur slerp)."""
    t = (rolling[..., 0] + rolling[..., 1] * uv[..., 0]
         + rolling[..., 2] * uv[..., 1] + rolling[..., 3] * mb_time)
    t = t[..., None, None]
    rot = _mat3_slerp(xs[..., :3, :3], xe[..., :3, :3], t[..., 0])
    trans = xs[..., :3, 3:] * (1 - t) + xe[..., :3, 3:] * t
    return torch.cat([rot, trans], dim=-1)


def pinhole_rays(uv, res, focal, cam, center=(0.5, 0.5)):
    """-> (origin, unnormalized dir); res, focal (2,) or (N, 2)."""
    center = torch.as_tensor(center, dtype=torch.float32, device=uv.device)
    res = torch.as_tensor(res, dtype=torch.float32, device=uv.device)
    x = (uv[..., 0] - center[..., 0]) * res[..., 0] / focal[..., 0]
    y = (uv[..., 1] - center[..., 1]) * res[..., 1] / focal[..., 1]
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rot = cam[..., :3, :3]
    d = (rot * d[..., None, :]).sum(dim=-1)
    origin = cam[..., :3, 3].expand_as(d)
    return origin + d * 0.0, d


# -------------------------------------------------------------- the scene
class SceneData(NamedTuple):
    """The training images and cameras as the program packs them."""

    pixels: torch.Tensor        # (N, H, W, 4) uint8, sRGB, straight alpha
    resolutions: torch.Tensor   # (N, 2) float32
    xforms: torch.Tensor        # (N, 3, 4)
    focal: torch.Tensor         # (N, 2)
    rolling: torch.Tensor       # (N, 4) zeros

    @property
    def n_images(self):
        return self.pixels.shape[0]


def read_rgba(pixels, img_idx, px):
    h, w = pixels.shape[1], pixels.shape[2]
    x = px[:, 0].long().clamp(0, w - 1)
    y = px[:, 1].long().clamp(0, h - 1)
    raw = pixels[img_idx.long(), y, x]
    val = raw.float() / 255.0
    rgb, alpha = val[:, :3], val[:, 3:4]
    lin = torch.where(rgb <= 0.04045, rgb / 12.92,
                      torch.pow((rgb + 0.055) / 1.055, 2.4))
    out = torch.cat([lin * alpha, alpha], dim=-1)
    masked = ((raw[:, 0] == 255) & (raw[:, 1] == 0) & (raw[:, 2] == 255)
              & (raw[:, 3] == 0))
    return torch.where(masked[:, None], -1.0, out)


def build_rays(data: SceneData, img_idx, uv, mb_time):
    xform = camera_at(data.xforms[img_idx], data.xforms[img_idx],
                      data.rolling[img_idx], uv, mb_time)
    origin, d = pinhole_rays(uv, data.resolutions[img_idx],
                             data.focal[img_idx], xform)
    return origin, d / torch.linalg.norm(d, dim=-1, keepdim=True)


def derive_n_march(data: SceneData, lo, hi):
    """March candidates per ray for these cameras (as the program derives
    them): the widest stepping-space span over a sparse pixel grid, +10 %
    and 32, rounded up to 128, at most 1024."""
    dev = lo.device
    n = data.n_images
    lin = torch.linspace(0.02, 0.98, 8, device=dev)
    uv1 = torch.stack(torch.meshgrid(lin, lin, indexing="xy"),
                      -1).reshape(-1, 2)
    uv = uv1.repeat(n, 1)
    idx = torch.arange(n, device=dev).repeat_interleave(uv1.shape[0])
    o, d = build_rays(data, idx, uv, torch.zeros(idx.shape[0], device=dev))
    tmin, tmax = ray_intersect_aabb(o, d, lo, hi)
    tmin = tmin.clamp(min=0.0)
    span = torch.where(tmax > tmin, to_stepping_space(tmax, 0.0)
                       - to_stepping_space(tmin, 0.0), 0.0)
    need = int(float(span.max()) * 1.1) + 32
    return min(max((need + 127) // 128 * 128, 128), 1024)


def visible_cells(data: SceneData, chunk: int = 1 << 18):
    """Cells some training camera sees a corner of (pinhole lenses)."""
    dev = data.xforms.device
    offs = torch.tensor([[cx, cy, cz] for cx in (0, 1) for cy in (0, 1)
                         for cz in (0, 1)], dtype=torch.float32, device=dev)
    out = torch.zeros(N_CELLS, dtype=torch.bool, device=dev)
    pp = torch.tensor([0.5, 0.5], device=dev)
    for start in range(0, N_CELLS, chunk):
        flat = torch.arange(start, min(start + chunk, N_CELLS), device=dev)
        level = flat // N_CELLS
        grid = torch.stack(morton3d_coords(flat % N_CELLS), -1)
        mip = torch.exp2(level.float())[:, None]
        base = (grid.float() / GRIDSIZE - 0.5) * mip + 0.5
        corners = base[:, None, :] + (mip / GRIDSIZE)[:, None, :] * offs[None]
        seen = torch.zeros(flat.shape[0], dtype=torch.bool, device=dev)
        for i in range(data.n_images):
            xform = data.xforms[i]
            rot, cam_o = xform[:3, :3], xform[:3, 3]
            dx, dy, dz = (corners - cam_o).unbind(dim=-1)
            cx = rot[0, 0] * dx + rot[1, 0] * dy + rot[2, 0] * dz
            cy = rot[0, 1] * dx + rot[1, 1] * dy + rot[2, 1] * dz
            cz = rot[0, 2] * dx + rot[1, 2] * dy + rot[2, 2] * dz
            norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
            in_front = cz / norm.clamp(min=1e-9) > 1e-4
            safe_z = torch.where(cz.abs() < 1e-9, 1e-9, cz)
            fl, res = data.focal[i], data.resolutions[i]
            u = cx / safe_z * fl[0] / res[0] + pp[0]
            v = cy / safe_z * fl[1] / res[1] + pp[1]
            inside = (u > 0) & (u < 1) & (v > 0) & (v < 1)
            seen |= (in_front & inside).any(dim=-1)
        out[start:start + chunk] = seen
    return out


def cell_positions(indices, jitter):
    level = indices // N_CELLS
    coords = torch.stack(morton3d_coords(indices % N_CELLS), -1)
    mip_scale = torch.exp2(level.float())[:, None]
    p = (coords.float() + jitter) / GRIDSIZE - 0.5
    return p * mip_scale + 0.5


def _pooled_centre_index(device):
    x, y, z = morton3d_coords(torch.arange(64 ** 3, device=device))
    q = GRIDSIZE // 4
    return morton3d(x + q, y + q, z + q)


def density_mean(grid):
    return grid[:N_CELLS].clamp(min=0.0).mean()


def bitfield_of(grid, max_cascade: int = 0):
    thresh = torch.clamp(density_mean(grid), max=MIN_OPTICAL_THICKNESS)
    occupied = grid > thresh
    n_present = grid.shape[0] // N_CELLS
    centre = _pooled_centre_index(grid.device)
    levels = [occupied[:N_CELLS]]
    for m in range(1, CASCADES):
        if m < n_present and m <= max_cascade:
            level = occupied[m * N_CELLS:(m + 1) * N_CELLS].clone()
        else:
            level = torch.zeros(N_CELLS, dtype=torch.bool, device=grid.device)
        level[centre] |= levels[-1].view(-1, 8).any(dim=-1)
        levels.append(level)
    bits = torch.cat(levels).view(-1, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.uint8)


def march(origins, dirs, t_start, valid, bitfield, lo, hi, n_march,
          max_samples):
    """-> (ts, emit), each (R, n_march)."""
    s0 = to_stepping_space(t_start, 0.0)
    k = torch.arange(n_march, dtype=torch.float32, device=s0.device)
    ts = from_stepping_space(s0[:, None] + k[None, :], 0.0)
    dts = calc_dt(ts, 0.0)
    pos = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
    inside = ((pos >= lo) & (pos <= hi)).all(dim=-1)
    mip = mip_from_dt(dts, pos, 0).clamp(0, 0)
    emit = inside & occupied_at(pos, bitfield, mip) & valid[:, None]
    emit &= torch.cumsum(emit, dim=1) <= max_samples
    return ts, emit


# ------------------------------------------------------------- the network
# the program's direction encoding where the configuration names none
DIR_ENCODING = {"otype": "SphericalHarmonics", "degree": 4}


class NerfModel:
    """A NeRF configuration's encodings (built by `otype`, `encodings/`)
    and the widths of its nets: the density net from the position
    features to `n_output_dims` (16) outputs, the RGB net from those and
    the direction features to 3."""

    def __init__(self, cfg: dict):
        # a grid takes its scales from HashGrid.build's defaults: the
        # unit box that NerfTrainer marches
        self.pos = encodings.build(3, cfg["encoding"])
        self.dir = encodings.build(3, cfg.get("dir_encoding", DIR_ENCODING))
        if self.dir.n_leaves:
            raise NotImplementedError("the program's direction encodings "
                                      "carry no parameters")
        n_dens = int(cfg["network"].get("n_output_dims", 16))
        self.density_dims = layer_dims(self.pos.n_output, n_dens,
                                       cfg["network"])
        self.rgb_dims = layer_dims(n_dens + self.dir.n_output, 3,
                                   cfg.get("rgb_network", cfg["network"]))
        self.until = cfg["encoding"].get("stochastic_corners_until")

    def stochastic_at(self, step: int) -> bool:
        """Whether train step `step` (and the density update before it)
        encodes with the stochastic-corner estimator: where the position
        encoding has one, before `stochastic_corners_until`."""
        return self.pos.stochastic and (self.until is None
                                        or step < self.until)

    def params(self, leaves: List[torch.Tensor]) -> "NerfParams":
        """The flat leaves, in the program's order, as NerfParams."""
        n_pos, n_dens = self.pos.n_leaves, len(self.density_dims)
        return NerfParams(self, leaves[:n_pos],
                          leaves[n_pos:n_pos + n_dens],
                          leaves[n_pos + n_dens:])


class NerfParams:
    """The trained leaves, in the program's order: the position encoding's
    (a table, or none), the density net's matrices, the RGB net's."""

    def __init__(self, model: NerfModel, pos, density, rgb):
        self.model = model
        self.pos, self.density, self.rgb = list(pos), list(density), \
            list(rgb)

    def leaves(self) -> List[torch.Tensor]:
        return self.pos + self.density + self.rgb

    def l2_mask(self) -> List[bool]:
        """L2 on the nets' matrices, never on an encoding's leaves."""
        return [False] * len(self.pos) + [True] * (len(self.density)
                                                   + len(self.rgb))

    def program_layout(self) -> Dict[str, object]:
        """The leaves in the program's parameter layout."""
        return {"pos_encoding": self.pos[0] if self.pos else None,
                "density_net": self.density, "dir_encoding": None,
                "rgb_net": self.rgb}


def nerf_init(model: NerfModel, gen: torch.Generator,
              table_range: float = 1e-4) -> NerfParams:
    """Seeded weights on the generator's device: the position encoding's
    leaves (a table U(-r, r): instant-ngp's 1e-4, or a trained scale),
    then the nets Xavier-uniform."""
    pos = model.pos.init(gen, table_range)
    dens = [xavier(i, o, gen) for i, o in model.density_dims]
    rgb = [xavier(i, o, gen) for i, o in model.rgb_dims]
    return NerfParams(model, pos, dens, rgb)


def nerf_forward(p: NerfParams, feats, dirs_warped, prec: Precision = FP32):
    """Position features (N, pos.n_output), warped directions (N, 3) ->
    raw (N, 4) = (r, g, b, density)."""
    dens = mlp(p.density, feats, prec)
    rgb_in = torch.cat([dens, p.model.dir.encode([], dirs_warped)], dim=-1)
    return torch.cat([mlp(p.rgb, rgb_in, prec), dens[:, :1]], dim=-1)


def _linear_to_srgb(x):
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x.clamp(min=1e-12), 1.0 / 2.4)
                       - 0.055)


def _srgb_to_linear(x):
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x.clamp(min=0.0) + 0.055) / 1.055, 2.4))


# --------------------------------------------------------------- training
class NerfTrainer:
    """The program's first train steps, replayed: the same generator
    sequence (density-update jitter and corners, the step's rays and
    corners), the same rays, cells and samples, a float32 network. The
    encode is the configuration's (`NerfModel.stochastic_at`): the
    stochastic-corner estimator's corners are drawn only where it runs.

    `drop_half` plants the fault "half the batch left out, the mean taken
    over the rest": the second half of the ray lanes carries no loss."""

    target_batch = 1 << 18
    rays_per_batch = 1 << 12
    warmup_full_sweeps = 4

    def __init__(self, data: SceneData, cfg: dict, params: NerfParams,
                 seed: int, prec: Precision = FP32, drop_half: bool = False):
        dev = data.pixels.device
        self.data, self.cfg, self.p, self.prec = data, cfg, params, prec
        self.drop_half = drop_half
        self.model = params.model
        self.lo = torch.zeros(3, device=dev)
        self.hi = torch.ones(3, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.opt = Adam(cfg["optimizer"], params.leaves(), params.l2_mask())
        self.n_march = derive_n_march(data, self.lo, self.hi)
        self.density_grid = torch.zeros(N_CELLS, device=dev)
        self.visible = None
        self.bitfield = None
        self.step_index = 0

    def ema_params(self) -> NerfParams:
        return self.model.params(self.opt.ema)

    @torch.no_grad()
    def density_update(self, decay: float = 0.95, chunk: int = 1 << 19):
        """A full sweep (the first steps): a jittered point in every cell,
        the EMA network (one sampled corner a level where the encode is
        stochastic)."""
        if self.step_index == 0:
            self.visible = visible_cells(self.data)
            self.density_grid = torch.where(
                self.visible, self.density_grid.clamp(min=0.0), -1.0)
        if self.step_index >= self.warmup_full_sweeps:
            raise NotImplementedError("the reference replays the warm-up")
        idx = torch.arange(N_CELLS, device=self.lo.device)
        jitter = torch.rand(N_CELLS, 3, device=self.lo.device,
                            generator=self.gen)
        net = self.ema_params()
        dens = torch.empty(N_CELLS, device=self.lo.device)
        enc = self.model.pos
        stochastic = self.model.stochastic_at(self.step_index)
        for i in range(0, N_CELLS, chunk):
            pos = cell_positions(idx[i:i + chunk], jitter[i:i + chunk])
            if stochastic:
                feats = enc.encode_stochastic(
                    net.pos, pos, enc.draws(self.gen, pos.shape[0], 0), 0)
            else:
                feats = enc.encode(net.pos, pos)
            raw = mlp(net.density, feats, self.prec)[:, 0]
            dens[i:i + chunk] = torch.exp(raw)
        tmp = torch.zeros_like(self.density_grid).scatter_reduce_(
            0, idx, dens * MIN_STEP, reduce="amax")
        self.density_grid = torch.where(
            self.density_grid < 0.0, self.density_grid,
            torch.maximum(self.density_grid * decay, tmp))
        self.bitfield = bitfield_of(self.density_grid)

    def step(self) -> Dict[str, object]:
        """One train step -> {"loss", "grads" (the optimizer's, L2 in),
        "samples"}; the parameters and moments are updated in place."""
        data, dev, enc = self.data, self.lo.device, self.model.pos
        stochastic = self.model.stochastic_at(self.step_index)
        n_rays = self.rays_per_batch
        k = self.target_batch // n_rays * 4
        k = min(max(1 << int(math.ceil(math.log2(max(k, 8)))), 8), 1024)

        def uniform(*shape):
            return torch.rand(*shape, generator=self.gen, device=dev)

        mb_time, start_jitter, bg = uniform(n_rays), uniform(n_rays), \
            uniform(n_rays, 3)
        img_idx = torch.randint(0, data.n_images, (n_rays,),
                                generator=self.gen, device=dev)
        uv = uniform(n_rays, 2)
        with torch.no_grad():
            img_idx = img_idx.long()
            px = (uv * data.resolutions[img_idx]).to(torch.int32)
            rgba = read_rgba(data.pixels, img_idx, px)
            valid = rgba[:, 0] >= 0.0
            origins, dirs = build_rays(data, img_idx, uv, mb_time)
            tmin, tmax = ray_intersect_aabb(origins, dirs, self.lo, self.hi)
            tmin = tmin.clamp(min=0.0)
            valid = valid & (tmax >= tmin)
            t_start = advance_n_steps(tmin, 0.0, start_jitter)
            ts, emit = march(origins, dirs, t_start, valid, self.bitfield,
                             self.lo, self.hi, self.n_march, k)
            cap = self.target_batch
            e = emit.long()
            count = e.sum(dim=1)
            base = torch.cumsum(count, dim=0) - count
            rank = base[:, None] + (torch.cumsum(e, dim=1) - e)
            n_total = n_rays * self.n_march
            cand_slot = torch.where(emit, rank, cap).clamp(max=cap)
            src = torch.full((cap + 1,), n_total, dtype=torch.long,
                             device=dev)
            src.scatter_(0, cand_slot.reshape(-1),
                         torch.arange(n_total, device=dev))
            cand_src = src[:cap]
            src_c = cand_src.clamp(max=n_total - 1)
            ray_id = src_c // self.n_march
            t_flat = ts.reshape(-1)[src_c]
            d_r = dirs[ray_id]
            positions = (origins[ray_id] + t_flat[:, None] * d_r
                         - self.lo) / (self.hi - self.lo)
            dirs_w = (d_r + 1.0) * 0.5
            bg = _srgb_to_linear(bg)
        if stochastic:
            draws = enc.draws(self.gen, cap, enc.exact_axes)
        leaves = self.p.leaves()
        for leaf in leaves:
            leaf.requires_grad_(True)
        with torch.enable_grad():
            if stochastic:
                feats = enc.encode_stochastic(self.p.pos, positions, draws,
                                              enc.exact_axes)
            else:
                feats = enc.encode_exact(self.p.pos, positions)
            raw = nerf_forward(self.p, feats, dirs_w, self.prec)
            loss, per_ray = self._composite(raw, cand_slot, cand_src, ts,
                                            rgba, valid, bg, cap)
            grads = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        eff = self.opt.effective_gradients([x.detach() for x in leaves],
                                           grads)
        self.opt.step(leaves, grads)
        self.step_index += 1
        return {"loss": float(per_ray.sum() / n_rays),
                "grads": [x.detach() for x in eff]}

    def _composite(self, raw, cand_slot, cand_src, ts, rgba, valid, bg, cap):
        n_lanes, n_march = cand_slot.shape
        n_cand = n_lanes * n_march
        mask = cand_slot < cap
        plane = torch.zeros(n_cand + 1, 4, device=raw.device)
        plane = plane.index_copy(0, cand_src, raw)
        plane = plane[:n_cand].view(n_lanes, n_march, 4)
        raw_rgb, raw_sigma = plane[..., :3], plane[..., 3]
        rgb = torch.sigmoid(raw_rgb)
        sigma = torch.exp(raw_sigma)
        dts = calc_dt(ts, 0.0)
        alpha = torch.where(mask, 1.0 - torch.exp(-sigma * dts), 0.0)
        t_prefix = torch.cumprod(1.0 - alpha, dim=1)
        t_before = torch.cat([torch.ones_like(t_prefix[:, :1]),
                              t_prefix[:, :-1]], dim=1)
        alive = mask & (t_before >= TRAIN_EPSILON)
        weight = torch.where(alive, alpha * t_before, 0.0)
        ray_rgb = (weight[..., None] * rgb).sum(dim=1)
        t_final = 1.0 - weight.sum(dim=1)
        tex, a = rgba[:, :3], rgba[:, 3:4]
        bg_net = _linear_to_srgb(bg)
        straight = torch.where(a > 0, tex / a.clamp(min=1e-8), 0.0)
        target = torch.where(a > 0, _linear_to_srgb(straight) * a
                             + (1.0 - a) * bg_net, bg_net)
        n_alive = alive.sum(dim=1)
        n_valid = mask.sum(dim=1)
        finished = n_alive == n_valid
        ray_rgb = ray_rgb + torch.where(finished, t_final,
                                        0.0)[:, None] * bg_net
        lane_valid = valid & (n_valid > 0)
        if self.drop_half:
            keep = torch.arange(n_lanes, device=raw.device) < n_lanes // 2
            lane_valid = lane_valid & keep
        per_ray = torch.where(lane_valid,
                              huber(target, ray_rgb).sum(dim=-1) / 3.0, 0.0)
        if self.drop_half:
            # the mean over the lanes left
            per_ray = per_ray * 2.0
        loss = per_ray.sum() / n_lanes
        # L1 on negative raw densities while the scene is mostly empty
        l1_on = torch.where(density_mean(self.density_grid)
                            < MIN_OPTICAL_THICKNESS, 1e-4, 0.0)
        loss = loss + l1_on * torch.where(
            alive, (-raw_sigma).clamp(min=0.0), 0.0).sum() / n_lanes
        return loss, per_ray.detach()


# -------------------------------------------------------------- rendering
@torch.no_grad()
def render_frame(p: NerfParams, bitfield, width: int,
                 height: int, focal: float, cam: torch.Tensor,
                 n_march: int = 1024, max_samples: int = 512,
                 min_transmittance: float = 1e-2, chunk: int = 1 << 14,
                 prec: Precision = FP32):
    """A Shade frame over black -> ((H, W, 3) linear rgb, samples that
    add weight)."""
    dev = cam.device
    lo, hi = torch.zeros(3, device=dev), torch.ones(3, device=dev)
    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(height, dtype=torch.float32, device=dev)
    gx, gy = torch.meshgrid((x + 0.5) / width, (y + 0.5) / height,
                            indexing="xy")
    uv = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    fl = torch.tensor([focal, focal], dtype=torch.float32, device=dev)
    origins, d = pinhole_rays(uv, (width, height), fl, cam)
    dirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    out = torch.zeros(uv.shape[0], 3, device=dev)
    n_used = 0
    for i in range(0, uv.shape[0], chunk):
        o, dr = origins[i:i + chunk], dirs[i:i + chunk]
        tmin, tmax = ray_intersect_aabb(o, dr, lo, hi)
        tmin = tmin.clamp(min=0.0)
        valid = tmax >= tmin
        t_start = advance_n_steps(tmin, 0.0, 0.5)
        ts, emit = march(o, dr, t_start, valid, bitfield, lo, hi, n_march,
                         max_samples)
        r_idx, c_idx = torch.nonzero(emit, as_tuple=True)
        if r_idx.numel() == 0:
            continue
        t = ts[r_idx, c_idx]
        pos = o[r_idx] + t[:, None] * dr[r_idx]
        raw = nerf_forward(p, p.model.pos.encode(p.pos, pos),
                           (dr[r_idx] + 1.0) * 0.5, prec)
        plane = torch.zeros(*emit.shape, 4, device=dev)
        plane[r_idx, c_idx] = raw
        rgb = torch.sigmoid(plane[..., :3])
        sigma = torch.exp(plane[..., 3])
        alpha = torch.where(emit, 1.0 - torch.exp(-sigma * calc_dt(ts, 0.0)),
                            0.0)
        prefix = torch.cumprod(1.0 - alpha, dim=1)
        t_before = torch.cat([torch.ones_like(prefix[:, :1]),
                              prefix[:, :-1]], dim=1)
        live = emit & (t_before >= min_transmittance)
        w = torch.where(live, alpha * t_before, 0.0)
        n_used += int(live.sum())
        out[i:i + chunk] = torch.where(valid[:, None],
                                       (w[..., None] * rgb).sum(dim=1), 0.0)
    return out.reshape(height, width, 3), n_used
