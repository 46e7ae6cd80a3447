"""Plain Image mode of the reference: stratified positions snapped to
pixel centres, sRGB targets, the 2D grid (stochastic corners up to the
configured step, the exact encode after it), the MLP, the mean L2 loss
and Adam. It replays the program's generator sequence (positions, then
the corners while they are drawn), so a seed gives both sides the same
batch at every step."""

from __future__ import annotations

from typing import Dict, List

import torch

from .grid import Grid
from .nets import FP32, Adam, Precision, layer_dims, mlp, xavier


def linear_to_srgb(x):
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * x.clamp(min=1e-12) ** (1.0 / 2.4) - 0.055)


def image_grid(cfg: dict, width: int, height: int) -> Grid:
    return Grid(2, cfg["encoding"], max(width, height) / 2.0)


def image_init(grid: Grid, cfg: dict, gen: torch.Generator,
               table_range: float = 1e-4) -> List[torch.Tensor]:
    """Seeded leaves [table, matrices...] on the generator's device."""
    table = (torch.rand(grid.n_entries * grid.n_features, generator=gen,
                        device=gen.device) * 2.0 - 1.0) * table_range
    return [table] + [xavier(i, o, gen) for i, o in
                      layer_dims(grid.n_output, 3, cfg["network"])]


def stratified_positions(n: int, gen: torch.Generator) -> torch.Tensor:
    """n uniforms spread one per cell of a sqrt(n) x sqrt(n) grid (n a
    power of 4)."""
    u = torch.rand(n, 2, generator=gen, device=gen.device)
    log2 = n.bit_length() - 1
    size = 1 << (log2 // 2)
    i = torch.arange(n, device=u.device) & ((1 << log2) - 1)
    cx = (i & (size - 1)).to(torch.float32)
    cy = (i >> (log2 // 2)).to(torch.float32)
    inv = torch.tensor(1.0 / size, dtype=torch.float32)
    return torch.stack([u[:, 0] * inv + cx * inv, u[:, 1] * inv + cy * inv],
                       dim=-1)


class ImageTrainer:
    """The program's first Image train steps, replayed in float32.
    `drop_half`: the fault "half the batch left out, the mean over the
    rest"."""

    def __init__(self, image: torch.Tensor, cfg: dict,
                 leaves: List[torch.Tensor], seed: int,
                 prec: Precision = FP32, drop_half: bool = False):
        self.image = image                   # (H, W, 3) linear float32
        self.h, self.w = image.shape[:2]
        self.grid = image_grid(cfg, self.w, self.h)
        self.leaves = leaves
        self.prec = prec
        self.drop_half = drop_half
        self.until = cfg["encoding"].get("stochastic_corners_until", 256)
        self.gen = torch.Generator(device=image.device).manual_seed(seed)
        self.opt = Adam(cfg["optimizer"], leaves,
                        [False] + [True] * (len(leaves) - 1))
        self.step_index = 0

    def stochastic(self) -> bool:
        return self.until is None or self.step_index < self.until

    def _draw(self, batch: int):
        """One step's draws: the positions, then the corners' uniforms
        where the step is stochastic."""
        pos = stratified_positions(batch, self.gen)
        u = torch.rand(2, batch, self.grid.n_levels, generator=self.gen,
                       device=pos.device) if self.stochastic() else None
        return pos, u

    def resume(self, step: int, m: List[torch.Tensor],
               v: List[torch.Tensor], batch: int) -> None:
        """Go on from a state after `step` steps (the leaves given to the
        constructor, Adam's moments m and v): the generator skips the draws
        of those steps."""
        for _ in range(step):
            self._draw(batch)
            self.step_index += 1
        self.opt.m, self.opt.v = m, v
        self.opt.step_count = step

    def step(self, batch: int) -> Dict[str, object]:
        pos, u = self._draw(batch)
        res = torch.tensor([self.w, self.h], dtype=torch.float32,
                           device=pos.device)
        hi = torch.tensor([self.w - 1, self.h - 1], device=pos.device)
        pos_int = torch.floor(pos * res).long()
        snapped = (pos_int.float() + 0.5) / res
        pos_int = torch.minimum(pos_int.clamp(min=0), hi)
        target = linear_to_srgb(self.image[pos_int[:, 1], pos_int[:, 0]])
        g = self.grid
        for leaf in self.leaves:
            leaf.requires_grad_(True)
        with torch.enable_grad():
            if u is not None:
                feats = g.encode_stochastic(self.leaves[0], snapped, u, None,
                                            g.exact_axes)
            else:
                feats = g.encode_exact(self.leaves[0], snapped)
            pred = mlp(self.leaves[1:], feats, self.prec)
            err = ((pred - target) ** 2).mean(dim=-1)
            if self.drop_half:
                err = err[:batch // 2]
            loss = err.mean()
            grads = torch.autograd.grad(loss, self.leaves)
        for leaf in self.leaves:
            leaf.requires_grad_(False)
        eff = self.opt.effective_gradients(self.leaves, grads)
        self.opt.step(self.leaves, grads)
        self.step_index += 1
        return {"loss": float(loss.detach()),
                "grads": [x.detach() for x in eff]}
