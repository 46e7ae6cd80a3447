"""Tensor parallelism: the hash grid sharded by level (counterpart of
instant_ngp_tpu/parallel/tp.py).

The hash table is nearly all of a NeRF's parameters (2^19 rows of F
features at each of L levels; the two MLPs are kilobytes), so the split
across a `model` mesh axis is by level: rank m of the axis holds levels
m*L/tp .. (m+1)*L/tp - 1 as an (L/tp, Tmax, F) block of the packed table,
computes those levels' interpolated features, and one all-gather along
the feature axis assembles the (N, L*F) encoding for the replicated MLPs.
The gather's backward is a reduce-scatter, so each rank deposits
gradients into its own levels only.

A level's constants (scale, resolution, size, dense or hashed) are looked
up from its global id, shard * L/tp + j: each rank knows its id, so the
encoding's own per-level index code serves (the JAX package gathers them
from arrays at a traced id, to keep one SPMD program).

`make_tp_train_step` is the hybrid data x model step: rays sharded over
`data`, the table over `model`. The table's gradient is reduced over
`data` only, every other gradient over both axes, and the table's Adam
slots (and EMA) are sharded like the table. Its gradient equals the
data-parallel step's: see `_GatherLevels.backward` for where the JAX
package's step makes it tp times larger (ROADMAP fault 9).

The packed layout pads every level to the largest level's row count; the
port's flat table is always interleaved, so `pack` and `unpack` have no
planar branch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops.grid_encoding import GridEncoding
from ..ops.optimizers import tree_leaves, tree_map
from ..ops.trainer import default_l2_mask
from .mesh import (Mesh, all_gather, group_size, pmean, psum, psum_many,
                   psum_scatter)


class _GatherLevels(torch.autograd.Function):
    """(N, L/tp * F) features of this rank's levels -> (N, L*F), the ranks'
    blocks in rank (= level) order; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.group = group
        return all_gather(local, group, dim=1)

    @staticmethod
    def backward(ctx, grad):
        # Every rank of the model axis computed the same loss from the
        # same rays, so each passes back the same cotangent, and their sum
        # (the reduce-scatter that the gather transposes to) is tp times
        # the gradient of that one loss. The JAX package's shard_map
        # autodiff keeps the sum, which makes its table gradient tp times
        # the data-parallel one (ROADMAP fault 9; Adam hides most of it,
        # being scale-invariant up to eps). Dividing by the rank count
        # gives the data-parallel gradient.
        return psum_scatter(grad, ctx.group, dim=1) / group_size(ctx.group), \
            None


class LevelShardedGrid:
    """Packs a `GridEncoding`'s flat table into an (L, Tmax, F) table
    that shards over a mesh axis by level, and computes the features of a
    rank's block of levels."""

    def __init__(self, enc: GridEncoding, n_shards: int):
        if enc.n_levels % n_shards != 0:
            raise ValueError(f"n_levels={enc.n_levels} not divisible by "
                             f"tp={n_shards}")
        self.enc = enc
        self.n_shards = n_shards
        self.levels_per_shard = enc.n_levels // n_shards
        self.max_rows = max(size for _, _, size, _, _ in enc.levels)

    # -- layouts ----------------------------------------------------------
    def pack(self, flat) -> torch.Tensor:
        """Flat interleaved table (array or tensor) -> (L, Tmax, F)
        float32, zero-padded rows, on the input's device."""
        flat = torch.as_tensor(np.asarray(flat) if not torch.is_tensor(flat)
                               else flat, dtype=torch.float32)
        f = self.enc.n_features_per_level
        rows = flat.reshape(-1, f)
        out = rows.new_zeros(self.enc.n_levels, self.max_rows, f)
        for lvl, (_, _, size, offset, _) in enumerate(self.enc.levels):
            out[lvl, :size] = rows[offset:offset + size]
        return out

    def unpack(self, table) -> torch.Tensor:
        """(L, Tmax, F) table (array or tensor) -> the flat interleaved
        table."""
        table = torch.as_tensor(np.asarray(table) if not torch.is_tensor(
            table) else table, dtype=torch.float32)
        f = self.enc.n_features_per_level
        rows = table.new_zeros(self.enc.n_entries, f)
        for lvl, (_, _, size, offset, _) in enumerate(self.enc.levels):
            rows[offset:offset + size] = table[lvl, :size]
        return rows.reshape(-1)

    def shard(self, table: torch.Tensor, index: int) -> torch.Tensor:
        """Rank `index`'s block of levels of a packed table."""
        k = self.levels_per_shard
        return table[index * k:(index + 1) * k]

    # -- features ---------------------------------------------------------
    def level_features(self, table_level: torch.Tensor, lvl: int,
                       x: torch.Tensor) -> torch.Tensor:
        """Features (N, F) of global level `lvl` from its (Tmax, F) slice of
        the packed table: the exact encode's arithmetic for that level."""
        idx, weight = self.enc._level_corners(x, lvl)
        rows = idx - self.enc.levels[lvl][3]
        return (table_level[rows] * weight[..., None]).sum(dim=1)

    def local_features(self, table_local: torch.Tensor, x: torch.Tensor,
                       index: int, group,
                       max_level: Optional[float] = None) -> torch.Tensor:
        """(L/tp, Tmax, F) block of rank `index` of the model axis and
        positions x (N, 3) in [0,1]^3 -> the whole (N, L*F) encoding,
        gathered over `group`; differentiable in the block."""
        x = x.reshape(-1, self.enc.n_dims).float()
        outs = []
        for j in range(self.levels_per_shard):
            lvl = index * self.levels_per_shard + j
            f = self.level_features(table_local[j], lvl, x)
            if self.enc._masked(max_level, lvl):
                f = f * 0.0
            outs.append(f)
        return _GatherLevels.apply(torch.cat(outs, dim=-1), group)


def tp_state(model, optimizer, grid: LevelShardedGrid,
             index: int) -> Dict[str, Any]:
    """The train state of rank `index` of the model axis: {"params":
    {"pos_encoding": its block of the model's packed table (a leaf that
    requires grad), the model's own MLP weight tensors}, "opt": a fresh
    optimizer state of those}."""
    table = grid.pack(model.pos_encoding.params.detach())
    block = grid.shard(table, index).clone().requires_grad_(True)
    model.requires_grad_(True)
    params = dict(model.param_tree(), pos_encoding=block)
    return {"params": params, "opt": optimizer.init(params)}


def make_tp_train_step(model, optimizer, cfg, aabb_min: torch.Tensor,
                       aabb_max: torch.Tensor, mesh: Mesh,
                       data_axis: str = "data", model_axis: str = "model"
                       ) -> Callable:
    """Hybrid data x model NeRF train step -> (step, grid). step(state,
    data, bitfield, mean_density, draws) updates `state` (`tp_state`) in
    place -> {"loss", "measured_batch_size"}, reduced over `data`. `draws`
    are the rays' (a `TrainDraws` for cfg.n_rays rays), the same on every
    rank of one data shard. The encode is the exact one (as in the JAX
    package, which takes no camera, error-map or stochastic options here).

    Collectives per step: the features' all-gather over `model` (forward),
    its reduce-scatter (backward), one all-reduce of the table gradient
    over `data`, and one of the other gradients over `data` and then
    `model`, and one of the stats over `data`."""
    from ..nerf.sampler import compact_samples, generate_rays, march_rays
    from ..nerf.training import _srgb_to_linear, composite_loss

    grid = LevelShardedGrid(model.pos_encoding, mesh.size(model_axis))
    data_group, model_group = mesh.group(data_axis), mesh.group(model_axis)
    index = mesh.index(model_axis)
    n_total = cfg.n_rays * mesh.size(data_axis)

    def step(state, data, bitfield, mean_density, draws):
        params = state["params"]
        with torch.no_grad():
            rays, _ = generate_rays(draws, data, aabb_min, aabb_max,
                                    cfg.cone_angle, cfg.lens_mode,
                                    cfg.snap_to_pixel_centers)
            ts, dts, emits = march_rays(rays, bitfield, aabb_min, aabb_max,
                                        cfg.cone_angle, cfg.max_mip,
                                        cfg.n_march, cfg.max_samples_per_ray)
            samples = compact_samples(rays, ts, emits, aabb_min, aabb_max,
                                      cfg.sample_capacity, cfg.cone_angle)
            bg = _srgb_to_linear(draws.bg_color if cfg.random_bg_color
                                 else torch.zeros_like(draws.bg_color))
            exposure = data.exposures[rays.img_idx]
        leaves = tree_leaves(params)
        with torch.enable_grad():
            feats = grid.local_features(params["pos_encoding"],
                                        samples.positions, index,
                                        model_group)
            raw = model.apply_components(samples.positions, samples.dirs,
                                         pos_feats=feats)
            result = composite_loss(
                raw, samples, ts, dts, rays, bg, exposure,
                cfg.rgb_activation, cfg.density_activation, cfg.loss_type,
                mean_density, cfg.near_distance, cfg.train_in_linear_colors,
                cfg.disable_regularizers)
            grads = torch.autograd.grad(result.loss_for_grad, leaves)
        with torch.no_grad():
            # the table's block is this rank's alone: over `data` only;
            # the rest is replicated: over both axes
            table = params["pos_encoding"]
            at = next(i for i, p in enumerate(leaves) if p is table)
            table_grad = pmean(grads[at], data_group)
            rest = grads[:at] + grads[at + 1:]
            n_data, n_model = group_size(data_group), group_size(model_group)
            rest = [g / n_model for g in psum_many(
                [g / n_data for g in psum_many(rest, data_group)],
                model_group)]
            rest = iter(rest)
            reduced = tree_map(lambda p: table_grad if p is table
                               else next(rest), params)
        optimizer.step(state["opt"], params, reduced,
                       l2_mask=default_l2_mask(params))
        with torch.no_grad():
            stats = psum(torch.stack([
                result.per_ray_loss.sum(),
                result.measured_compacted.to(torch.float32)]), data_group)
        return {"loss": stats[0] / n_total, "measured_batch_size": stats[1]}

    return step, grid
