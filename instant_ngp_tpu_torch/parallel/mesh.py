"""Device meshes over `torch.distributed`, the collectives of the parallel
steps, and the sharding helpers (counterpart of
instant_ngp_tpu/parallel/mesh.py).

JAX runs one program over the devices of a mesh; here every rank of a mesh
is a process with one device, and what `shard_map` makes of a mesh axis is
a process group: the ranks that differ from this one along that axis
alone. A `Mesh` names its axes, their sizes and its device type; its
groups come from `torch.distributed.device_mesh.init_device_mesh` over the
default process group, which must span exactly the mesh's ranks (rank r
sits at the row-major coordinate of r, the last axis fastest).

- Device type "cuda" is the default and means NCCL: where no default group
  exists yet, one is made, from torchrun's environment when it is set, else
  as a group of this process alone. A caller that wants another backend
  (gloo, for ranks that share a card, which NCCL refuses) initialises the
  default group itself first. "cpu" means gloo, and is used only when asked
  for, as the tests do.
- A rank's device is cuda:(LOCAL_RANK, else the rank, mod the cards of the
  host), so ranks that outnumber the cards share them.

The collectives (`psum`, `pmean`, `psum_many`, `all_gather`, `psum_scatter`,
`broadcast`) take a process group and return new tensors, like JAX's lax
collectives: `all_reduce`, `all_gather_into_tensor`,
`reduce_scatter_tensor` and `broadcast` underneath. Gloo on CUDA tensors
accepted all four in torch 2.11 on an H100 (chip_smoke.py phase 17 runs
two gloo ranks on one card through each of them), so none is routed
through another. `collective_log` times them with CUDA events when it is
switched on (chip_smoke.py reads it); off, it costs one attribute test a
call.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops.optimizers import tree_map

Group = Optional[dist.ProcessGroup]


class CollectiveLog:
    """CUDA-event spans around the collectives, while `enabled`: the
    milliseconds of each, read after a synchronize by `total_ms`."""

    def __init__(self):
        self.enabled = False
        self.spans: List[Tuple[str, Any, Any]] = []

    def reset(self) -> None:
        self.spans = []

    def run(self, name: str, tensor: torch.Tensor, fn) -> None:
        if not (self.enabled and tensor.is_cuda):
            fn()
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        self.spans.append((name, start, end))

    def total_ms(self) -> Dict[str, float]:
        """Milliseconds by collective (waits for the device)."""
        torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, start, end in self.spans:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


collective_log = CollectiveLog()


def _backend_for(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no backend for device type {device_type!r}")


def init_default_group(device_type: str = "cuda") -> None:
    """The default process group for `device_type`'s backend: from
    torchrun's environment (MASTER_ADDR, WORLD_SIZE, RANK) when it is set,
    else a group of this process alone."""
    if dist.is_initialized():
        return
    backend = _backend_for(device_type)
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _rank_device(device_type: str) -> torch.device:
    """This rank's device (see the module docstring)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unknown device type {device_type!r}")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


class Mesh:
    """A mesh of ranks with named axes (the counterpart of
    `jax.sharding.Mesh` for one process per rank).

    shape: {axis name: size}, in order (the last axis varies fastest over
    the ranks). `size(axis)`, `index(axis)` (this rank's coordinate) and
    `group(axis)` (the process group along it) serve the parallel steps;
    `device` is this rank's."""

    def __init__(self, shape: Union[Dict[str, int], Sequence[Tuple[str, int]]],
                 device_type: str = "cuda"):
        from torch.distributed.device_mesh import init_device_mesh

        shape = dict(shape)
        self.axis_names = tuple(shape)
        self.shape = shape
        self.device_type = device_type
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was asked for but no CUDA device "
                               "is available")
        init_default_group(device_type)
        n = math.prod(shape.values())
        if n != dist.get_world_size():
            raise ValueError(f"a mesh of {n} ranks {shape} over a process "
                             f"group of {dist.get_world_size()}")
        self.device = _rank_device(device_type)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.device_mesh = init_device_mesh(
            device_type, tuple(shape.values()),
            mesh_dim_names=self.axis_names)
        self.rank = dist.get_rank()

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.device_mesh.get_group(axis)


def data_parallel_mesh(device_type: str = "cuda",
                       axis_name: str = "data") -> Mesh:
    """Every rank of the default process group on one `axis_name` axis
    (made, where it does not exist, as `init_default_group` says)."""
    init_default_group(device_type)
    return Mesh({axis_name: dist.get_world_size()}, device_type)


# -- collectives -----------------------------------------------------------
def group_size(group: Group) -> int:
    return dist.get_world_size(group)


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group's ranks (the same bits on every rank)."""
    y = x.clone()
    collective_log.run("all_reduce", y,
                       lambda: dist.all_reduce(y, group=group))
    return y


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    return psum(x, group) / group_size(group)


def psum_many(tensors: Sequence[torch.Tensor], group: Group
              ) -> List[torch.Tensor]:
    """`psum` of every tensor (float32, one device) through one all-reduce
    of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective_log.run("all_reduce", flat,
                       lambda: dist.all_reduce(flat, group=group))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors concatenated along `dim`, in rank order (JAX's
    `all_gather(..., tiled=True)`)."""
    n = group_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
    collective_log.run(
        "all_gather", out,
        lambda: dist.all_gather_into_tensor(out, x0, group=group))
    return out.movedim(0, dim)


def psum_scatter(x: torch.Tensor, group: Group, dim: int = 0
                 ) -> torch.Tensor:
    """The sum over the ranks, cut into as many blocks along `dim` as there
    are ranks; this rank's block (JAX's `psum_scatter(..., tiled=True)`)."""
    n = group_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    if x0.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    out = x0.new_empty((x0.shape[0] // n,) + tuple(x0.shape[1:]))
    collective_log.run(
        "reduce_scatter", out,
        lambda: dist.reduce_scatter_tensor(out, x0, group=group))
    return out.movedim(0, dim)


def broadcast(x: torch.Tensor, group: Group = None, src: int = 0
              ) -> torch.Tensor:
    """Rank `src`'s tensor (a global rank) on every rank of the group."""
    y = x.contiguous().clone()
    collective_log.run("broadcast", y,
                       lambda: dist.broadcast(y, src, group=group))
    return y


# -- placement ---------------------------------------------------------------
def _on_device(mesh: Mesh, x) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))
    return x.to(mesh.device)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Every leaf (tensor or array) as rank 0 holds it, on this rank's
    device."""
    return tree_map(lambda x: broadcast(_on_device(mesh, x)), tree)


def shard_along(mesh: Mesh, tree: Any, axis_name: str = "data",
                dim: int = 0) -> Any:
    """This rank's block of every leaf along `dim`, cut into as many
    contiguous blocks as the axis has ranks, on this rank's device."""
    n, i = mesh.size(axis_name), mesh.index(axis_name)

    def take(x):
        x = _on_device(mesh, x)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        return x.chunk(n, dim=dim)[i].contiguous()

    return tree_map(take, tree)


def shard_batch(mesh: Mesh, batch: Any, axis_name: str = "data") -> Any:
    """Shard arrays over their leading (batch) dimension."""
    return shard_along(mesh, batch, axis_name, dim=0)
