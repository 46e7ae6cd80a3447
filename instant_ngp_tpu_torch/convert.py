"""Parameters and optimizer state between the JAX package and the port.

Both packages keep one layout: the grid table is a flat float32 vector in
the interleaved layout (feature k of entry e at e*F + k), MLP weights are
bias-free (fan_in, fan_out) matrices, a NeRF's keys are `pos_encoding`,
`density_net`, `dir_encoding` and `rgb_net`, and an encoding followed by
an MLP (Image, SDF, Volume) is `{"encoding": table or None, "net":
[weights]}`. So converting
is a copy into float32 tensors, or back into numpy arrays. The optimizer
state is `{"step", "m", "v", "ema"}` with the three trees in the
parameters' layout. A trainable buffer (the envmap, the distortion map,
the per-image latent codes) is one array with a state of the same form,
`{"params", "opt": {"step", "m", "v", "ema"}}`, its trees single arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX parameter tree of numpy arrays (or anything np.asarray takes),
    with an interleaved grid table -> the same tree of CPU tensors: a NeRF
    tree ready for `NerfNetwork.load_params`, or an encoding followed by an
    MLP ({"encoding", "net"}: Image, Volume, SDF, a grid's or the Takikawa
    encoding's table) ready for `NetworkWithInputEncoding.load_params`."""
    if "net" in tree:
        return network_params_from_jax(tree)
    table = tree.get("pos_encoding")
    return {
        "pos_encoding": None if table is None else _tensor(table).reshape(-1),
        "density_net": [_tensor(w) for w in tree["density_net"]],
        "dir_encoding": None if tree.get("dir_encoding") is None
        else _tensor(tree["dir_encoding"]),
        "rgb_net": [_tensor(w) for w in tree["rgb_net"]],
    }


def jax_grid_layout(n_features: int) -> str:
    """The layout of a JAX `GridEncoding`'s table in memory: interleaved
    where 128 lanes hold whole entries (every configuration's F), else
    planar."""
    return "interleaved" if 128 % n_features == 0 else "planar"


def nerf_object_params_from_jax(params: Dict[str, Any],
                                config: Dict[str, Any]) -> Dict[str, Any]:
    """The parameters of a JAX `GeometryTestbed`'s `NerfObject` (its
    `params`, numpy arrays in the JAX model's own grid layout; what a
    Geometry snapshot stores under `objects[i]["nerf"]["params"]`) -> the
    port's tree, ready for `NerfNetwork.load_params`."""
    from .ops.grid_encoding import convert_layout

    table = params.get("pos_encoding")
    if table is not None:
        n_features = config["encoding"].get("n_features_per_level", 2)
        table = convert_layout(np.asarray(table).reshape(-1), n_features,
                               jax_grid_layout(n_features), "interleaved")
    return params_from_jax(dict(params, pos_encoding=table))


def geometry_objects_from_jax(objects) -> list:
    """A Geometry snapshot's `objects` (numpy arrays, as either package
    writes them) -> the same list with each NeRF object's parameters as
    the port's tree (`nerf_object_params_from_jax`) and its density grid
    as a float32 array; mesh triangles and BRDFs are taken as they are."""
    out = []
    for entry in objects:
        entry = dict(entry)
        if entry.get("type") == "Nerf" and "nerf" in entry:
            state = dict(entry["nerf"])
            state["params"] = nerf_object_params_from_jax(state["params"],
                                                          state["config"])
            state["density_grid"] = np.asarray(state["density_grid"],
                                               np.float32)
            entry["nerf"] = state
        out.append(entry)
    return out


def network_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """{"encoding", "net"} of numpy arrays -> CPU tensors, ready for
    `NetworkWithInputEncoding.load_params`."""
    enc = tree.get("encoding")
    return {"encoding": None if enc is None else _tensor(enc).reshape(-1),
            "net": [_tensor(w) for w in tree["net"]]}


def opt_state_from_jax(opt: Dict[str, Any],
                       params_fn: Callable = params_from_jax
                       ) -> Dict[str, Any]:
    """A JAX optimizer state of numpy arrays -> CPU tensors, its trees
    converted by `params_fn` (the NeRF layout by default), ready for
    `NerfTestbed.load_state` or `Trainer.load_state`."""
    out = {"step": torch.tensor(int(np.asarray(opt["step"])),
                                dtype=torch.int32)}
    for k in ("m", "v", "ema"):
        if k in opt:
            out[k] = params_fn(opt[k])
    return out


def _numpy(t):
    return None if t is None else t.detach().cpu().numpy().copy()


def params_to_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameter tree -> numpy arrays in the JAX layout."""
    return {
        "pos_encoding": _numpy(tree["pos_encoding"]),
        "density_net": [_numpy(w) for w in tree["density_net"]],
        "dir_encoding": _numpy(tree.get("dir_encoding")),
        "rgb_net": [_numpy(w) for w in tree["rgb_net"]],
    }


def network_params_to_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """{"encoding", "net"} of tensors -> numpy arrays in the JAX layout."""
    return {"encoding": _numpy(tree.get("encoding")),
            "net": [_numpy(w) for w in tree["net"]]}


def opt_state_to_jax(opt: Dict[str, Any],
                     params_fn: Callable = params_to_jax) -> Dict[str, Any]:
    out = {"step": np.asarray(int(opt["step"]), np.int32)}
    for k in ("m", "v", "ema"):
        if k in opt:
            out[k] = params_fn(opt[k])
    return out


def buffer_state_from_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX TrainableBuffer's state of numpy arrays (or its parameters
    alone, as an array) -> CPU tensors, ready for
    `TrainableBuffer.load_state`."""
    if not isinstance(state, dict):
        return {"params": _tensor(state)}
    out = {"params": _tensor(state["params"])}
    opt = state.get("opt")
    if opt:
        out["opt"] = {"step": torch.tensor(int(np.asarray(opt["step"])),
                                           dtype=torch.int32)}
        out["opt"].update({k: _tensor(opt[k]) for k in ("m", "v", "ema")
                           if k in opt})
    return out


def buffer_state_to_jax(state: Dict[str, Any]) -> Dict[str, Any]:
    """A TrainableBuffer's state -> numpy arrays in the JAX layout."""
    opt = state["opt"]
    out_opt = {"step": np.asarray(int(opt["step"]), np.int32)}
    out_opt.update({k: _numpy(opt[k]) for k in ("m", "v", "ema")
                    if k in opt})
    return {"params": _numpy(state["params"]), "opt": out_opt}
