"""Read and write the JAX package's snapshots of NeRF and of an encoding
followed by an MLP (Image, Volume and SDF modes) (`.ingp`, zlib-compressed
msgpack, or bare `.msgpack`; format of instant_ngp_tpu/data/snapshot.py).

Arrays are stored as {"__ndarray__": True, "dtype", "shape", "data"} with
raw little-endian bytes. The MessagePack is written and read by the port's
own codec (`msgpack_codec.py`, the same bytes as `msgpack.packb(...,
use_bin_type=True)`), so snapshots need no msgpack package.
"""

from __future__ import annotations

import os
import zlib
from typing import Any, Dict

import numpy as np
import torch

from ..convert import (buffer_state_from_jax, network_params_from_jax,
                       opt_state_from_jax, params_from_jax)
from ..ops.grid_encoding import convert_layout
from .msgpack_codec import packb, unpackb

SNAPSHOT_FORMAT_VERSION = 1
_ARRAY_KEY = "__ndarray__"


def _unpack_tree(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get(_ARRAY_KEY):
            arr = np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"]))
            return arr.reshape(obj["shape"]).copy()
        return {k: _unpack_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack_tree(v) for v in obj]
    return obj


def _pack_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _pack_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_pack_tree(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float, str, bytes)):
        return tree
    if torch.is_tensor(tree):
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        return {_ARRAY_KEY: True, "dtype": str(tree.dtype),
                "shape": list(tree.shape), "data": tree.tobytes()}
    if isinstance(tree, np.integer):
        return int(tree)
    if isinstance(tree, np.floating):
        return float(tree)
    raise TypeError(f"cannot serialize {type(tree)} into a snapshot")


def save_snapshot(path: str, snapshot: Dict[str, Any]) -> None:
    """Write a snapshot dict (numpy arrays or tensors at the leaves); at
    least {"config", "trainer": {"params", "opt"}}, and whatever else the
    mode keeps (density grid, step counts). `.ingp` paths are
    zlib-compressed."""
    payload = dict(snapshot)
    payload["snapshot_format_version"] = SNAPSHOT_FORMAT_VERSION
    raw = packb(_pack_tree(payload))
    if path.endswith(".ingp"):
        raw = zlib.compress(raw, level=6)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, path)


def read_snapshot_payload(path: str) -> Dict[str, Any]:
    """A snapshot file -> its payload as written, arrays as numpy (what the
    JAX package's `load_snapshot` returns): the version is checked, no
    tree is converted."""
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".ingp") or raw[:2] in (b"\x78\x9c", b"\x78\x01"):
        raw = zlib.decompress(raw)
    payload = _unpack_tree(unpackb(raw))
    version = payload.get("snapshot_format_version")
    if version != SNAPSHOT_FORMAT_VERSION:
        raise ValueError(f"snapshot format version {version} is not "
                         f"{SNAPSHOT_FORMAT_VERSION}")
    return payload


def load_snapshot(path: str) -> Dict[str, Any]:
    """A NeRF snapshot -> {"config", "aabb_scale", "params" (port tensors,
    interleaved grid; the Ema copy when the snapshot has one, as the JAX
    testbed renders with it), "density_grid" (float32 tensor), "trainer"
    ({"params", "opt"} as port tensors, for `NerfTestbed.
    load_snapshot_state`), "training_step", "density_grid_ema_step",
    "camera" ({"pos_offset", "rot_offset", "focal_offset", "exposures"} as
    numpy arrays, or None), "dataset_paths", and the trainable buffers
    where the snapshot has them: "extra_dims" ({"params", "opt"}),
    "envmap" and "distortion_map" ({"params"}), as CPU tensors for
    `TrainableBuffer.load_state`.

    A snapshot of an encoding followed by an MLP (parameters {"encoding",
    "net"}: Image, Volume, SDF) -> the snapshot's own keys, with "trainer"
    ({"params", "opt"} as port tensors, a grid table interleaved) for
    `Trainer.load_state`. A table that is not a grid's (the Takikawa
    encoding's) has one layout and is taken as it is."""
    payload = read_snapshot_payload(path)
    if payload.get("mode") == "geometry":
        return payload
    trainer = payload["trainer"]
    config = payload["config"]
    n_features = config["encoding"].get("n_features_per_level", 2)
    layout = payload.get("grid_layout", "planar")
    nerf = "pos_encoding" in trainer["params"]
    key, convert = ("pos_encoding", params_from_jax) if nerf \
        else ("encoding", network_params_from_jax)
    grid = nerf or "grid" in str(config["encoding"].get("otype", "")).lower()

    def interleaved(tree):
        if tree.get(key) is None or not grid:
            return tree
        return dict(tree, **{key: convert_layout(
            np.asarray(tree[key]).reshape(-1), n_features, layout,
            "interleaved")})

    opt = dict(trainer.get("opt") or {})
    for k in ("m", "v", "ema"):
        if opt.get(k):
            opt[k] = interleaved(opt[k])
    state = {"params": convert(interleaved(trainer["params"]))}
    if "step" in opt:
        state["opt"] = opt_state_from_jax(opt, convert)
    if not nerf:
        return dict(payload, trainer=state, grid_layout="interleaved")
    buffers = {k: buffer_state_from_jax(payload[k])
               for k in ("extra_dims", "envmap", "distortion_map")
               if payload.get(k) is not None}
    return {
        **buffers,
        "mode": payload.get("mode", "nerf"),
        "config": config,
        "aabb_scale": int(payload.get("aabb_scale", 1)),
        "params": state.get("opt", {}).get("ema") or state["params"],
        "trainer": state,
        "training_step": int(payload.get("training_step", 0)),
        "density_grid_ema_step": int(
            payload.get("density_grid_ema_step", 0)),
        "density_grid": torch.from_numpy(
            np.asarray(payload["density_grid"], np.float32).copy()),
        "camera": payload.get("camera"),
        "dataset_paths": payload.get("dataset_paths"),
    }
