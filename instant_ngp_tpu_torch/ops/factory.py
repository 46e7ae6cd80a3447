"""Networks from their JSON configs, with the auto-derived grid parameters
(counterpart of instant_ngp_tpu/ops/factory.py).

`derive_grid_config` fills a grid encoding's config in:
- n_levels may come from a flat `n_features` count;
- base_resolution defaults to 2^(log2_hashmap_size / n_pos);
- per_level_scale, when absent or 0, is derived so the finest level hits
  `desired_resolution * aabb_scale`:
      b = exp(ln(desired_resolution * aabb_scale / base_resolution) / (L-1))
  with desired_resolution 2048 (NeRF), max(image width, height) / 2
  (Image), the volume's world-to-index scale (Volume).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .encodings import create_encoding
from .mlp import MLP, NetworkWithInputEncoding


def derive_grid_config(encoding_config: Dict[str, Any], n_pos: int,
                       desired_resolution: float = 2048.0,
                       aabb_scale: float = 1.0) -> Dict[str, Any]:
    """Return a copy of encoding_config with auto-derived grid params."""
    cfg = dict(encoding_config)
    if "grid" not in str(cfg.get("otype", "OneBlob")).lower():
        return cfg

    n_features_per_level = cfg.get("n_features_per_level", 2)
    if cfg.get("n_features", 0) > 0:
        cfg["n_levels"] = int(cfg["n_features"]) // int(n_features_per_level)
    n_levels = cfg.get("n_levels", 16)

    log2_hashmap_size = cfg.get("log2_hashmap_size", 15)
    if not cfg.get("base_resolution", 0):
        cfg["base_resolution"] = 1 << (int(log2_hashmap_size) // n_pos)

    if cfg.get("per_level_scale", 0.0) <= 0.0 and n_levels > 1:
        cfg["per_level_scale"] = math.exp(
            math.log(desired_resolution * aabb_scale / cfg["base_resolution"])
            / (n_levels - 1))
    return cfg


def create_network_with_encoding(
        n_input_dims: int, n_output_dims: int, config: Dict[str, Any],
        desired_resolution: float = 2048.0, aabb_scale: float = 1.0,
        compute_dtype: torch.dtype = torch.bfloat16
) -> Tuple[NetworkWithInputEncoding, Dict[str, Any]]:
    """encoding |> MLP from a full network config ({"encoding", "network",
    ...}) -> (the model, its parameters zero; the config with the grid's
    derived parameters filled in)."""
    enc_cfg = derive_grid_config(config.get("encoding", {}), n_input_dims,
                                 desired_resolution, aabb_scale)
    encoding = create_encoding(n_input_dims, enc_cfg)
    network = MLP.from_config(encoding.n_output_dims, n_output_dims,
                              config.get("network", {}),
                              compute_dtype=compute_dtype)
    resolved = dict(config)
    resolved["encoding"] = enc_cfg
    return NetworkWithInputEncoding(encoding, network), resolved
