"""SphericalHarmonics of degree 4 of a direction warped to [0, 1]^3: the
real SH basis of dir * 2 - 1, no parameters."""

from __future__ import annotations

import torch

from . import Encoding


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real SH basis of degree 4 of unit directions (N, 3) -> (N, 16), in
    the port's operation order."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    x2, y2, z2 = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ], dim=-1)


class SphericalHarmonics(Encoding):
    n_output = 16

    def encode(self, leaves, x):
        return sh4(x * 2.0 - 1.0)


def build(n_dims, cfg, **scene):
    degree = int(cfg.get("degree", 4))
    if n_dims != 3 or degree != 4:
        raise NotImplementedError(
            f"the reference's SphericalHarmonics is degree 4 of 3 dims, not "
            f"degree {degree} of {n_dims}")
    return SphericalHarmonics()
