"""Input encodings: Identity, Frequency, SphericalHarmonics, OneBlob,
TriangleWave, Composite and the grid family (counterpart of
instant_ngp_tpu/ops/encodings.py).

Every encoding is an `nn.Module` mapping (N, n_dims) inputs in [0, 1] to
(N, n_output_dims) features; only the grid family has parameters.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch
from torch import nn


class IdentityEncoding(nn.Module):
    """out = x * scale + offset."""

    def __init__(self, n_dims: int, scale: float = 1.0, offset: float = 0.0):
        super().__init__()
        self.n_dims = n_dims
        self.n_output_dims = n_dims
        self.scale = scale
        self.offset = offset

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.offset


class FrequencyEncoding(nn.Module):
    """The NeRF positional encoding: per input dim, per octave k,
    (sin, cos)(x * pi * 2^k)."""

    def __init__(self, n_dims: int, n_frequencies: int = 12):
        super().__init__()
        self.n_dims = n_dims
        self.n_frequencies = n_frequencies
        self.n_output_dims = n_dims * n_frequencies * 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        freqs = torch.exp2(torch.arange(self.n_frequencies, dtype=x.dtype,
                                        device=x.device)) \
            * torch.tensor(math.pi, dtype=x.dtype)
        ang = x[..., :, None] * freqs                    # (..., d, n_freq)
        feats = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
        return feats.reshape(*x.shape[:-1], self.n_output_dims)


def _quartic_cdf(x: torch.Tensor, inv_radius: float) -> torch.Tensor:
    """CDF of the quartic kernel 15/16 (1 - u^2)^2 on u in [-1, 1], with
    u = x * inv_radius."""
    u = (x * inv_radius).clamp(-1.0, 1.0)
    return 0.5 + 0.9375 * (u - (2.0 / 3.0) * u ** 3 + 0.2 * u ** 5)


class OneBlobEncoding(nn.Module):
    """Per input dim, the mass of a quartic kernel of radius two bins,
    centred at x, that falls into each of n_bins bins over [0, 1]."""

    def __init__(self, n_dims: int, n_bins: int = 16):
        super().__init__()
        self.n_dims = n_dims
        self.n_bins = n_bins
        self.n_output_dims = n_dims * n_bins

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        edges = torch.arange(self.n_bins + 1, dtype=x.dtype,
                             device=x.device) / self.n_bins
        cdf = _quartic_cdf(edges - x[..., :, None], 0.5 * self.n_bins)
        feats = cdf[..., 1:] - cdf[..., :-1]
        return feats.reshape(*x.shape[:-1], self.n_output_dims)


class TriangleWaveEncoding(nn.Module):
    """Per input dim, triangle waves in [-1, 1] at doubling frequencies."""

    def __init__(self, n_dims: int, n_frequencies: int = 12):
        super().__init__()
        self.n_dims = n_dims
        self.n_frequencies = n_frequencies
        self.n_output_dims = n_dims * n_frequencies

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        freqs = torch.exp2(torch.arange(self.n_frequencies, dtype=x.dtype,
                                        device=x.device))
        v = x[..., :, None] * freqs - 0.5
        frac = v - torch.floor(v)
        tri = (frac * 2.0 - 1.0).abs() * 2.0 - 1.0
        return tri.reshape(*x.shape[:-1], self.n_output_dims)


def sh_basis(degree: int, x: torch.Tensor, y: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """Real SH basis of a unit direction, (N,) components -> (N, degree^2).

    The polynomial expansion and its operation order follow the JAX
    package term by term, so both round alike in float32."""
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        xy, yz, xz = x * y, y * z, x * z
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * x * y * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    if degree >= 5:
        out += [
            2.5033429417967046 * x * y * (x2 - y2),
            -1.7701307697799304 * y * z * (-3.0 * x2 + y2),
            0.94617469575756008 * x * y * (7.0 * z2 - 1.0),
            -0.66904654355728921 * y * z * (7.0 * z2 - 3.0),
            0.10578554691520431 * (35.0 * z2 * z2 - 30.0 * z2 + 3.0),
            -0.66904654355728921 * x * z * (7.0 * z2 - 3.0),
            0.47308734787878004 * (x2 - y2) * (7.0 * z2 - 1.0),
            -1.7701307697799304 * x * z * (x2 - 3.0 * y2),
            0.62583573544917614 * (x2 * (x2 - 3.0 * y2)
                                   - y2 * (3.0 * x2 - y2)),
        ]
    if degree >= 6:
        raise NotImplementedError("SH degree > 5 is implemented by neither "
                                  "package (no configuration asks for it)")
    return torch.stack(out, dim=-1)


class SphericalHarmonicsEncoding(nn.Module):
    """SH of a direction warped to [0,1]^3 (dir/2 + 0.5); unwarps first."""

    def __init__(self, n_dims: int = 3, degree: int = 4):
        super().__init__()
        if n_dims != 3:
            raise ValueError("spherical harmonics encode 3 input dims")
        self.n_dims = n_dims
        self.degree = degree
        self.n_output_dims = degree * degree

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x * 2.0 - 1.0
        return sh_basis(self.degree, d[..., 0], d[..., 1], d[..., 2])


class CompositeEncoding(nn.Module):
    """Applies nested encodings to consecutive slices of the input."""

    def __init__(self, n_dims: int, nested: Sequence[nn.Module]):
        super().__init__()
        self.n_dims = n_dims
        self.nested = nn.ModuleList(nested)
        self.n_output_dims = sum(e.n_output_dims for e in self.nested)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, start = [], 0
        for enc in self.nested:
            outs.append(enc(x[..., start:start + enc.n_dims]))
            start += enc.n_dims
        return torch.cat(outs, dim=-1)


def create_encoding(n_dims: int, config: Dict[str, Any]) -> nn.Module:
    """Build an encoding from its JSON config (the JAX package's factory)."""
    otype = config.get("otype", "HashGrid")
    if otype in ("HashGrid", "DenseGrid", "TiledGrid", "Grid"):
        from .grid_encoding import GridEncoding

        return GridEncoding.from_config(n_dims, config)
    if otype == "Identity":
        return IdentityEncoding(n_dims, scale=config.get("scale", 1.0),
                                offset=config.get("offset", 0.0))
    if otype == "Frequency":
        return FrequencyEncoding(n_dims, config.get("n_frequencies", 12))
    if otype == "SphericalHarmonics":
        return SphericalHarmonicsEncoding(n_dims, config.get("degree", 4))
    if otype == "OneBlob":
        return OneBlobEncoding(n_dims, config.get("n_bins", 16))
    if otype == "TriangleWave":
        return TriangleWaveEncoding(n_dims, config.get("n_frequencies", 12))
    if otype == "Composite":
        nested_cfgs: List[Dict[str, Any]] = config["nested"]
        nested, remaining = [], n_dims
        for sub in nested_cfgs:
            nd = sub.get("n_dims_to_encode", remaining)
            nested.append(create_encoding(nd, sub))
            remaining -= nd
        return CompositeEncoding(n_dims, nested)
    raise ValueError(f"unknown encoding otype: {otype}")
