"""Disney-style BRDF shading on tensors (counterpart of
instant_ngp_tpu/sdf/brdf.py; instant-ngp's evaluate_shading,
src/testbed_sdf.cu:76-145): Burley diffuse, GGX specular with Schlick
Fresnel and Smith G, sheen and clearcoat, with instant-ngp's ambient term.
Defaults as BRDFParams (sdf.h:62-72).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass
class BRDFParams:
    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 1.0
    roughness: float = 0.5
    specular_tint: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.5
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0
    basecolor: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    ambientcolor: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _schlick_fresnel(u):
    return (1.0 - u).clamp(0.0, 1.0) ** 5


def _g1(ndoth, a: float):
    """GTR1 (the clearcoat lobe); 1/pi at a >= 1."""
    if a >= 1.0:
        return torch.full_like(ndoth, 1.0 / math.pi)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return (a2 - 1.0) / (math.pi * math.log(max(a2, 1e-8)) * t)


def _g2(ndoth, a: float):
    """GTR2 (GGX)."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (math.pi * t * t)


def _smith_g_ggx(ndotv, alpha_g: float):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / (ndotv + (a + b - a * b).clamp(min=0.0).sqrt())


def _dot(a, b):
    return (a * b).sum(dim=-1, keepdim=True)


def evaluate_shading(base_color: torch.Tensor, ambient_color: torch.Tensor,
                     light_color: torch.Tensor, params: BRDFParams,
                     L: torch.Tensor, V: torch.Tensor, N: torch.Tensor
                     ) -> torch.Tensor:
    """Vectors (..., 3) (or (3,)), the scalars from `params` -> (..., 3)."""
    metallic = params.metallic
    ndotl = _dot(N, L)
    ndotv = _dot(N, V)
    H = L + V
    H = H / torch.linalg.vector_norm(H, dim=-1, keepdim=True).clamp(
        min=1e-9)
    ndoth = _dot(N, H)
    ldoth = _dot(L, H)

    fl = _schlick_fresnel(ndotl)
    fv = _schlick_fresnel(ndotv)
    amb = ambient_color * (0.2 + (fv - 0.2) * metallic) * base_color

    lum_w = torch.tensor([0.3, 0.6, 0.1], dtype=base_color.dtype,
                         device=base_color.device)
    luminance = (base_color * lum_w).sum(dim=-1, keepdim=True)
    ctint = base_color / (luminance + 1e-5)
    cspec0 = ((1.0 + (ctint - 1.0) * params.specular_tint)
              * params.specular * 0.08)
    cspec0 = cspec0 + (base_color - cspec0) * metallic
    csheen = 1.0 + (ctint - 1.0) * params.sheen_tint

    fd90 = 0.5 + 2.0 * ldoth * ldoth * params.roughness
    fd = (1 + (fd90 - 1) * fl) * (1 + (fd90 - 1) * fv)

    fss90 = ldoth * ldoth * params.roughness
    fss = (1 + (fss90 - 1) * fl) * (1 + (fss90 - 1) * fv)
    ss = 1.25 * (fss * (1.0 / (ndotl + ndotv).clamp(min=1e-6) - 0.5) + 0.5)

    a = max(0.001, params.roughness ** 2)
    ds = _g2(ndoth, a)
    fh = _schlick_fresnel(ldoth)
    fs = cspec0 + (1.0 - cspec0) * fh
    gs = _smith_g_ggx(ndotl.clamp(min=1e-6), a) \
        * _smith_g_ggx(ndotv.clamp(min=1e-6), a)

    fsheen = fh * params.sheen * csheen

    dr = _g1(ndoth, 0.1 + (0.001 - 0.1) * params.clearcoat_gloss)
    fr = 0.04 + 0.96 * fh
    gr = _smith_g_ggx(ndotl.clamp(min=1e-6), 0.25) \
        * _smith_g_ggx(ndotv.clamp(min=1e-6), 0.25)
    ccs = 0.25 * params.clearcoat * gr * fr * dr

    brdf = ((1.0 / math.pi) * (fd + (ss - fd) * params.subsurface)
            * base_color + fsheen) * (1.0 - metallic) + gs * fs * ds + ccs
    lit = brdf * light_color * ndotl + amb
    return torch.where((ndotl < 0) | (ndotv < 0), amb, lit)
