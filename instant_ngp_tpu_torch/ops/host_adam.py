"""Adam on the host for small variables (counterpart of
instant_ngp_tpu/ops/host_adam.py; numpy only).

The per-image camera offsets, the focal-length offset and the exposures are
a few hundred numbers, stepped once per 16 training steps: they live on the
host as numpy arrays. `HostAdam` is a plain Adam with bias-corrected
moments (float64) and a float32 result; `RotationHostAdam` COMPOSES its
axis-angle step with the variable by rotation multiplication instead of
adding it. Both are vectorised over the image dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def rotvec_to_matrix(r: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    theta = np.linalg.norm(r, axis=-1, keepdims=True)
    safe = np.maximum(theta, 1e-12)
    k = r / safe
    K = np.zeros((*r.shape[:-1], 3, 3), np.float64)
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    st = np.sin(theta)[..., None]
    ct = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + st * K + (1 - ct) * (K @ K)
    return np.where(theta[..., None] < 1e-12, eye, R)


def matrix_to_rotvec(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) axis-angle."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos_t = np.clip((tr - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_t)
    v = np.stack([R[..., 2, 1] - R[..., 1, 2],
                  R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    s = np.where(theta[..., None] > 1e-6,
                 theta[..., None] / np.maximum(
                     2 * np.sin(theta)[..., None], 1e-12), 0.5)
    return v * s


@dataclasses.dataclass
class HostAdam:
    """Adam over (..., D) variables: bias-corrected first and second
    moments; the learning rate may be set before each step."""

    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-8

    def __post_init__(self):
        self.m: Optional[np.ndarray] = None
        self.v: Optional[np.ndarray] = None
        self.t = 0

    def reset(self):
        self.m = self.v = None
        self.t = 0

    def step(self, variable: np.ndarray, gradient: np.ndarray
             ) -> np.ndarray:
        g = np.asarray(gradient, np.float64)
        if self.m is None:
            self.m = np.zeros_like(g)
            self.v = np.zeros_like(g)
        self.t += 1
        self.m = self.beta1 * self.m + (1 - self.beta1) * g
        self.v = self.beta2 * self.v + (1 - self.beta2) * g * g
        mh = self.m / (1 - self.beta1 ** self.t)
        vh = self.v / (1 - self.beta2 ** self.t)
        return np.asarray(
            variable - self.learning_rate * mh / (np.sqrt(vh)
                                                  + self.epsilon),
            np.float32)


@dataclasses.dataclass
class RotationHostAdam(HostAdam):
    """Rotation variant: the Adam step is COMPOSED with the current
    axis-angle variable by rotation multiplication rather than added."""

    def step(self, variable: np.ndarray, gradient: np.ndarray
             ) -> np.ndarray:
        g = np.asarray(gradient, np.float64)
        if self.m is None:
            self.m = np.zeros_like(g)
            self.v = np.zeros_like(g)
        self.t += 1
        self.m = self.beta1 * self.m + (1 - self.beta1) * g
        self.v = self.beta2 * self.v + (1 - self.beta2) * g * g
        mh = self.m / (1 - self.beta1 ** self.t)
        vh = self.v / (1 - self.beta2 ** self.t)
        delta = -self.learning_rate * mh / (np.sqrt(vh) + self.epsilon)
        R = rotvec_to_matrix(delta) @ rotvec_to_matrix(
            np.asarray(variable, np.float64))
        return matrix_to_rotvec(R).astype(np.float32)
