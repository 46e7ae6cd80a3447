"""Elementwise losses with their analytic gradients (counterpart of
instant_ngp_tpu/ops/losses.py).

`loss_and_gradient(loss_type, target, prediction)` returns the
elementwise loss and d(loss)/d(prediction), as the NeRF composite uses
them: Huber is evaluated with alpha = 0.1 and divided by 5 so that its
quadratic region equals plain L2. Each loss is differentiable by autograd
as well; the analytic gradient is returned so callers and tests can hold
the two against each other.

`create_loss(config)` is the mean-reduced scalar loss of the generic
trainer (Image, SDF and Volume modes), by the config's `otype`; there
Huber keeps its config-free alpha of 1.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..common import LossType


Pair = Tuple[torch.Tensor, torch.Tensor]


def l2_loss(target, prediction) -> Pair:
    d = prediction - target
    return d * d, 2.0 * d


def relative_l2_loss(target, prediction) -> Pair:
    d = prediction - target
    denom = prediction * prediction + 1e-2
    return d * d / denom, 2.0 * d / denom


def l1_loss(target, prediction) -> Pair:
    d = prediction - target
    return d.abs(), torch.sign(d)


def huber_loss(target, prediction, alpha: float = 1.0) -> Pair:
    d = prediction - target
    ad = d.abs()
    loss = torch.where(ad > alpha, ad - 0.5 * alpha, 0.5 / alpha * d * d)
    grad = torch.where(ad > alpha, torch.sign(d), d / alpha)
    return loss, grad


def log_l1_loss(target, prediction) -> Pair:
    d = prediction - target
    divisor = d.abs() + 1.0
    return torch.log(divisor), torch.sign(d) / divisor


def smape_loss(target, prediction) -> Pair:
    d = prediction - target
    denom = 0.5 * (prediction.abs() + target.abs()) + 1e-2
    return d.abs() / denom, torch.sign(d) / denom


def mape_loss(target, prediction) -> Pair:
    d = prediction - target
    denom = prediction.abs() + 1e-2
    return d.abs() / denom, torch.sign(d) / denom


def loss_and_gradient(loss_type: LossType, target, prediction) -> Pair:
    """Elementwise (loss, dloss/dprediction). The gradient treats the
    denominators of the relative losses as constants, as the reference's
    device-side switch does."""
    if loss_type == LossType.RelativeL2:
        return relative_l2_loss(target, prediction)
    if loss_type == LossType.L1:
        return l1_loss(target, prediction)
    if loss_type == LossType.Mape:
        return mape_loss(target, prediction)
    if loss_type == LossType.Smape:
        return smape_loss(target, prediction)
    if loss_type == LossType.Huber:
        loss, grad = huber_loss(target, prediction, 0.1)
        return loss / 5.0, grad / 5.0
    if loss_type == LossType.LogL1:
        return log_l1_loss(target, prediction)
    return l2_loss(target, prediction)


_TCNN_LOSSES: Dict[str, Callable] = {
    "L2": l2_loss,
    "RelativeL2": relative_l2_loss,
    "L1": l1_loss,
    "Huber": huber_loss,
    "LogL1": log_l1_loss,
    "SMAPE": smape_loss,
    "Smape": smape_loss,
    "MAPE": mape_loss,
    "Mape": mape_loss,
}


def create_loss(config: Dict[str, Any]) -> Callable:
    """fn(prediction, target) -> the mean of the elementwise loss named by
    config["otype"] (default L2), a scalar tensor; `fn.otype` names it."""
    otype = config.get("otype", "L2")
    if otype not in _TCNN_LOSSES:
        raise ValueError(f"unknown loss otype: {otype}")
    fn = _TCNN_LOSSES[otype]

    def loss_fn(prediction, target):
        return fn(target, prediction)[0].mean()

    loss_fn.otype = otype
    return loss_fn


def loss_type_from_string(name: str) -> LossType:
    return LossType(name)
