"""The comparison that decides `correct`: numbers the timed path produced
against the plain reference, each with its limit.

Training cells compare three steps (each step's loss; the first gradient
as the optimizer got it; the parameters' change after the three), each
norm by the worst leaf: the gap between the program's norm
and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger. A leaf whose reference gradient is
under a thousandth of the median leaf's is left out (its Adam steps are
round-off). Frame cells compare sampled frames pixel by pixel."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import torch


def leaf_norms(now: Sequence[torch.Tensor],
               before: Optional[Sequence[torch.Tensor]] = None,
               scale: float = 1.0, coef: float = 1.0,
               chunk: int = 1 << 24) -> List[float]:
    """Per leaf, the norm of scale * (now - coef * before) (before None:
    zero), `before` on the host or the device, a chunk at a time (so no
    copy of a large table need sit on the device)."""
    out = []
    for k, a in enumerate(now):
        a = a.detach().reshape(-1)
        acc = 0.0
        for i in range(0, a.numel(), chunk):
            d = a[i:i + chunk].double()
            if before is not None:
                d = d - coef * before[k].detach().reshape(-1)[
                    i:i + chunk].to(a.device, torch.float64)
            acc += float((d * d).sum())
        out.append(abs(scale) * math.sqrt(acc))
    return out


def counted_leaves(ref_grad_norms: Sequence[float]) -> List[int]:
    """Leaves whose reference gradient is at least 1e-3 of the median
    leaf's."""
    med = statistics.median(ref_grad_norms)
    return [i for i, n in enumerate(ref_grad_norms) if n >= 1e-3 * med]


def worst_leaf_gap(prog: Sequence[float], ref: Sequence[float],
                   leaves: Sequence[int]) -> float:
    med = statistics.median(ref[i] for i in leaves)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30)
               for i in leaves)


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def training_numbers(prog_losses, ref_losses, prog_grad, ref_grad,
                     prog_change, ref_change, prefix: str = ""
                     ) -> Dict[str, float]:
    """The three numbers of three compared steps (norms per leaf given),
    named with `prefix`."""
    leaves = counted_leaves(ref_grad)
    return {prefix + "loss_gap": loss_gap(prog_losses, ref_losses),
            prefix + "grad_gap": worst_leaf_gap(prog_grad, ref_grad, leaves),
            prefix + "change_gap": worst_leaf_gap(prog_change, ref_change,
                                                  leaves)}


def frame_numbers(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]
                  ) -> Dict[str, float]:
    """Over the sampled frames of linear rgb, the worst of: the largest
    absolute gap over the reference's largest value, and the mean absolute
    gap over the reference's mean value (the frames of seeded weights are
    faint, so absolute gaps would say little)."""
    worst, mean = 0.0, 0.0
    for p, r in zip(prog, ref):
        d = (p.to(r.device) - r).abs()
        worst = max(worst, float(d.max() / r.abs().max().clamp(min=1e-30)))
        mean = max(mean, float(d.mean() / r.abs().mean().clamp(min=1e-30)))
    return {"frame_max_gap": worst, "frame_mean_gap": mean}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every number; a number without a
    limit, or not finite, fails."""
    out = {}
    for name, value in numbers.items():
        out[name] = {"value": value, "limit": limits.get(name)}
    return out


def passed(checks: Dict[str, Dict[str, Optional[float]]]) -> bool:
    return bool(checks) and all(
        c["limit"] is not None and c["value"] == c["value"]
        and c["value"] <= c["limit"] for c in checks.values())
