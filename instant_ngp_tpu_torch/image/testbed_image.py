"""Image mode: fit encoding |> MLP to a 2D image (counterpart of
instant_ngp_tpu/image/testbed_image.py::ImageTestbed).

- the network maps uv in [0, 1]^2 to RGB; a grid encoding's finest level
  is derived from max(width, height) / 2;
- a train step draws `batch_size` positions by `random_mode` (Random,
  Halton, Sobol, Stratified; `ops/sampling.py::generate_2d_samples`),
  fetches their targets from the texture (snapped to pixel centres, or
  bilinear) and takes one `Trainer.train_step`. Training happens in sRGB:
  the linear texture is converted per fetch unless `linear_colors`;
- `stochastic_corners` (on) with `stochastic_corners_until` (the
  encoding's config, default 256): the grid's stochastic-corner encode up
  to that step, the exact one from there on; `train` never lets one chunk
  cross that step;
- `render` evaluates the network at the pixel centres of a width x height
  frame, in chunks of `render_chunk` pixels (which bounds memory only),
  under no_grad, so the MLP goes through the fused kernel on the card; the
  output is converted back to linear;
- `compute_mse` compares a full-resolution render with the image in sRGB
  (optionally both quantised to bytes), `psnr` from it.

Everything lives on one device: the CUDA device unless `device` names
another (it raises where there is none). The texture lives there as an
(H, W, 4) float32 tensor.

Random numbers: the positions of Random and Stratified, and the corners of
the stochastic encode, come from `generator` (default: one on the device,
seeded with `seed`). `draws(step, batch_size) -> (uniforms (B, 2) or
None, CornerDraws or None)`, where given, supplies them instead (tests feed
the JAX package's draws through it). The scanned multi-step dispatch
(`steps_per_dispatch` != 1) is not ported: it raises.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..common import TestbedMode
from ..convert import network_params_to_jax, opt_state_to_jax
from ..ops.factory import create_network_with_encoding
from ..ops.losses import create_loss
from ..ops.optimizers import create_optimizer
from ..ops.sampling import generate_2d_samples
from ..ops.trainer import Trainer


def _linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * x.clamp(min=1e-12) ** (1.0 / 2.4) - 0.055)


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92,
                       ((x.clamp(min=0.0) + 0.055) / 1.055) ** 2.4)


class ImageTestbed:
    """Image-mode testbed. `image` is linear float32 (H, W, C), C <= 4."""

    mode = TestbedMode.Image
    #: pixels per network call of a render
    render_chunk = 1 << 21

    def __init__(self, image: np.ndarray, network_config: Dict[str, Any],
                 seed: int = 1337, compute_dtype=torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Callable] = None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for but none is "
                               "available")
        image = np.asarray(image, np.float32)
        if image.ndim == 2:
            image = image[:, :, None]
        if image.shape[2] < 4:
            pad = np.ones((*image.shape[:2], 4 - image.shape[2]), np.float32)
            image = np.concatenate([image, pad], axis=-1)
        self.height, self.width = image.shape[:2]
        self.image = torch.from_numpy(
            np.ascontiguousarray(image[..., :4])).to(self.device)

        self.config = network_config
        self.model, self.resolved_config = create_network_with_encoding(
            2, 3, network_config,
            desired_resolution=max(self.width, self.height) / 2.0,
            compute_dtype=compute_dtype)
        self.model.to(self.device)
        self.optimizer = create_optimizer(network_config.get("optimizer", {}))
        self.loss_fn = create_loss(network_config.get("loss", {"otype": "L2"}))
        self.trainer = Trainer(self.model, self.optimizer, self.loss_fn,
                               seed=seed)
        self.state = self.trainer.init_state()
        self.training_step = 0
        self.seed = seed
        self.loss_scalar = float("nan")

        self.random_mode = "Stratified"
        self.snap_to_pixel_centers = True
        self.linear_colors = False
        self.steps_per_dispatch = 1
        self.stochastic_corners = True
        self.stochastic_corners_until: Optional[int] = network_config.get(
            "encoding", {}).get("stochastic_corners_until", 256)
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(seed)
        self.draws = draws

    # ------------------------------------------------------------------
    # targets
    # ------------------------------------------------------------------
    def _fetch_targets(self, positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions (N, 2) in [0, 1] -> (the positions the network sees:
        snapped to pixel centres or as given; (N, 3) targets)."""
        w, h = self.width, self.height
        tex = self.image.reshape(-1, 4)

        def read(ix, iy):
            rgb = tex[iy * w + ix, :3]
            return rgb if self.linear_colors else _linear_to_srgb(rgb)

        res = torch.tensor([w, h], dtype=torch.float32, device=self.device)
        hi = torch.tensor([w - 1, h - 1], device=self.device)
        if self.snap_to_pixel_centers:
            pos_int = torch.floor(positions * res).long()
            snapped = (pos_int.float() + 0.5) / res
            pos_int = torch.minimum(pos_int.clamp(min=0), hi)
            return snapped, read(pos_int[:, 0], pos_int[:, 1])

        pos = torch.minimum((positions * res - 0.5).clamp(min=0.0),
                            res - (1.0 + 1e-4))
        pos_int = pos.long()
        frac = pos - pos_int.float()
        idx = torch.minimum(pos_int.clamp(min=0), hi - 1)
        x0, y0 = idx[:, 0], idx[:, 1]
        wx, wy = frac[:, 0:1], frac[:, 1:2]
        val = ((1 - wx) * (1 - wy) * read(x0, y0)
               + wx * (1 - wy) * read(x0 + 1, y0)
               + (1 - wx) * wy * read(x0, y0 + 1)
               + wx * wy * read(x0 + 1, y0 + 1))
        return positions, val

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _stoch_now(self) -> bool:
        """Whether this step encodes stochastically."""
        if not self.stochastic_corners:
            return False
        until = self.stochastic_corners_until
        return until is None or self.training_step < until

    def train(self, n_steps: int, batch_size: int = 1 << 18) -> float:
        """n_steps train steps -> the last loss (one read of the device per
        chunk; a chunk never crosses `stochastic_corners_until`)."""
        if self.steps_per_dispatch != 1:
            raise NotImplementedError(
                "steps_per_dispatch != 1: the scanned multi-step dispatch is "
                "a TPU workaround and is not ported "
                "(ROADMAP: do not port TPU workarounds)")
        remaining = n_steps
        loss = self.loss_scalar
        until = self.stochastic_corners_until
        while remaining > 0:
            n = remaining
            if self.stochastic_corners and until is not None \
                    and self.training_step < until:
                n = min(n, until - self.training_step)
            loss = self._train_chunk(n, batch_size)
            remaining -= n
        return loss

    def _train_chunk(self, n_steps: int, batch_size: int) -> float:
        stoch = self._stoch_now()
        loss = None
        for _ in range(n_steps):
            uniforms = corners = None
            if self.draws is not None:
                uniforms, corners = self.draws(self.training_step,
                                               batch_size)
            positions = generate_2d_samples(
                self.random_mode, batch_size, self.training_step, self.seed,
                uniforms=uniforms, generator=self.generator,
                device=self.device)
            positions, targets = self._fetch_targets(positions)
            encode = {}
            if stoch:
                encode = {"draws": corners} if corners is not None \
                    else {"generator": self.generator}
            self.state, loss = self.trainer.train_step(
                self.state, positions, targets, **encode)
            self.training_step += 1
        self.loss_scalar = float(loss)
        return self.loss_scalar

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _render_rows(self, width: int, height: int
                     ) -> Iterator[Tuple[int, int, torch.Tensor]]:
        """(first row, end row, (rows * width, 3) linear colours) of a
        width x height frame of the unit square, pixel centres, in chunks,
        by the trainer's inference model."""
        model = self.trainer.inference_model
        u = (torch.arange(width, dtype=torch.float32, device=self.device)
             + 0.5) / width
        v = (torch.arange(height, dtype=torch.float32, device=self.device)
             + 0.5) / height
        rows = max(1, self.render_chunk // width)
        for y0 in range(0, height, rows):
            y1 = min(height, y0 + rows)
            uu, vv = torch.meshgrid(u, v[y0:y1], indexing="xy")
            colors = model(torch.stack([uu, vv], dim=-1).reshape(-1, 2))
            if not self.linear_colors:
                colors = _srgb_to_linear(colors)
            yield y0, y1, colors

    def render(self, width: int, height: int) -> np.ndarray:
        """The fitted image at width x height -> (height, width, 4) linear
        float32, alpha 1."""
        out = np.ones((height, width, 4), np.float32)
        for y0, y1, colors in self._render_rows(width, height):
            out[y0:y1, :, :3] = colors.reshape(y1 - y0, width, 3).cpu() \
                .numpy()
        return out

    @torch.no_grad()
    def compute_mse(self, quantize: bool = False) -> float:
        """MSE of a full-resolution render against the image, both in sRGB
        unless `linear_colors` (the render clamped at 0 first), optionally
        both rounded to bytes."""
        sse = torch.zeros((), dtype=torch.float64, device=self.device)
        for y0, y1, render in self._render_rows(self.width, self.height):
            target = self.image[y0:y1].reshape(-1, 4)[:, :3]
            if not self.linear_colors:
                render = _linear_to_srgb(render.clamp(min=0.0))
                target = _linear_to_srgb(target)
            if quantize:
                render = torch.floor(render.clamp(0, 1) * 255.0 + 0.5) / 255.0
                target = torch.floor(target.clamp(0, 1) * 255.0 + 0.5) / 255.0
            sse += ((render - target) ** 2).sum(dtype=torch.float64)
        return float(sse) / (self.width * self.height * 3)

    def psnr(self) -> float:
        return -10.0 * math.log10(max(self.compute_mse(), 1e-20))

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        """A snapshot in the JAX package's format (config embedded)."""
        from ..data.snapshot import save_snapshot

        save_snapshot(path, {
            "mode": self.mode.value,
            "config": self.config,
            "grid_layout": "interleaved",
            "trainer": {
                "params": network_params_to_jax(self.state["params"]),
                "opt": opt_state_to_jax(self.state["opt"],
                                        network_params_to_jax)},
            "training_step": self.training_step,
            "image_resolution": [self.width, self.height],
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        """Restore from `data.snapshot.load_snapshot`'s dict."""
        trainer = snapshot["trainer"]
        self.trainer.load_state(self.state, trainer["params"],
                                trainer.get("opt"))
        self.training_step = int(snapshot.get("training_step", 0))
