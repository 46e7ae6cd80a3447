"""A run driven on the CPU at a tiny size with the timed path broken
underneath: `correct` comes out false for each fault a cell can have (a
step that leaves its state unchanged; half the batch left out, the mean
taken over the rest; an answer altered where it is produced), and in the
Image cell for each of them in the exact steps alone. The cells
run on one card, so no exchange between chips can be left out."""

import pytest
import torch

from conftest import TINY


def _unchanged_state(monkeypatch):
    from instant_ngp_tpu_torch.ops import optimizers

    monkeypatch.setattr(optimizers.Optimizer, "step",
                        lambda self, state, params, grads, l2_mask=None:
                        (params, state))


def _half_batch_nerf(monkeypatch):
    from instant_ngp_tpu_torch.nerf import training

    original = training.composite_loss

    def half(raw, samples, ts, dts, rays, *args, **kwargs):
        keep = torch.arange(rays.valid.shape[0]) < rays.valid.shape[0] // 2
        res = original(raw, samples, ts, dts,
                       rays._replace(valid=rays.valid & keep), *args,
                       **kwargs)
        return res._replace(loss_for_grad=res.loss_for_grad * 2.0,
                            per_ray_loss=res.per_ray_loss * 2.0)
    monkeypatch.setattr(training, "composite_loss", half)


def _half_batch_image(monkeypatch):
    from instant_ngp_tpu_torch.ops import trainer

    original = trainer.Trainer.train_step

    def half(self, state, inputs, targets, draws=None, generator=None):
        n = inputs.shape[0] // 2
        return original(self, state, inputs[:n], targets[:n], draws,
                        generator)
    monkeypatch.setattr(trainer.Trainer, "train_step", half)


def _unchanged_state_when_exact(monkeypatch):
    """Only the exact steps (those past `stochastic_corners_until`) leave
    the state unchanged."""
    from instant_ngp_tpu_torch.ops import optimizers

    original = optimizers.Optimizer.step
    until = TINY["image-base-train"]["network"]["encoding"][
        "stochastic_corners_until"]

    def step(self, state, params, grads, l2_mask=None):
        if int(state["step"]) >= until:
            return params, state
        return original(self, state, params, grads, l2_mask)
    monkeypatch.setattr(optimizers.Optimizer, "step", step)


def _half_batch_when_exact(monkeypatch):
    from instant_ngp_tpu_torch.ops import trainer

    original = trainer.Trainer.train_step

    def half(self, state, inputs, targets, draws=None, generator=None):
        if draws is None and generator is None:
            n = inputs.shape[0] // 2
            inputs, targets = inputs[:n], targets[:n]
        return original(self, state, inputs, targets, draws, generator)
    monkeypatch.setattr(trainer.Trainer, "train_step", half)


def _exact_table_gradient_altered(monkeypatch):
    from instant_ngp_tpu_torch.ops.grid_encoding import GridEncoding

    original = GridEncoding._table_gradient

    def altered(self, x, grad_out, max_level):
        g = original(self, x, grad_out, max_level)
        return torch.where(torch.arange(g.numel()) % 2 == 0, g, 0.0)
    monkeypatch.setattr(GridEncoding, "_table_gradient", altered)


def _altered_frame(monkeypatch):
    from instant_ngp_tpu_torch.nerf import testbed_nerf

    original = testbed_nerf.NerfTestbed.render_frame

    def altered(self, *args, **kwargs):
        img = original(self, *args, **kwargs)
        img[: img.shape[0] // 8, :, :3] += 0.05
        return img
    monkeypatch.setattr(testbed_nerf.NerfTestbed, "render_frame", altered)


@pytest.mark.parametrize("cell,fault", [
    ("nerf-base-train", _unchanged_state),
    ("nerf-base-train", _half_batch_nerf),
    ("image-base-train", _unchanged_state),
    ("image-base-train", _half_batch_image),
    ("image-base-train", _unchanged_state_when_exact),
    ("image-base-train", _half_batch_when_exact),
    ("image-base-train", _exact_table_gradient_altered),
    ("nerf-base-render", _altered_frame),
])
def test_fault_makes_the_run_incorrect(tiny_run, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = tiny_run(cell)
    assert line["correct"] is False, line["checks"]


def test_a_testbed_off_the_replayed_encode_stops_the_run(tiny_run,
                                                         monkeypatch):
    """The NeRF reference replays the stochastic encode where the
    configuration runs it; a testbed whose steps encode otherwise is no
    sound run."""
    from instant_ngp_tpu_torch.nerf import testbed_nerf

    monkeypatch.setattr(testbed_nerf.NerfTestbed, "_stoch_now",
                        lambda self: False)
    with pytest.raises(RuntimeError, match="stochastic encode"):
        tiny_run("nerf-base-train")


@pytest.mark.parametrize("cell", ["nerf-base-train", "image-base-train"])
def test_a_grid_without_its_entry_points_stops_a_traced_run(tiny_run,
                                                            monkeypatch,
                                                            cell):
    """Where the reference encodes with a grid, a program encoding that
    lacks one of the grid entry points the recorder wraps (here: one the
    program never had, as after a rename) stops the traced run instead of
    leaving `grid_roofline.train` without a reading."""
    from ngp_bench.harness import cells

    monkeypatch.setitem(cells._GRID_ENTRIES, "_renamed_entry",
                        ("forward", 1, False))
    with pytest.raises(RuntimeError, match="lacks _renamed_entry"):
        tiny_run(cell, trace=1)
