"""Each cell's numbers that decide `correct`, at the tests' tiny size, pinned
bit for bit (seed 1234567890123, untraced, `tiny_run`'s thread count): a
change to the drivers or the reference that alters an operation or its
order shows here, though the limits would still pass it."""

import pytest

PINNED = {
    "nerf-base-train": {
        "loss_gap": 1.8477998387016787e-05,
        "grad_gap": 0.002551017939439571,
        "change_gap": 0.002256166022305884},
    "image-base-train": {
        "loss_gap": 2.563724961201302e-05,
        "grad_gap": 0.0002473278203617577,
        "change_gap": 0.0016490328556387792,
        "exact_loss_gap": 0.0010618943202267898,
        "exact_grad_gap": 0.0009435490585048277,
        "exact_change_gap": 0.0001192838137062123},
    "nerf-base-render": {
        "frame_max_gap": 0.0005020807730033994,
        "frame_mean_gap": 0.00019743906159419566},
}


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_checks_read_as_before(tiny_run, cell):
    line = tiny_run(cell)
    got = {name: c["value"] for name, c in line["checks"].items()}
    assert got == PINNED[cell]
