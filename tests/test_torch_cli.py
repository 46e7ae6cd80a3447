"""The port's command line, `python -m instant_ngp_tpu_torch`, on the CPU:
in-process through `main(argv)` with `--cpu`, and once as a subprocess."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401 (its import sets the thread count)

from instant_ngp_tpu.data.snapshot import load_snapshot as jax_load_snapshot
from instant_ngp_tpu_torch.__main__ import main, parse_args
from instant_ngp_tpu_torch.data.exr import write_exr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMAGE_CFG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2,
                  "epsilon": 1e-15},
    "encoding": {"otype": "HashGrid", "n_levels": 2,
                 "n_features_per_level": 2, "log2_hashmap_size": 8,
                 "base_resolution": 4},
    "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                "output_activation": "None", "n_neurons": 32,
                "n_hidden_layers": 1},
}


@pytest.fixture
def image_scene(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1, (12, 16, 3)) \
        .astype(np.float32)
    path = str(tmp_path / "image.exr")
    write_exr(path, img)
    cfg = str(tmp_path / "net.json")
    with open(cfg, "w") as f:
        json.dump(IMAGE_CFG, f)
    return path, cfg


def test_every_argument_of_the_jax_script_is_taken():
    args = parse_args(["a.exr", "--scene", "s", "--network", "n",
                       "--mode", "image", "--load_snapshot", "l",
                       "--save_snapshot", "v", "--n_steps", "3", "--train",
                       "--screenshot_transforms", "t", "--screenshot_frames",
                       "0", "2", "--screenshot_dir", "d",
                       "--screenshot_spp", "2", "--width", "8", "--height",
                       "6", "--test_transforms", "x", "--eval_downscale",
                       "2", "--eval_views", "1", "--eval_spp", "1",
                       "--flip", "--nerf_compatibility", "--save_mesh", "m",
                       "--marching_cubes_res", "32", "--video_camera_path",
                       "c", "--video_n_seconds", "2", "--video_fps", "5",
                       "--video_output", "o", "--video_spp", "1", "--cpu"])
    assert args.files == ["a.exr"] and args.screenshot_frames == ["0", "2"]
    assert (args.n_steps, args.width, args.height, args.eval_downscale) == \
        (3, 8, 6, 2)
    assert args.cpu and args.flip and args.train and args.nerf_compatibility
    defaults = parse_args([])
    assert (defaults.n_steps, defaults.screenshot_spp, defaults.width,
            defaults.height, defaults.marching_cubes_res) == \
        (-1, 16, 1920, 1080, 256)


def test_train_save_and_reload_an_image_scene(image_scene, tmp_path, capsys):
    image, cfg = image_scene
    snap = str(tmp_path / "image.ingp")
    assert main([image, "--network", cfg, "--n_steps", "4",
                 "--save_snapshot", snap, "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "step=4" in out and "saved snapshot" in out
    # the JAX package reads what the port wrote
    jsnap = jax_load_snapshot(snap)
    assert jsnap["mode"] == "image" and jsnap["training_step"] == 4
    assert jsnap["config"] == IMAGE_CFG
    shots = str(tmp_path / "shots")
    assert main(["--scene", image, "--network", cfg, "--load_snapshot",
                 snap, "--n_steps", "0", "--screenshot_dir", shots,
                 "--width", "16", "--height", "12", "--screenshot_spp", "1",
                 "--mode", "image", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "training" not in out
    assert os.path.getsize(os.path.join(shots, "screenshot.png")) > 0


def test_a_geometry_scene_needs_no_network_config(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    scene = tmp_path / "scene.json"
    scene.write_text(json.dumps({"geometry": [
        {"type": "Mesh", "path": "tri.obj", "center": [0, 0, 0]}]}))
    shots = str(tmp_path / "shots")
    assert main([str(scene), "--n_steps", "0", "--screenshot_dir", shots,
                 "--width", "8", "--height", "8", "--cpu"]) == 0
    assert os.path.isfile(os.path.join(shots, "screenshot.png"))


def test_without_a_card_it_asks_for_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert main(["--n_steps", "0"]) == 2
    assert "--cpu" in capsys.readouterr().err


def test_help_imports_neither_jax_nor_msgpack():
    code = r"""
import runpy, sys
sys.argv = ["instant_ngp_tpu_torch", "--help"]
try:
    runpy.run_module("instant_ngp_tpu_torch", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "msgpack",
                                    "instant_ngp_tpu"))
print("IMPORTED", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--screenshot_transforms" in proc.stdout
    assert proc.stdout.strip().endswith("IMPORTED []"), proc.stdout
