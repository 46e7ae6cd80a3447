"""The command line of the port: `python -m instant_ngp_tpu_torch`.

Takes the arguments of the JAX package's scripts/run.py with the same
meanings: load scenes, snapshots and configs, train, save and load
snapshots, evaluate on a transforms file, save a mesh, render a camera
path and screenshots. Every mode runs on the CUDA device; `--cpu` is the
only way onto the CPU, and without it a machine with no card fails with a
message. `main(argv)` runs it in-process and returns the exit code.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m instant_ngp_tpu_torch",
        description="Run instant_ngp_tpu_torch with a scene: train, "
                    "evaluate, render.")
    p.add_argument("files", nargs="*", default=[],
                   help="files to load (scene, snapshot, config)")
    p.add_argument("--scene", default="", help="scene to load")
    p.add_argument("--network", default="", help="network config name/path")
    p.add_argument("--load_snapshot", default="")
    p.add_argument("--save_snapshot", default="")
    p.add_argument("--n_steps", type=int, default=-1,
                   help="training steps (default 35000 when training)")
    p.add_argument("--screenshot_transforms", default="")
    p.add_argument("--screenshot_frames", nargs="*")
    p.add_argument("--screenshot_dir", default="")
    p.add_argument("--screenshot_spp", type=int, default=16)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--test_transforms", default="",
                   help="transforms.json for PSNR/SSIM eval")
    p.add_argument("--eval_downscale", type=int, default=1)
    p.add_argument("--eval_views", type=int, default=0,
                   help="limit number of eval views (0 = all)")
    p.add_argument("--eval_spp", type=int, default=8,
                   help="samples per pixel for --test_transforms eval")
    p.add_argument("--flip", action="store_true",
                   help="also report the FLIP perceptual metric")
    p.add_argument("--nerf_compatibility", action="store_true",
                   help="match paper conditions: sRGB space, cone angle 0")
    p.add_argument("--train", action="store_true")
    p.add_argument("--save_mesh", default="",
                   help="extract + save a marching-cubes mesh (nerf mode)")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--video_camera_path", default="",
                   help="camera path JSON to render to video")
    p.add_argument("--video_n_seconds", type=float, default=1.0)
    p.add_argument("--video_fps", type=float, default=30.0)
    p.add_argument("--video_output", default="video_frames")
    p.add_argument("--video_spp", type=int, default=4)
    p.add_argument("--mode", default="",
                   help="force a testbed mode for the scenes loaded "
                        "(nerf/sdf/image/volume/geometry)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions of the "
                        "kernels) instead of the CUDA device")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("instant_ngp_tpu_torch: no CUDA device is available; pass "
              "--cpu to run on the CPU", file=sys.stderr)
        return 2
    from .common import TestbedMode
    from .testbed import Testbed

    testbed = Testbed(device="cpu" if args.cpu else None)
    forced = TestbedMode(args.mode.lower()) if args.mode else None

    for f in args.files:
        if forced is not None and not f.endswith((".ingp", ".msgpack")):
            testbed.load_training_data(f, forced)
        else:
            testbed.load_file(f)
    if args.scene:
        testbed.load_training_data(args.scene, forced)
    if args.network:
        testbed.reload_network_from_file(args.network)
    elif testbed.impl is None and testbed.data_path:
        testbed.reload_network_from_file("base.json")
    if args.load_snapshot:
        testbed.load_snapshot(args.load_snapshot)
        testbed.apply_pending_snapshot()

    if args.nerf_compatibility and testbed.mode == TestbedMode.Nerf:
        # paper conditions: sRGB accumulation, no cone-angle stepping, a
        # black background instead of a random one, the exact encode
        testbed.impl.scene.cone_angle_constant = 0.0
        testbed.impl.random_bg_color = False
        testbed.impl.train_in_linear_colors = False
        testbed.impl.stochastic_corners = False

    n_steps = args.n_steps
    if n_steps < 0 and not args.load_snapshot:
        n_steps = 35000

    if n_steps > 0:
        print(f"training {n_steps} steps...")
        t0 = time.time()
        log_every = max(n_steps // 50, 1)
        done = 0
        while done < n_steps:
            chunk = min(log_every, n_steps - done)
            loss = testbed.train(chunk)
            done += chunk
            dt = time.time() - t0
            print(f"  step={testbed.training_step} loss={loss:.6f} "
                  f"({done / dt:.1f} steps/s)", flush=True)
        print(f"trained in {time.time() - t0:.1f}s")

    if args.save_snapshot:
        testbed.save_snapshot(args.save_snapshot)
        print("saved snapshot", args.save_snapshot)

    if args.test_transforms and testbed.mode == TestbedMode.Nerf:
        from .eval import eval_test_transforms

        r = eval_test_transforms(
            testbed.impl, args.test_transforms, spp=args.eval_spp,
            limit=args.eval_views, downscale=args.eval_downscale,
            with_flip=args.flip)
        line = (f"PSNR avg={r['psnr_avg']:.3f} min={r['psnr_min']:.3f} "
                f"max={r['psnr_max']:.3f} SSIM avg={r['ssim_avg']:.4f}")
        if args.flip:
            line += f" FLIP avg={r['flip_avg']:.4f}"
        print(line)

    if args.save_mesh and testbed.mode == TestbedMode.Nerf:
        testbed.save_mesh(args.save_mesh,
                          resolution=args.marching_cubes_res)
        print("saved mesh", args.save_mesh)

    if args.video_camera_path:
        from .camera_path import CameraPath, render_video

        cp = CameraPath.load(args.video_camera_path)
        cp.duration_seconds = args.video_n_seconds
        cp.fps = args.video_fps
        out = render_video(testbed, cp, args.video_output,
                           spp=args.video_spp)
        print("rendered camera path to", out)

    if args.screenshot_transforms:
        # a screenshot per frame of the transforms file, through the NeRF
        # to NGP camera conversion and the file's camera_angle_x, named
        # after each frame's file_path
        from .data.images import write_image

        with open(args.screenshot_transforms) as f:
            ref_transforms = json.load(f)
        frames = ref_transforms["frames"]
        idxs = (range(len(frames)) if not args.screenshot_frames
                else [int(i) for i in args.screenshot_frames])
        w = args.width or int(ref_transforms.get("w", 1920))
        h = args.height or int(ref_transforms.get("h", 1080))
        impl = testbed.impl
        fl = None
        if "camera_angle_x" in ref_transforms:
            fx = 0.5 * w / math.tan(
                0.5 * float(ref_transforms["camera_angle_x"]))
            fl = np.array([fx, fx], np.float32)
        out_dir = args.screenshot_dir or "."
        for idx in idxs:
            fr = frames[int(idx)]
            m = np.asarray(fr.get("transform_matrix",
                                  fr.get("transform_matrix_start")),
                           np.float32)
            cam = impl.dataset.nerf_matrix_to_ngp(m[:3, :4])
            outname = os.path.join(out_dir,
                                   os.path.basename(fr["file_path"]))
            if not os.path.splitext(outname)[1]:
                outname += ".png"
            img = impl.render_frame(w, h, cam, focal_length=fl,
                                    spp=args.screenshot_spp)
            os.makedirs(os.path.dirname(outname) or ".", exist_ok=True)
            write_image(outname, img.astype(np.float32))
            print("wrote", outname)
    elif args.screenshot_dir:
        from .data.images import write_image

        os.makedirs(args.screenshot_dir, exist_ok=True)
        img = testbed.render(args.width, args.height,
                             spp=args.screenshot_spp)
        out = os.path.join(args.screenshot_dir, "screenshot.png")
        write_image(out, img.astype(np.float32))
        print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
