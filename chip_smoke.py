#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's NeRF render and training paths, the path
from a capture on disk to every render mode, Image mode, the mesh tools
and FLIP, Volume mode, SDF mode, Geometry mode, the nets of the wide
configurations, the command line and data- and level-parallel NeRF, once
on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which raises on failure (a non-zero exit):
1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `instant_ngp_tpu_torch/csrc` (one nvcc per
   source, started together);
3. hold the fused-MLP kernel against its plain PyTorch version on the
   card: the two shapes of the render path at small and ragged row counts
   first (a fault of the input pipeline shows there within seconds), then
   shapes that take the general kernel and the 128-wide instantiation,
   then the path shapes at 2^20 rows, where the kernel, the general
   kernel on the same shape and the plain version are timed with CUDA
   events beside the card's bound; then times at 2^14, 2^17 and 2^21 rows
   and with the input ring at each depth and without it; then the RGB
   net of a capture with latent dims (36-64-64-3), whose path is the
   general path (csrc/fused_mlp_wgmma.cu, weights resident), at ragged
   row counts and at 2^20 rows beside its bf16 matmul chain; then the
   nets of Volume mode
   (32-64-64-4 ReLU/ReLU) and SDF mode (32-64-64-1, and the Takikawa
   net's 24-64-64-1, whose input is narrower than its padded width) at
   ragged row counts and at 2^20 rows, timed the same way; the Takikawa
   net's input path besides (`narrow_input_paths`: the ring by a tensor
   copy for an aligned f32 and bf16 x, the per-row loads for an x 4 bytes
   off, each checked at RING_ROWS rows and timed); then the nets
   outside the general path's rule (WIDE_NETS: the 256-wide nets of
   configs/nerf/frequency.json and none.json, the 128-wide 8- and
   6-layer nets of configs/sdf/frequency.json and oneblob.json), which
   take the streamed path (the same wgmma kernel; its plan streams the
   deep nets' weights through a ring and keeps the 1-hidden-layer RGB
   nets' resident), timed beside the same net as a chain of bf16
   torch.matmul + ReLU calls, with the kernel's plan and the bytes of
   weights it is modelled to read from L2 (not measured); then
   every other net of the configurations (CONFIG_NETS) the same way, on
   its mma instantiation or the general path. The general and the
   streamed path fail unless faster than their chain;
   3b. the grid encode's kernels (csrc/grid_encoding.cu: the exact and
   the stochastic-corner forward, the sorted table-gradient deposit of
   every variant, the input gradient) against their plain versions on the
   same CUDA tensors: the grids of configs/nerf/base.json, image, volume,
   densegrid and densegrid_1res at GRID_SMALL points (the first on cell
   faces), with and without max_level, then base.json's at 2^20 points on
   a U(-1, 1) table, each kernel and plain version timed with CUDA events
   beside the bytes bound and the bytes the gathers read, the table
   gradient split into its kernels (a torch.profiler table) beside one
   index_put_ call on its deposits' rows and values (the library call the
   kernels line reports). The gradients
   must repeat bit for bit; whether each kernel gave the plain version's
   bits is printed. From phase 4 on, the density pass, the frames, both
   trainings of phase 6, the capture, Image, Volume, SDF and Geometry
   paths each count their grid launches from 0 and must have launched
   one, each grid kernel must have run on one of them, and no plain grid
   method may run on a CUDA tensor in the whole run;
   3c. the wavefront renderer's march-and-pack kernel (csrc/nerf_march.cu)
   against its plain version at the render benchmark's tile (2^19 rays,
   n_march 1024, 512 kept, the shell's bitfield): the same bits over the
   columns the rounds read, both timed with CUDA events beside the bytes
   bound and the issue bound (the candidates visited and the fewest SASS
   instructions of the kernel's loop, `sass_loop_paths`). From phase 4
   on, the frames, both trainings of phase 6 and the capture count its
   launches from 0 and must have launched it;
   3d. the network round's RGB-net input rows (csrc/nerf_network_round.cu)
   against the plain round's at the render benchmark's network call
   (2^22 rows, 32 samples a ray): the same bits, both timed with CUDA
   events beside the bytes bound. From phase 4 on, a frame launches it
   once per network call (as often as the density net's instantiation),
   no train step or density update launches it, and the capture (latent
   dims) never does;
4. the main path: a NerfTestbed at configs/nerf/base.json's full width
   (HashGrid L=8, F=4, 2^19 entries per level; 64-wide MLPs; bf16
   compute; weights from a seed, the hash table at a trained scale)
   runs one density pass over all 128^3 cells and renders a 400x400
   Shade frame from an orbit camera, with every kernel's launch count
   set to 0 before and read after;
5. check the result: a small frame rendered on the card agrees with the
   same testbed rendered on the CPU through the plain versions, and that
   comparison can see a density network that is off;
6. train on the card: the synthetic orbit scene (64 views of 400x400 of
   an octant-checker sphere, raytraced here with numpy) trains
   configs/nerf/base.json at full width and batch 2^18 for 128 steps
   through `NerfTestbed(dataset, config).train` with the testbed's
   defaults (the stochastic-corner encode with one exact axis and the
   one-corner backward, error-map sampling), with the kernel's launch
   count set to 0 before and read after. It fails unless the loss fell,
   samples were generated, the kernel was launched by the density updates
   and never by a train step, the occupancy thinned out, and the PSNR of
   view 0 rose to at least TRAIN_MIN_PSNR; it prints the rates, the
   encode's forward and backward times per step, the prep times, the peak
   memory and a warm frame of the trained model. Then the same 128 steps
   with `stochastic_corners = False` (the exact encode), and the same
   lines, so that the two stand side by side. Last, the scene with
   `aabb_scale` 4 (three occupancy cascades, the cone-angle step) trains
   AABB4_STEPS steps with the defaults; it fails unless the loss fell and
   the march emitted samples in cascades above 0, and prints the rate and
   the occupied bits per cascade.
   6b. base.json with the defaults trains REPEAT_STEPS (160) steps twice
   from one seed, past the error CDFs' rebuild at step 128: the
   parameters, optimizer state, occupancy, error map and CDFs must have
   the same bits; then the same steps with error-map sampling off (PSNR
   and steps/s of each run). 6c. the determinism sweep: SWEEP_STEPS steps
   of NeRF with the defaults, NeRF exact with pose, focal, exposure and
   distortion optimisation, Image, Volume and SDF (base.json widths)
   under `torch.use_deterministic_algorithms(True, warn_only=True)`,
   failing on a warned op outside `determinism.ORDER_FREE`, and twice
   more with the mode off, failing unless both runs give the same bits;
7. card against CPU: the same 2 train steps of a small network, with
   the same random draws, on the card and on the CPU: the losses and a
   48x48 frame agree within the stated tolerance; then 2 steps with pose,
   focal and exposure optimisation on and the camera gradient taken on
   every step: losses and the gradients agree as well; then 2 steps on a
   small capture loaded from disk with envmap, distortion-map, latent and
   depth training on: losses, the three buffers' gradients and a 48x48
   frame in each render mode through `render_tile`;
8. pose recovery: the scene at 200x200 with every training camera moved
   by a seeded N(0, 0.01) translation and turned by an N(0, 0.01) rad
   rotation vector trains 256 steps with `optimize_extrinsics`; the mean
   distance of the cameras (`effective_xform`) to the true ones must
   fall. It prints the distance and the mean angle before and after and
   how often the two host-side updates read the device;
9. a capture from disk: the scene is written to a temporary directory as
   a user's capture would lie there (`transforms.json` with an OpenCV
   lens and 4 latent dims per image, 64 views of 400x400 raytraced
   through that lens over a sky, as half EXR files), read back with
   `load_nerf`, given the raytracer's depths, and trained at base.json's
   full width and batch 2^18 for 128 steps with `train_envmap`,
   `optimize_distortion`, `optimize_extra_dims` and
   `depth_supervision_lambda` on. It fails unless the loss fell, the
   envmap, the distortion map and the latent codes moved, PSNR of view 0
   through its own lens reached CAPTURE_MIN_PSNR, a 400x400 frame in each
   of Shade, Depth, AO, Normals, Positions, EncodingVis, Cost, Distortion
   and the density slice is finite and not constant (the Shade frame's
   PSNR is printed on the sphere's pixels, on the sky's and on the whole
   frame), the Depth and Normals frames agree with the raytracer on the opaque pixels, Shade by
   `render_tile` agrees with Shade by the wavefront renderer, the kernel
   was launched by the density updates and the renders, by no train step
   and not by the Normals frame (which differentiates the density
   network), and every launch went to the expected variant: the density
   net's instantiation of the mma kernel, and the general kernel for the
   36-wide RGB net. It prints the seconds to write and load the capture,
   the steps per second, and the time, samples and launches of a warm
   frame per mode; `eval_nerf_views` scores two views at the end;
10. Image mode at configs/image/base.json's full width (HashGrid 2D, L=16,
   F=2, 2^24 entries a level, base 16; 64-wide MLP with 2 hidden layers;
   L2; ExponentialDecay > Adam; bf16 compute) on a procedural 4096x4096
   linear image (edges, a zone plate, smooth areas; numpy, from SEED):
   512 steps at batch 2^18, Stratified, the first 256 with the
   stochastic-corner encode and the rest exact. It prints steps/s of each
   half, the peak memory, PSNR at steps 0, 256 and 512 and the time and
   launches of a whole 4096x4096 frame, and fails unless the loss fell,
   PSNR rose to at least IMAGE_MIN_PSNR, the frame is finite, and the
   kernel was launched by the renders alone, on the 32x64x8 instantiation.
   Then 2 train steps of a small image net (L=4, 2^10 entries, a 64x64
   image) on the card and on the CPU from the same draws: losses and a
   64x64 frame agree within phase 7's tolerances;
11. the mesh tools and FLIP on phase 6's trained NeRF:
   `compute_marching_cubes_mesh(256)`, which must launch the density and
   RGB instantiations and give a mesh around the scene's sphere (a share
   of its vertices within MESH_RADIUS_BAND of it, the outer surface
   within MESH_OUTER_TOL); 4 `optimise_mesh_step`s, which
   launch nothing and must not move the vertices' densities away from the
   threshold; the mesh written as PLY and OBJ and read back; FLIP of view
   0 against its image, finite and in [0, 1];
12. lenses: phase 6's trained model through the f-theta, latlong and
   equirectangular lenses and through an aperture, each a 48x48 frame on
   the card against the same model on the CPU;
13. Volume mode at configs/volume/base.json's full width (HashGrid L=16,
   F=2, 2^19; MLP 32-64-64-4 ReLU/ReLU; bf16) on a procedural 128^3
   cloud, written as NanoVDB and read back through `load_volume_grid`:
   VOLUME_STEPS + 1 delta-tracking train steps at batch 2^18, then a
   400x400 frame of the model (cold and warm) and of the GT medium. It
   fails unless the loss on a fixed batch fell, the frames are finite,
   the GT frame shows the cloud, and the kernel was launched 32 times a
   frame (one event round each), on the ReLU/ReLU instantiation alone, and
   never by a train step; a train step and a frame are traced for their
   launches and the device's busy share. Then 2 train steps of a small net
   and a 24x24 frame on the card against the CPU from the same draws;
14. SDF mode at configs/sdf/base.json's and takikawa.json's full widths
   on a bumpy sphere of more than 10^5 triangles made by the port's
   marching cubes and read back through `load_obj`: the host sampler and
   the device step timed apart, SDF_STEPS train steps at batch 2^18, IoU,
   400x400 frames (Shade with and without shadows, and for base.json
   Normals, Depth, Positions and the three GT oracles, whose silhouettes
   must agree on GT_SILHOUETTE_AGREE of the pixels). It fails unless the
   loss on a fixed batch fell, IoU reached its floor, every frame
   launched the 32x64x8 ReLU/None instantiation 96 times (160 with
   shadows), no train step launched it, and every launch of both nets
   took the input ring (launches counted by input path). Then a small SDF net on the
   card against the CPU: 2 train steps from the same samples and draws,
   and a Depth frame after 64 more steps.
15. Geometry mode: a scene of the bumpy sphere, a box and phase 6's
   trained model as a NeRF object, through a `.ingp` that the port's
   codec writes and reads on the card, loaded by `Testbed.load_file`:
   Shade, Normals and Depth frames at GEOMETRY_SIZE, each launching both
   NeRF nets' instantiations ceil(samples / chunk) times (checked), the
   NeRF object visible; a small frame card against CPU; a 1920x1080
   `screenshot` with its peak memory.
16. the wide nets on their paths: configs/nerf/frequency.json trains
   WIDE_STEPS steps on the orbit scene with its density updates and
   renders a frame, configs/sdf/frequency.json and oneblob.json render,
   every launch the streamed kernel's; then `python -m
   instant_ngp_tpu_torch` as subprocesses on the card: phase 9's capture
   trained CLI_STEPS steps with --save_snapshot, reloaded with --n_steps 0
   and screenshots of two views, and the Geometry scene; each must
   return 0 and leave its files.
17. data- and level-parallel NeRF (nerf/parallel.py, parallel/tp.py) at
   base.json's width on the orbit scene. (a) `data_parallel_mesh()`, a
   1-rank NCCL group on the card: `NerfTestbed(dataset, config, mesh=)`
   trains TRAIN_STEPS steps at a global batch of 2^18 beside an unsharded
   testbed timed in turns with it (steps/s of each, and the CUDA-event
   milliseconds of the collectives a step); it fails unless the loss fell,
   PSNR of view 0 reached TRAIN_MIN_PSNR, the kernel was launched by the
   sharded density updates and by no train step, and a 400x400 frame from
   `make_sharded_render` matches render_tile's frame of the same model
   within phase 5's tolerances. (b) two gloo ranks spawned on the one card
   (NCCL refuses two ranks on one device; the kernels are built before):
   every collective of parallel/mesh.py on CUDA tensors; one sharded train
   step at full width from supplied draws against one testbed's step over
   the same global rays (the CPU tests' tolerances); 8 steps with the
   defaults, after which both ranks' parameters, optimizer state, density
   grid, bitfield and error map must have the same bits; one
   tensor-parallel step (data=1, model=2) against the data-parallel step,
   and the level-sharded features against the plain encode. Each step's
   time is printed.

    python3 chip_smoke.py --profile OUT.txt

adds a last phase: one warm frame with CUDA-event spans around each
layer, one under torch.profiler (its table goes to OUT.txt), a warm
density pass; then the same for training: the spans of one warm train
step and of one density update, and 16 steps under torch.profiler; where
a warm frame of the trained capture spends its time in each render mode;
and 16 Image train steps of each encode under torch.profiler.

    python3 chip_smoke.py --curve

adds the quality curve: a second testbed trains the same scene for 1024
steps with the defaults under the protocol of the JAX package's record
(scripts/time_to_30db_r5.py: 2048 rays a step, not adapted; PSNR averaged
over views 0, 16, 32 and 48 at 2 spp with the render's candidate cap at
n_march) and prints PSNR and training seconds at steps 128, 256, 512 and
1024 beside that record's PSNRs; a third does the same with the exact
encode. It fails if a milestone of the default run lies more than
CURVE_SLACK_DB from the record, above or below.

    python3 chip_smoke.py --grid-only

builds the kernels and then only runs phase 3b; it prints no result line.

    python3 chip_smoke.py --march-only

builds the kernels and then only runs phase 3c (`march_kernel_on_card`);
it prints no result line.

    python3 chip_smoke.py --round-only

builds the kernels and then only runs phase 3d (`round_rows_on_card`);
it prints no result line.

    python3 chip_smoke.py --deposit-ab

builds the kernels and then only times the plain table gradient's deposit
by `index_put_` against `index_add_` (atomic adds), in turns in one
process, beside the grid kernels' sorted deposit, and the error map's
deposit alone and in default steps (`deposit_ab`); it prints no result
line.

    python3 chip_smoke.py --step-times

builds the kernels and then only times NeRF train steps of base.json with
the defaults and with the exact encode, and the table gradient's share of
them (`step_times`); it drives only public entry points, so a copy of the
script placed in an older checkout times that checkout's package; it
prints no result line.

The last lines are one JSON object describing the kernels (the fused
MLP's instantiations and the paths that launch each; its general and
streamed paths as further entries; one entry per grid kernel), the card's name and power limit (nvidia-smi's own line),
and {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
N_ROWS = 1 << 20
SMALL_ROWS = (1, 127, 129, 100003)
# a narrow input's ring: one row, a tile less one, a tile, a tile and one,
# and a full grid with a ragged last tile
RING_ROWS = (1, 127, 128, 129, (1 << 20) + 37)
OTHER_ROWS = (1 << 14, 1 << 17, 1 << 21)   # late render rounds; a full budget
# shapes off the render path: (widths, hidden activation, output activation)
OTHER_SHAPES = (([27, 48, 5], "None", "None"),
                ([32] + [64] * 8 + [16], "ReLU", "None"),
                ([32, 128, 128, 128, 16], "ReLU", "None"),
                ([16, 1], "None", "ReLU"),
                ([32, 64, 64, 16], "Sine", "None"))
# NVIDIA's data sheet for the H100 SXM: memory rate and dense bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
WIDTH = HEIGHT = 400
FOCAL = 440.0              # the synthetic orbit scene's 400 px * 1.1
# kernel vs plain, relative to the reference's max and mean |value|: bf16
# rounding of a hidden value may flip with the summation order (see
# tests/test_torch_cuda_kernels.py)
KERNEL_MAX_REL, KERNEL_MEAN_REL = 2e-2, 1e-3
# the reference must have a scale the check can see: the density outputs
# are the RGB net's first 16 inputs
KERNEL_MIN_MEAN_ABS = 1e-2
# card vs CPU frame: the same flips, composited over up to 512 samples
FRAME_MAX_ABS, FRAME_MEAN_ABS = 2e-2, 1e-3
# halving the density net's output layer must move the CPU frame by this
# much more than the card-vs-CPU mean tolerance
FRAME_SENSITIVITY = 5.0
TRAIN_STEPS, TRAIN_WARMUP = 128, 16
# phase 6b: steps of each run, past the error CDFs' rebuild at step 128;
# phase 6c: steps of each train path of the determinism sweep
REPEAT_STEPS, SWEEP_STEPS = 160, 2
# dB on view 0 after TRAIN_STEPS steps, by encode: the exact one reads
# 24.6-24.9 dB; the default's floor is 2 dB under its first reading, 23.40
TRAIN_MIN_PSNR = {"default": 21.4, "exact": 20.0}
# card vs CPU after 2 train steps of a small bf16 network: a bf16 flip or
# a summation order in the table gradient (atomic adds on the card) moves
# a loss by well under a percent; Adam's first steps are of full size
# (lr) wherever the gradient is not zero, so the frames get the same
# tolerance as phase 5's
CPU_LOSS_REL = 2e-2
# the same for a camera, exposure or trainable-buffer gradient, relative to
# the gradient's largest entry (a sum over the rays of terms of both signs): at the first
# step, from identical parameters, and at the second, after an Adam step
# whose eps of 1e-15 has turned float32 noise in near-zero gradients into
# full-size parameter steps of either sign (the first readings were 2.0e-2
# and 9.5e-2)
CPU_CAM_GRAD_REL = (5e-2, 2e-1)
# phase 9, the capture on disk: its OpenCV lens, latent dims per image and
# the depth term's weight
CAPTURE_LENS = {"k1": 0.08, "k2": -0.02, "p1": 0.004, "p2": -0.003}
CAPTURE_EXTRA_DIMS = 4
CAPTURE_DEPTH_LAMBDA = 0.5
# dB on view 0 through its lens after TRAIN_STEPS steps: 2 dB under the
# first reading, 17.55 (the views have no transparent pixel, so the sky is
# learned partly as fog, and the envmap is composited behind a frame
# without the sRGB transfer the training loss gives it, as in the JAX
# package)
CAPTURE_MIN_PSNR = 15.5
# the trained Depth and Normals frames against the raytracer on view 0's
# opaque pixels: the mean abs difference of the distance (first reading
# 0.0092 of a mean distance of 0.689) and the mean cosine between the
# normals (first reading 0.265: after 128 steps the finest levels of the
# hash grid are still noise, and a normal is a gradient)
CAPTURE_DEPTH_TOL, CAPTURE_NORMAL_COS = 0.03, 0.15
# the share of the sphere's pixels that must be opaque (alpha > 0.99)
CAPTURE_MIN_OPAQUE = 0.5
# Shade by render_tile against the wavefront renderer: the same samples
# through the same kernel, composited in another order
CAPTURE_TILE_MAX_ABS = 1e-3
# phase 6's run at aabb_scale 4: steps with the defaults, and the last of
# them during which the march's cascades are counted
AABB4_STEPS, AABB4_COUNTED = 64, 4
# phase 10, Image mode: the image's side, steps (half stochastic, half
# exact), the batch, and the floor of PSNR after IMAGE_STEPS steps (set
# after the first reading)
IMAGE_SIDE, IMAGE_STEPS, IMAGE_BATCH = 4096, 512, 1 << 18
# 2 dB under the lowest of the first four readings, 35.75-37.70 (PSNR
# after the last step moves by 2 dB between runs: the table gradient's
# atomic adds change the order of its sums)
IMAGE_MIN_PSNR = 33.7
# phase 11: the marching-cubes resolution; the band around the scene's
# sphere (r = 0.22 at the box's centre) in which at least MESH_IN_BAND of
# the mesh's vertices must lie (first reading 56.9 %: the rest is an inner
# shell, where the occupancy grid has let the unseen inside of the sphere
# fall below its threshold and the field is -10000, as in the JAX package),
# and how far from 0.22 the 95th percentile of the vertices' radius, the
# outer surface, may lie (first reading 0.2161)
MESH_RES = 256
MESH_RADIUS_BAND, MESH_IN_BAND, MESH_OUTER_TOL = 0.05, 0.5, 0.01
POSE_NOISE, POSE_STEPS, POSE_SIZE = 0.01, 256, 200
# the rotation vector's spread, in radians (0.57 degrees: ~2 pixels at the
# edge of a 200x200 view)
POSE_ROT_NOISE = 0.01
# cam_grad_interval: the default, and the gradient on every step (which
# also means the exact encode on every step)
POSE_INTERVALS = (16, 1)
# the JAX package's quality record on this scene (PSNR in dB by step, from
# walkthrough_out/lr_decay_run/time_to_30db_r5.json; trained with the
# testbed's defaults, as --curve trains here), and how far from it, above
# or below, a milestone of --curve may lie
CURVE_RECORD_DB = {128: 23.41, 256: 26.974, 512: 31.037, 1024: 33.06}
CURVE_SLACK_DB = 1.5
CURVE_VIEWS = (0, 16, 32, 48)
# phase 12: the f-theta lens of a 48x48 frame (five coefficients, then the
# calibration image's width and height) and the aperture
LENS_FTHETA_PARAMS = (0.0, 2.2e-2, 1e-5, -2e-7, 1e-9, 48.0, 48.0)
APERTURE_SIZE, APERTURE_FOCUS_Z = 0.02, 0.85
# phase 13, Volume mode: the cloud's grid side and peak density (the
# global majorant), steps after the first, and the batch (4 vertices a
# path)
VOLUME_SIDE, VOLUME_PEAK = 128, 20.0
VOLUME_STEPS, VOLUME_BATCH = 16, 1 << 18
# phase 14, SDF mode: the marching-cubes resolution of the bumpy sphere
# and the fewest triangles it must have, train steps and batch of each
# configuration, the IoU samples and floors (half the first readings after
# SDF_STEPS + 3 steps at base.json's learning rate of 1e-4: 0.1988 and
# 0.2692), the GT oracles' silhouette agreement (the JAX package's test
# asks 0.9), and the small card-vs-CPU check's depth tolerance and share of
# pixels (a bf16 flip moves a distance by ~1e-3 and the trace's stop test
# with it)
SDF_MESH_RES, SDF_MIN_TRIANGLES = 208, 100_000
SDF_STEPS, SDF_BATCH, SDF_IOU_SAMPLES = 16, 1 << 18, 1 << 20
SDF_MIN_IOU = {"base": 0.099, "takikawa": 0.134}
GT_SILHOUETTE_AGREE = 0.9
SDF_CPU_DEPTH_TOL, SDF_CPU_PIXEL_SHARE = 5e-3, 0.95
# phase 3: the other nets the configurations produce, each timed beside a
# chain of bf16 matmul calls: (name, widths, output activation); the
# hidden activation is ReLU in every configuration
CONFIG_NETS = (("nerf_base_density", [32, 64, 16], "None"),
               ("nerf_base_rgb_image_base", [32, 64, 64, 3], "None"),
               ("nerf_0layer_linear_rgb", [32, 3], "None"),
               ("nerf_1layer_rgb", [32, 64, 3], "None"),
               ("nerf_3layer_rgb", [32, 64, 64, 64, 3], "None"),
               ("nerf_densegrid_1res_density", [16, 64, 16], "None"),
               ("nerf_linear_density", [32, 16], "None"),
               ("image_frequency_oneblob", [64, 64, 64, 3], "None"),
               ("sdf_base_hashgrid", [32, 64, 64, 1], "None"),
               ("sdf_takikawa", [24, 64, 64, 1], "None"),
               ("volume_base", [32, 64, 64, 4], "ReLU"))
# phase 3: the nets of the configurations whose weights do not fit in
# shared memory at once, which take the streamed kernel
WIDE_NETS = (("nerf_frequency_density", [96] + [256] * 7 + [16]),
             ("nerf_frequency_rgb", [40, 256, 3]),
             ("nerf_none_density", [3] + [256] * 7 + [16]),
             ("nerf_none_rgb", [19, 256, 3]),
             ("sdf_frequency", [60] + [128] * 8 + [1]),
             ("sdf_oneblob", [96] + [128] * 6 + [1]))
# phase 3b, the grid encode's kernels: points of the timed checks (at
# configs/nerf/base.json's width), the ragged counts each configuration's
# grid is checked at first, and the tolerances the card tests state (the
# exact forward sums 2^d products of order 1 in another order; the input
# gradient sums products of order scale in another order, relative to the
# reference's largest value; the table gradient, of the reference's
# largest value, where it is not the plain card path's bits: sums of up to
# a few thousand deposits of order 1 in another grouping. The result line
# says where the stochastic forward and the deposits gave the plain bits)
GRID_POINTS = 1 << 20
GRID_SMALL = (1, 255, 257, 100003)
GRID_MAX_ABS = 1e-5
GRID_INPUT_REL = 1e-4
GRID_DEPOSIT_REL = 1e-5
# the grids of the other configurations, checked at GRID_SMALL points:
# (name, mode, config)
GRID_CONFIGS = (("image_base", "image", "base"),
                ("volume_sdf_base", "volume", "base"),
                ("nerf_densegrid", "nerf", "densegrid"),
                ("nerf_densegrid_1res", "nerf", "densegrid_1res"))
# the paths whose grid launches phase 4 on count, each from 0
GRID_PATHS = ("density pass", "render", "train default", "train exact",
              "capture", "image", "volume", "sdf", "geometry")
# the paths whose frames go through the wavefront renderer
MARCH_PATHS = ("render", "train default", "train exact", "capture")
# phase 15, Geometry mode: frames of the scene, the card against the CPU
GEOMETRY_SIZE, GEOMETRY_SMALL = 400, 48
SCREENSHOT = (1920, 1080)
# phase 16: steps of configs/nerf/frequency.json on the orbit scene, the
# side of its frame and of the SDF frames, steps of the CLI's capture
WIDE_STEPS, WIDE_SIZE, CLI_STEPS = 32, 200, 64


def look_at(eye, center, up):
    import numpy as np

    f = center - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    return np.stack([r, u, f, eye], axis=1).astype(np.float32)


def orbit_camera(angle, elevation, radius=0.85):
    import numpy as np

    c = np.array([0.5, 0.5, 0.5], np.float32)
    eye = c + radius * np.array([np.cos(angle) * np.cos(elevation),
                                 np.sin(elevation),
                                 np.sin(angle) * np.cos(elevation)],
                                np.float32)
    return look_at(eye, c, np.array([0, 1, 0], np.float32))


def undistort_opencv(xd, yd, k1, k2, p1, p2, n_iterations=12):
    """The undistorted image-plane point whose OpenCV-distorted image is
    (xd, yd): the fixed point of x = xd - delta(x), in float64 (the
    raytracer's own inverse, independent of the port's Newton solver)."""
    import numpy as np

    xd, yd = np.asarray(xd, np.float64), np.asarray(yd, np.float64)
    x, y = xd.copy(), yd.copy()
    for _ in range(n_iterations):
        r2 = x * x + y * y
        radial = k1 * r2 + k2 * r2 * r2
        dx = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = y * radial + 2 * p2 * x * y + p1 * (r2 + 2 * y * y)
        x, y = xd - dx, yd - dy
    return x.astype(np.float32), y.astype(np.float32)


def trace_sphere(cam, size, focal, lens=None):
    """The scene's ground truth through a pinhole, or through the OpenCV
    lens `lens` = (k1, k2, p1, p2): a lambertian sphere (r = 0.22 at the
    box's centre) with an octant-checker albedo and a smooth band, lit
    from the camera -> (hit (H, W) bool, distance t along the normalized
    ray, the sphere's normal n, the rays' directions, the linear shade)."""
    import numpy as np

    c = np.array([0.5, 0.5, 0.5], np.float32)
    r = 0.22
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) + 0.5
    px, py = (xx - size / 2) / focal, (yy - size / 2) / focal
    if lens is not None:
        px, py = undistort_opencv(px, py, *lens)
    dirs = np.stack([px, py, np.ones_like(xx)], -1)
    dirs = dirs @ cam[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = cam[:3, 3]
    oc = o - c
    b = np.einsum("hwc,c->hw", dirs, oc)
    disc = b * b - (oc @ oc - r * r)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    n = (o + dirs * t[..., None] - c) / r
    octant = ((n[..., 0] > 0).astype(int) + (n[..., 1] > 0).astype(int) * 2
              + (n[..., 2] > 0).astype(int) * 4)
    palette = np.array(
        [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9],
         [0.9, 0.9, 0.2], [0.9, 0.2, 0.9], [0.2, 0.9, 0.9],
         [0.95, 0.6, 0.2], [0.85, 0.85, 0.85]], np.float32)
    band = 0.5 + 0.5 * np.sin(12.0 * np.arcsin(np.clip(n[..., 1], -1, 1)))
    albedo = palette[octant] * (0.6 + 0.4 * band[..., None])
    lam = np.clip(-np.einsum("hwc,hwc->hw", n, dirs), 0.0, 1.0)
    shade = albedo * (0.25 + 0.75 * lam[..., None])
    return hit, t, n, dirs, shade


def raytrace_view(cam, size, focal):
    """A pinhole view of the scene over transparent black -> (H, W, 4)
    uint8 sRGB."""
    import numpy as np

    hit, _, _, _, shade = trace_sphere(cam, size, focal)
    srgb = np.where(shade <= 0.0031308, shade * 12.92,
                    1.055 * shade ** (1 / 2.4) - 0.055)
    img = np.zeros((size, size, 4), np.float32)
    img[..., :3] = np.where(hit[..., None], srgb, 0.0)
    img[..., 3] = hit.astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def scene_cameras(n_cams):
    """The orbit of `make_scene`: n_cams cameras at a radius of 0.85 and
    seeded elevations, looking at the box's centre."""
    import numpy as np

    rng = np.random.RandomState(7)
    cams = []
    for i in range(n_cams):
        ang = i / n_cams * 2 * np.pi
        elev = 0.15 + 0.5 * rng.rand()
        eye = np.array([0.5 + 0.85 * np.cos(ang) * np.cos(elev),
                        0.5 + 0.85 * np.sin(elev),
                        0.5 + 0.85 * np.sin(ang) * np.cos(elev)], np.float32)
        cams.append(look_at(eye, np.array([0.5, 0.5, 0.5], np.float32),
                            np.array([0, 1, 0], np.float32)))
    return cams


def make_scene(n_cams=64, size=400):
    """The synthetic orbit scene of scripts/time_to_30db_r5.py::make_scene
    as the port's dataset: n_cams pinhole views from a radius of 0.85 at
    seeded elevations, focal 1.1 * size, aabb_scale 1."""
    import numpy as np

    from instant_ngp_tpu_torch.data.nerf_loader import (FrameMetadata, Lens,
                                                        NerfDataset)

    focal = size * 1.1
    imgs, xforms, metas = [], [], []
    for cam in scene_cameras(n_cams):
        imgs.append(raytrace_view(cam, size, focal))
        xforms.append(cam)
        metas.append(FrameMetadata(
            (size, size), np.array([focal, focal], np.float32),
            np.array([0.5, 0.5], np.float32), np.zeros(4, np.float32),
            Lens()))
    return NerfDataset(paths=[f"synth{i}" for i in range(n_cams)],
                       images=imgs, depths=[None] * n_cams,
                       rays=[None] * n_cams, metadata=metas,
                       xforms_start=np.stack(xforms),
                       xforms_end=np.stack(xforms), aabb_scale=1)


def sky_color(dirs):
    """The capture's background: a smooth linear colour by direction."""
    return 0.35 + 0.25 * dirs


def write_capture(root, n_cams, size, n_extra_dims):
    """Write the scene to `root` as a capture on disk, as a user's would
    lie there: `transforms.json` (aabb_scale, focal length and principal
    point in pixels, the OpenCV lens CAPTURE_LENS, n_extra_learnable_dims,
    one NeRF-convention camera matrix per frame) and the views as half
    EXR files, linear, over the sky instead of transparent black. The
    views are raytraced through the lens by `trace_sphere`.
    -> (the transforms path, per view: the hit mask, the distance along
    the ray and the sphere's normal)."""
    import numpy as np

    from instant_ngp_tpu_torch.data.exr import write_exr
    from instant_ngp_tpu_torch.data.nerf_loader import NerfDataset

    focal = size * 1.1
    lens = tuple(CAPTURE_LENS[k] for k in ("k1", "k2", "p1", "p2"))
    to_nerf = NerfDataset([], [], [], [], [], None, None).ngp_matrix_to_nerf
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    frames, truth = [], []
    for i, cam in enumerate(scene_cameras(n_cams)):
        hit, t, n, dirs, shade = trace_sphere(cam, size, focal, lens)
        rgba = np.ones((size, size, 4), np.float32)
        rgba[..., :3] = np.where(hit[..., None], shade, sky_color(dirs))
        name = f"images/{i:04d}.exr"
        write_exr(os.path.join(root, name), rgba, half=True)
        matrix = np.concatenate([to_nerf(cam), [[0, 0, 0, 1]]]).tolist()
        frames.append({"file_path": name, "transform_matrix": matrix})
        truth.append((hit, np.where(hit, t, 0.0).astype(np.float32), n))
    path = os.path.join(root, "transforms.json")
    with open(path, "w") as f:
        json.dump(dict(CAPTURE_LENS, aabb_scale=1, w=size, h=size,
                       fl_x=focal, fl_y=focal, cx=size / 2, cy=size / 2,
                       n_extra_learnable_dims=n_extra_dims, frames=frames),
                  f)
    return path, truth


def load_capture(path, truth):
    """`load_nerf` the capture and put the raytracer's depths into it."""
    from instant_ngp_tpu_torch.data.nerf_loader import load_nerf

    ds = load_nerf(path)
    ds.depths = [depth for _, depth, _ in truth]
    return ds


def counting_launches(fused_mlp_forward, counts, kind, fn):
    """`fn`, with the kernel launches it makes added to counts[kind]."""
    def wrapper(*args, **kwargs):
        before = fused_mlp_forward.launches
        out = fn(*args, **kwargs)
        counts[kind] += fused_mlp_forward.launches - before
        return out
    return wrapper


def check_variants(by_variant, expected, what):
    """Fail unless the kernel's launches went to exactly the variants
    `expected` {shape's name: variant}, each at least once: the general
    kernel is the expected path of the shapes named so here, and of no
    other."""
    wrong = set(by_variant) - set(expected.values())
    missing = [name for name, v in expected.items()
               if by_variant.get(v, 0) == 0]
    if wrong or missing:
        raise RuntimeError(
            f"{what}: launches by variant {by_variant}; expected "
            f"{expected}" + (f", not {sorted(wrong)}" if wrong else "")
            + (f"; none for {missing}" if missing else ""))


def capture_from_disk(cfg, dev, smi, fused_mlp_forward, variants, profile):
    """Phase 9 -> (the kernel's launches by variant over the phase, the
    times of one warm frame per render mode)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.eval import eval_nerf_views
    from instant_ngp_tpu_torch.nerf.render import RENDER_TILE_MODES
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    root = tempfile.mkdtemp(prefix="capture_")
    try:
        t0 = time.perf_counter()
        path, truth = write_capture(root, 64, WIDTH, CAPTURE_EXTRA_DIMS)
        write_s = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(root, "images", f))
                      for f in os.listdir(os.path.join(root, "images")))
        t0 = time.perf_counter()
        ds = load_capture(path, truth)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root)
    print(f"capture: {ds.n_images} views of {WIDTH}x{HEIGHT} raytraced "
          f"through the lens {CAPTURE_LENS} and written as half EXR "
          f"({n_bytes / 2 ** 20:.1f} MiB) in {write_s:.2f} s; load_nerf "
          f"{load_s:.2f} s on the host: lens {ds.metadata[0].lens.mode}, "
          f"HDR {ds.is_hdr}, {ds.images[0].dtype} pixels, "
          f"{ds.n_extra_learnable_dims} latent dims", flush=True)
    if not (ds.is_hdr and ds.metadata[0].lens.mode == "OpenCV"
            and ds.n_extra_learnable_dims == CAPTURE_EXTRA_DIMS
            and ds.images[0].shape == (HEIGHT, WIDTH, 4)):
        raise RuntimeError("load_nerf did not read the capture as written")

    tb = NerfTestbed(ds, cfg, device=dev, compute_dtype=torch.bfloat16,
                     seed=SEED)
    tb.train_envmap = tb.optimize_distortion = True
    tb.depth_supervision_lambda = CAPTURE_DEPTH_LAMBDA
    rgb_dims = [tb.model.rgb_net.weights[0].shape[0]] \
        + [w.shape[1] for w in tb.model.rgb_net.weights]
    if not (tb.optimize_extra_dims and tb.scene.lens_mode == 1
            and tb.scene.rgb_activation == "Exponential"
            and rgb_dims == [32 + CAPTURE_EXTRA_DIMS, 64, 64, 3]):
        raise RuntimeError(f"the capture's testbed is not an HDR, OpenCV "
                           f"lens, latent-dims one (RGB net {rgb_dims})")
    start = {"envmap": tb.envmap.params.clone(),
             "distortion map": tb.distortion_map.params.clone(),
             "latent codes": tb.data.extra_dims.clone()}
    psnr_before = tb.eval_psnr(0)

    counts = {"prep": 0, "step": 0}
    tb.training_prep = counting_launches(fused_mlp_forward, counts, "prep",
                                         tb.training_prep)
    tb.train_step = counting_launches(fused_mlp_forward, counts, "step",
                                      tb.train_step)
    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    first_loss = tb.train(1)
    tb.train(TRAIN_WARMUP - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last_loss = tb.train(TRAIN_STEPS - TRAIN_WARMUP)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    del tb.training_prep, tb.train_step
    launches_train = fused_mlp_forward.launches
    n_timed = TRAIN_STEPS - TRAIN_WARMUP
    moved = {k: (now - start[k]).abs().max().item() for k, now in (
        ("envmap", tb.envmap.params),
        ("distortion map", tb.distortion_map.params),
        ("latent codes", tb.data.extra_dims))}
    psnr_after = tb.eval_psnr(0)
    print(f"capture: {TRAIN_STEPS} steps with train_envmap, "
          f"optimize_distortion, optimize_extra_dims and "
          f"depth_supervision_lambda {CAPTURE_DEPTH_LAMBDA}; the last "
          f"{n_timed} in {train_s:.3f} s: {n_timed / train_s:.2f} steps/s "
          f"(every step rebuilds its rays through the distortion map and "
          f"encodes exactly) [{smi}]")
    print(f"capture: loss {first_loss:.6f} -> {last_loss:.6f}; largest "
          f"change of the " + ", ".join(f"{k} {v:.3g}"
                                        for k, v in moved.items())
          + f"; PSNR of view 0 through its lens {psnr_before:.2f} dB -> "
          f"{psnr_after:.2f} dB; kernel launches: {counts['prep']} by "
          f"density updates, {counts['step']} by train steps", flush=True)
    if not last_loss < first_loss:
        raise RuntimeError("the capture's training loss did not fall")
    if min(moved.values()) <= 0.0:
        raise RuntimeError(f"a trainable buffer did not move: {moved}")
    if counts["prep"] == 0 or counts["step"] != 0 \
            or launches_train != counts["prep"]:
        raise RuntimeError("the kernel must be launched by the density "
                           "updates and never by a train step")
    if not (psnr_after > psnr_before and psnr_after >= CAPTURE_MIN_PSNR):
        raise RuntimeError(f"PSNR of view 0 is {psnr_after:.2f} dB (from "
                           f"{psnr_before:.2f}; at least {CAPTURE_MIN_PSNR} "
                           f"asked)")

    # every render mode through view 0's own lens, principal point and
    # latent code; the second frame of each is the timed one
    hit, depth_true, normal_true = truth[0]
    frames, times = {}, {}
    for mode in RENDER_TILE_MODES + ("Distortion", "Slice"):
        before = fused_mlp_forward.launches
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "Slice":
                frame = tb.render_density_slice(WIDTH)
                samples = WIDTH * WIDTH
            else:
                frame = tb.render_training_view(0, render_mode=mode)
                samples = tb.last_frame_n_samples if mode != "Distortion" \
                    else 0
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        launched = (fused_mlp_forward.launches - before) // 2
        frames[mode] = frame
        times[mode] = {"ms": 1e3 * sec, "samples": samples,
                       "launches": launched,
                       "by": "render_tile" if mode in RENDER_TILE_MODES
                       and not tb._uses_wavefront(mode) else
                       "wavefront" if mode in RENDER_TILE_MODES else "host"}
        print(f"capture: {mode} frame {WIDTH}x{HEIGHT} ({times[mode]['by']}"
              f"): {1e3 * sec:.1f} ms warm, {samples} samples, {launched} "
              f"kernel launches [{smi}]", flush=True)
        if frame.shape[:2] != (HEIGHT, WIDTH) \
                or not np.isfinite(frame).all() \
                or float(frame[..., :3].std()) <= 1e-4:
            raise RuntimeError(f"the {mode} frame is not finite, constant "
                               f"or of the wrong shape")
        # Normals differentiate the density network: plain matmuls under
        # grad, no kernel; Distortion marches nothing
        if (launched == 0) != (mode in ("Normals", "Distortion")):
            raise RuntimeError(f"the {mode} frame launched the kernel "
                               f"{launched} times")

    # the Shade frame's PSNR on the sphere's pixels, on the sky's and on
    # the whole frame: a fog over the sphere shows in the first, the sky's
    # missing sRGB transfer (fault 5 of the JAX package) in the second
    from instant_ngp_tpu_torch.metrics import mse, psnr

    gt = tb._gt_srgb(0, WIDTH, HEIGHT, 1)
    shade = np.clip(frames["Shade"][..., :3], 0.0, 1.0)
    split = {k: psnr(mse(shade[m], gt[m])) for k, m in (
        ("sphere", hit), ("sky", ~hit), ("frame", np.ones_like(hit)))}
    times["psnr_view0_db"] = split
    print(f"capture: PSNR of view 0's Shade frame {split['sphere']:.2f} dB "
          f"on the {hit.sum()} pixels the sphere covers, {split['sky']:.2f} "
          f"dB on the sky's, {split['frame']:.2f} dB on the whole frame",
          flush=True)

    opaque = hit & (frames["AO"][..., 3] > 0.99)
    depth_err = np.abs(frames["Depth"][..., 0] - depth_true)[opaque].mean()
    normal = frames["Normals"][..., :3] * 2.0 - 1.0
    normal_dot = (normal * normal_true).sum(-1)[opaque].mean()
    print(f"capture: on the {opaque.sum()} opaque pixels of view 0 (of "
          f"{hit.sum()} the sphere covers): Depth frame against the "
          f"raytracer's distance, mean abs {depth_err:.4f} (of "
          f"{depth_true[opaque].mean():.3f}); Normals frame against the "
          f"sphere's normals, mean cosine {normal_dot:.3f}")
    if opaque.sum() < CAPTURE_MIN_OPAQUE * hit.sum():
        raise RuntimeError(f"less than {CAPTURE_MIN_OPAQUE} of the sphere's "
                           f"pixels are opaque")
    if depth_err > CAPTURE_DEPTH_TOL or normal_dot < CAPTURE_NORMAL_COS:
        raise RuntimeError("the Depth or Normals frame disagrees with the "
                           "raytracer")

    # Shade by render_tile against Shade by the wavefront renderer
    if not tb._uses_wavefront("Shade"):
        raise RuntimeError("Shade must go through the wavefront renderer")
    # with a budget that holds a whole tile's candidates (8192 rays of at
    # most 512): where the budget binds, render_tile sheds every ray's deep
    # tail, which the early-out renderer never does
    budget = tb.render_query_budget
    tb.render_wavefront, tb.render_query_budget = False, 1 << 22
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tile_frame = tb.render_training_view(0)
        torch.cuda.synchronize()
        tile_ms = 1e3 * (time.perf_counter() - t0)
    tile_samples = tb.last_frame_n_samples
    tb.render_wavefront, tb.render_query_budget = True, budget
    tile_err = np.abs(tile_frame - frames["Shade"])
    times["Shade by render_tile"] = {"ms": tile_ms, "samples": tile_samples}
    print(f"capture: Shade by render_tile {tile_ms:.1f} ms warm, "
          f"{tile_samples} samples, against the wavefront renderer's "
          f"{times['Shade']['ms']:.1f} ms and {times['Shade']['samples']} "
          f"samples: max abs {tile_err.max():.3g}, mean abs "
          f"{tile_err.mean():.3g} [{smi}]")
    if tile_err.max() > CAPTURE_TILE_MAX_ABS:
        raise RuntimeError("render_tile and the wavefront renderer "
                           "disagree")

    scores = eval_nerf_views(tb, indices=[0, 32], spp=1, verbose=False)
    print(f"capture: eval_nerf_views over views 0 and 32: PSNR "
          f"{scores['psnr_avg']:.2f} dB, SSIM {scores['ssim_avg']:.4f}",
          flush=True)
    if not np.isfinite([scores["psnr_avg"], scores["ssim_avg"]]).all():
        raise RuntimeError("the eval scores are not finite")

    by_variant = dict(fused_mlp_forward.launches_by_variant)
    check_variants(by_variant, variants, "the capture's path")
    print(f"capture: kernel launches by variant {by_variant}", flush=True)
    if profile:
        profile_modes(tb, smi)
        profile_training(tb, smi, profile)
    return by_variant, times


def profile_modes(tb, smi):
    """--profile: where a warm 400x400 frame's time goes in each marching
    render mode (CUDA-event spans around the encode and the two MLPs)."""
    import torch

    from instant_ngp_tpu_torch.nerf.render import RENDER_TILE_MODES

    model = tb.inference_model
    layers = [("hash-grid encode", model.pos_encoding),
              ("density MLP", model.density_net),
              ("direction encode", model.dir_encoding),
              ("RGB MLP", model.rgb_net)]
    for mode in RENDER_TILE_MODES:
        spans = EventSpans()
        for name, mod in layers:
            mod.forward = spans.wrap(name, mod.forward)
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tb.render_training_view(0, render_mode=mode)
            end.record()
            end.synchronize()
        finally:
            for _, mod in layers:
                del mod.forward
        ms = start.elapsed_time(end)
        parts = {name: spans.ms(name) for name, _ in layers}
        print(f"profile: {mode} frame {ms:.1f} ms on the device's clock: "
              + ", ".join(f"{k} {v:.1f} ms ({100 * v / ms:.0f} %)"
                          for k, v in parts.items())
              + f", the rest {ms - sum(parts.values()):.1f} ms (for "
              f"Normals the encode's and the MLP's backward are in the "
              f"rest) [{smi}]", flush=True)


def occupied_bits(tb):
    import numpy as np

    return int(np.unpackbits(tb.bitfield.cpu().numpy()).sum())


class EventSpans:
    """CUDA-event spans by name: `wrap` times every call of a function on
    the device's clock without synchronising."""

    def __init__(self):
        self.spans = {}

    def wrap(self, name, fn):
        import torch

        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.spans.setdefault(name, []).append((start, end))
            return out
        return wrapper

    def ms(self, name):
        return sum(s.elapsed_time(e) for s, e in self.spans.get(name, []))

    def calls(self, name):
        return len(self.spans.get(name, []))


def profiler_kernels(prof):
    """(the profiler's rows, its CUDA kernels' rows, a row's own device
    time in us). An operator's row repeats the time of the kernels it
    launched, so only the kernels' own rows are counted."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()

    def self_device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    return (rows, [e for e in rows if e.device_type == DeviceType.CUDA],
            self_device_us)


def train_on_card(ds, cfg, dev, smi, fused_mlp_forward, mode):
    """Phase 6, `mode` "default" or "exact" -> (the trained testbed, the
    kernel's launches by variant during the 128 steps, and during the
    whole phase)."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu_torch.ops.kernels.round_kernels import rgb_net_rows

    tb = NerfTestbed(ds, cfg, device=dev, compute_dtype=torch.bfloat16,
                     seed=SEED)
    if not (tb.stochastic_corners and tb.use_error_map_sampling
            and tb.model.pos_encoding.stochastic_exact_axes == 1
            and tb.model.pos_encoding.stochastic_bwd):
        raise RuntimeError("the testbed's defaults are not base.json's "
                           "stochastic encode with error-map sampling")
    if mode == "exact":
        tb.stochastic_corners = False
    tag = f"train[{mode}]"
    print(f"{tag}: stochastic corners {tb.stochastic_corners} (exact axes "
          f"{tb.model.pos_encoding.stochastic_exact_axes}, one-corner "
          f"backward {tb.model.pos_encoding.stochastic_bwd}), error-map "
          f"sampling {tb.use_error_map_sampling}; n_march {tb.n_march}, "
          f"target batch {tb.target_batch_size}, rays per batch "
          f"{tb.rays_per_batch}, pixels {tuple(tb.data.pixels.shape)} "
          f"{tb.data.pixels.dtype} on {tb.data.pixels.device}", flush=True)
    psnr_before = tb.eval_psnr(0)

    # count the kernel's launches by who made them, and time each density
    # update on the device's clock
    counts = {"prep": 0, "step": 0}
    spans = EventSpans()
    prep, step = tb.training_prep, tb.train_step

    def timed_prep(*args, **kwargs):
        name = "full sweep" \
            if tb.training_step < tb.warmup_full_grid_preps else "1/4 + 1/4"
        return spans.wrap(name, prep)(*args, **kwargs)

    tb.training_prep = counting_launches(fused_mlp_forward, counts, "prep",
                                         timed_prep)
    tb.train_step = counting_launches(fused_mlp_forward, counts, "step",
                                      step)
    # the train step's encode on the device's clock (the density updates
    # go through the inference network's own encoding)
    enc = tb.model.pos_encoding
    enc_spans = EventSpans()
    enc_patches = [("forward", "forward"), ("_table_gradient", "backward"),
                   ("_table_gradient_stochastic", "backward")]

    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    rows_before = rgb_net_rows.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first_loss = tb.train(1)
    bits_first = occupied_bits(tb)
    tb.train(TRAIN_WARMUP - 1)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    rays_done = 0
    for attr, name in enc_patches:
        setattr(enc, attr, enc_spans.wrap(name, getattr(enc, attr)))
    t0 = time.perf_counter()
    for _ in range((TRAIN_STEPS - TRAIN_WARMUP) // tb.sync_every):
        rays = tb.rays_per_batch
        last_loss = tb.train(tb.sync_every)
        rays_done += rays * tb.sync_every
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    for attr, _ in enc_patches:
        delattr(enc, attr)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches_train = fused_mlp_forward.launches
    by_variant = dict(fused_mlp_forward.launches_by_variant)
    rows_train = rgb_net_rows.launches - rows_before
    del tb.training_prep, tb.train_step
    n_timed = TRAIN_STEPS - TRAIN_WARMUP
    bits_last = occupied_bits(tb)
    psnr_after = tb.eval_psnr(0)
    perf = tb.performance_stats()

    print(f"{tag}: {TRAIN_STEPS} steps; the first {TRAIN_WARMUP} (camera "
          f"visibility, {tb.warmup_full_grid_preps} full sweeps) in "
          f"{warmup_s:.3f} s; the other {n_timed} in {train_s:.3f} s: "
          f"{n_timed / train_s:.2f} steps/s, "
          f"{n_timed * tb.measured_batch_size / train_s:.4g} samples/s "
          f"(at the last sync's {tb.measured_batch_size} samples a step), "
          f"{rays_done / train_s:.4g} rays/s [{smi}]")
    print(f"{tag}: loss {first_loss:.6f} at step 1 -> {last_loss:.6f} at "
          f"step {tb.training_step}; rays per batch {tb.rays_per_batch}, "
          f"{perf['mean_samples_per_ray']:.2f} samples per ray, "
          f"{tb.measured_batch_size_before_compaction} samples generated")
    if enc_spans.calls("forward") != n_timed \
            or enc_spans.calls("backward") != n_timed:
        raise RuntimeError("each train step must encode once forward and "
                           "once backward")
    print(f"{tag}: encode of a train step on the device's clock, mean of "
          f"{n_timed} steps: forward {enc_spans.ms('forward') / n_timed:.3f}"
          f" ms, backward {enc_spans.ms('backward') / n_timed:.3f} ms "
          f"[{smi}]")
    for name in ("full sweep", "1/4 + 1/4"):
        n = max(spans.calls(name), 1)
        print(f"{tag}: density update, {name}: "
              f"{spans.ms(name) / n / 1e3:.4f}"
              f" s each on the device's clock, {spans.calls(name)} calls "
              f"[{smi}]")
    print(f"{tag}: error map {tb._error_map_res}, CDFs "
          f"{'in use' if tb._error_cdfs is not None else 'not yet'}; host "
          f"reads {tb.host_syncs}")
    print(f"{tag}: occupied bits {bits_first} after the first update -> "
          f"{bits_last}; PSNR of view 0 {psnr_before:.2f} dB -> "
          f"{psnr_after:.2f} dB; peak {peak_gib:.2f} GiB allocated; kernel "
          f"launches: {counts['prep']} by density updates, "
          f"{counts['step']} by train steps, {launches_train} in all",
          flush=True)

    cam = orbit_camera(angle=0.3, elevation=0.4)
    for warmth in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = tb.render_frame(WIDTH, HEIGHT, cam, focal_length=FOCAL)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        print(f"{tag}: trained frame {WIDTH}x{HEIGHT} ({warmth}): "
              f"{sec:.3f} s, "
              f"{tb.last_frame_n_samples} samples (untrained, seeded "
              f"weights: see the frame above), "
              f"{tb.last_frame_n_samples / sec:.4g} samples/s [{smi}]")
    by_variant_all = dict(fused_mlp_forward.launches_by_variant)

    if not last_loss < first_loss:
        raise RuntimeError("the training loss did not fall")
    if tb.measured_batch_size <= 0:
        raise RuntimeError("training generated no samples")
    if counts["prep"] == 0 or counts["step"] != 0 \
            or launches_train != counts["prep"]:
        raise RuntimeError("the kernel must be launched by the density "
                           "updates and never by a train step")
    if rows_train != 0:
        raise RuntimeError(f"the train steps and density updates launched "
                           f"the RGB rows kernel {rows_train} times")
    if not bits_last < bits_first:
        raise RuntimeError("the occupancy grid did not thin out")
    if tb.host_syncs != {"camera_updates": 0, "error_cdfs": 1}:
        raise RuntimeError(f"128 steps rebuild the error CDFs once and "
                           f"update no camera: {tb.host_syncs}")
    if not (psnr_after > psnr_before
            and psnr_after >= TRAIN_MIN_PSNR[mode]):
        raise RuntimeError(f"PSNR of view 0 is {psnr_after:.2f} dB after "
                           f"{TRAIN_STEPS} steps (from {psnr_before:.2f}; "
                           f"at least {TRAIN_MIN_PSNR[mode]} asked)")
    if not np.isfinite(frame).all() or tb.last_frame_n_samples <= 0:
        raise RuntimeError("the trained frame is not finite or empty")
    return tb, by_variant, by_variant_all


def nerf_state(tb):
    """The tensors a NeRF testbed carries from one step to the next: the
    parameters, the optimizer state, the occupancy, the error map and its
    CDFs, the camera gradients accumulated for the host's next update and
    the distortion map with its optimizer state."""
    from instant_ngp_tpu_torch.ops.optimizers import tree_leaves

    extra = [tb._error_map, tb._exposure_grad_accum,
             *(tb._error_cdfs or {}).values(),
             *(tb._cam_grad_accum or {}).values()]
    return [*tree_leaves(tb.model.param_tree()),
            *tree_leaves([tb.opt_state[k] for k in ("step", "m", "v", "ema")]),
            tb.density_grid, tb.bitfield,
            *tree_leaves(tb.distortion_map.state),
            *[t for t in extra if t is not None]]


def repeatable_training(ds, cfg, dev, smi):
    """Phase 6b: base.json with the testbed's defaults trains REPEAT_STEPS
    steps twice from SEED, past the error CDFs' rebuild at step 128: both
    runs must end with the same bits in every tensor `nerf_state` names.
    Then the same steps with error-map sampling off, beside them: PSNR of
    view 0 and steps/s of each run (over the steps after TRAIN_WARMUP)."""
    import torch

    from instant_ngp_tpu_torch.determinism import digest
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    runs = {}
    for tag, error_map in (("error map", True), ("error map, again", True),
                           ("no error map", False)):
        tb = NerfTestbed(ds, cfg, device=dev, compute_dtype=torch.bfloat16,
                         seed=SEED)
        tb.use_error_map_sampling = error_map
        tb.train(TRAIN_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tb.train(REPEAT_STEPS - TRAIN_WARMUP)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        runs[tag] = {"loss": loss, "psnr": tb.eval_psnr(0),
                     "steps_per_s": (REPEAT_STEPS - TRAIN_WARMUP) / sec,
                     "cdf_rebuilds": tb.host_syncs["error_cdfs"],
                     "digest": digest(*nerf_state(tb))}
        print(f"train[repeat]: {tag}: {REPEAT_STEPS} steps, loss {loss:.6f}"
              f", PSNR of view 0 {runs[tag]['psnr']:.2f} dB, "
              f"{runs[tag]['steps_per_s']:.2f} steps/s after "
              f"{TRAIN_WARMUP}, {runs[tag]['cdf_rebuilds']} CDF rebuilds, "
              f"state digest {runs[tag]['digest'][:16]} [{smi}]", flush=True)
        del tb
    first, second = runs["error map"], runs["error map, again"]
    if first["cdf_rebuilds"] != 1 or runs["no error map"]["cdf_rebuilds"]:
        raise RuntimeError(f"{REPEAT_STEPS} steps must rebuild the CDFs "
                           f"once with the error map and never without")
    if first["digest"] != second["digest"]:
        raise RuntimeError("two runs from one seed part after the error "
                           "CDFs' rebuild: a sum of the step is taken in "
                           "an order that changes between runs")
    return runs


def sweep_paths(ds, dev, small, root):
    """The five train paths of the determinism sweep, at base.json's
    widths of each mode (`small`: tables of 2^14 entries a level and
    batches of 2^14, for the card tests): {name: run}, where run() builds a
    testbed from SEED, takes SWEEP_STEPS steps and returns the tensors of
    its state. NeRF with the testbed's defaults (`ds` its scene); NeRF with
    the exact encode, pose, focal and exposure optimisation (the gradient
    on every step) and the distortion map; Image; Volume; SDF on a bumpy
    sphere written to `root`."""
    import torch

    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.image.testbed_image import ImageTestbed
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu_torch.ops.optimizers import tree_leaves
    from instant_ngp_tpu_torch.sdf import SdfTestbed
    from instant_ngp_tpu_torch.volume.testbed_volume import VolumeTestbed

    cfgs = {m: load_network_config(find_network_config("base", m))
            for m in ("nerf", "image", "volume", "sdf")}
    batch = 1 << 14 if small else 1 << 18
    if small:
        for c in cfgs.values():
            c["encoding"]["log2_hashmap_size"] = 14
    mesh = os.path.join(root, "bumpy.obj")
    bumpy_sphere_obj(mesh, 48 if small else 96)
    image = procedural_image(256 if small else 1024, SEED)
    cloud = procedural_cloud(64 if small else VOLUME_SIDE, SEED)

    def nerf(camera):
        tb = NerfTestbed(ds, cfgs["nerf"], device=dev,
                         compute_dtype=torch.bfloat16, seed=SEED)
        if small:
            tb.target_batch_size, tb.rays_per_batch = batch, 1 << 10
        if camera:
            tb.stochastic_corners = False
            tb.optimize_extrinsics = tb.optimize_focal_length = True
            tb.optimize_exposure = tb.optimize_distortion = True
            tb.cam_grad_interval = 1
        tb.train(SWEEP_STEPS)
        return nerf_state(tb)

    def trainer(make):
        tb = make()
        tb.train(SWEEP_STEPS, batch)
        return tree_leaves(tb.state)

    return {
        "NeRF, defaults": lambda: nerf(False),
        "NeRF, exact, camera and distortion": lambda: nerf(True),
        "Image": lambda: trainer(lambda: ImageTestbed(
            image, cfgs["image"], seed=SEED, device=dev)),
        "Volume": lambda: trainer(lambda: VolumeTestbed(
            cloud, cfgs["volume"], seed=SEED, device=dev)),
        "SDF": lambda: trainer(lambda: SdfTestbed(
            mesh, cfgs["sdf"], seed=SEED, device=dev)),
    }


def determinism_sweep(ds, dev, smi, small=False):
    """Phase 6c: each of the five train paths of `sweep_paths` once under
    `torch.use_deterministic_algorithms(True, warn_only=True)` (with
    CUBLAS_WORKSPACE_CONFIG set), collecting every op PyTorch warns about,
    and twice with the mode off from one seed. Fails on a warned op outside
    `determinism.ORDER_FREE` or on two runs whose states differ (which
    also catches an op that the mode switches to a deterministic variant
    without a warning) -> {path: {"warned", "outside", "repeats"}}."""
    import shutil
    import tempfile

    from instant_ngp_tpu_torch.determinism import (ORDER_FREE, digest,
                                                   warned_ops)

    root = tempfile.mkdtemp(prefix="sweep_")
    out = {}
    try:
        for name, run in sweep_paths(ds, dev, small, root).items():
            _, ops = warned_ops(run)
            repeats = digest(*run()) == digest(*run())
            out[name] = {"warned": ops, "repeats": repeats, "outside": [
                op for op in ops if op not in ORDER_FREE]}
            print(f"determinism: {name}: {SWEEP_STEPS} steps warn of "
                  f"{ops or 'no op'}; outside the allow-list "
                  f"{out[name]['outside'] or 'none'}; two runs from one "
                  f"seed {'equal' if repeats else 'DIFFER'} bit for bit "
                  f"[{smi}]", flush=True)
    finally:
        shutil.rmtree(root)
    bad = {k: v for k, v in out.items() if v["outside"] or not v["repeats"]}
    if bad:
        raise RuntimeError(f"train paths that do not repeat: {bad}")
    return out


def train_curve(ds, cfg, dev, smi):
    """--curve: PSNR by training step under the JAX record's protocol,
    with the defaults (held to the record on both sides) and with the
    exact encode (printed beside it)."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    for mode in ("default", "exact"):
        tb = NerfTestbed(ds, cfg, device=dev, compute_dtype=torch.bfloat16,
                         seed=SEED)
        tb.stochastic_corners = mode == "default"
        tb.rays_per_batch = 1 << 11
        tb.adapt_ray_batch = False
        tb.render_max_samples_per_ray = tb.n_march
        train_s = 0.0
        for step, record in CURVE_RECORD_DB.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tb.train(step - tb.training_step)
            torch.cuda.synchronize()
            train_s += time.perf_counter() - t0
            per_view = [tb.eval_psnr(v, spp=2) for v in CURVE_VIEWS]
            avg = float(np.mean(per_view))
            print(f"curve[{mode}]: step {step}: PSNR {avg:.3f} dB over "
                  f"views {CURVE_VIEWS} "
                  f"({', '.join(f'{p:.2f}' for p in per_view)}), the JAX "
                  f"record {record} dB ({avg - record:+.3f}); "
                  f"{train_s:.2f} s of training, loss "
                  f"{tb.loss_scalar:.6f}, {tb.measured_batch_size} samples "
                  f"a step, {occupied_bits(tb)} occupied bits, host reads "
                  f"{tb.host_syncs} [{smi}]", flush=True)
            if mode == "default" and abs(avg - record) > CURVE_SLACK_DB:
                raise RuntimeError(
                    f"PSNR {avg:.2f} dB at step {step} is more than "
                    f"{CURVE_SLACK_DB} dB from the record's {record}")


def card_against_cpu(cfg, dev):
    """Phase 7: 2 train steps of a small network on the card and on the
    CPU, from the same seed with the same draws (the rays', the sampled
    corners' of steps and density updates): with the defaults; with pose,
    focal and exposure optimisation and the camera gradient taken on every
    step; and on a small capture loaded from disk (OpenCV lens, HDR, latent
    dims, depths) with envmap, distortion-map, latent and depth training
    on, followed by one small frame per render mode through `render_tile`."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.nerf.render import RENDER_TILE_MODES
    from instant_ngp_tpu_torch.nerf.sampler import draw_train_randoms
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu_torch.nerf.training import StepDraws
    from instant_ngp_tpu_torch.ops.grid_encoding import (CornerDraws,
                                                         draw_corner_randoms)

    small = copy.deepcopy(cfg)
    small["encoding"].update(n_levels=4, log2_hashmap_size=12)
    ds = make_scene(n_cams=4, size=32)
    root = tempfile.mkdtemp(prefix="capture_small_")
    try:
        capture = load_capture(*write_capture(root, 4, 32, 2))
    finally:
        shutil.rmtree(root)
    gradient_keys = {
        "defaults": (),
        "camera": ("cam_gradient", "exposure_gradient"),
        "switches": ("extra_dims_gradient", "envmap_gradient",
                     "distortion_gradient")}

    def corners(gen, n, exact_axes, device):
        d = draw_corner_randoms(gen, n, 3, 4, exact_axes)   # on the CPU
        return CornerDraws(d.u.to(device), None if d.axis is None
                           else d.axis.to(device))

    for case, keys in gradient_keys.items():
        losses, frames, grads = {}, {}, {}
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            tb = NerfTestbed(capture if case == "switches" else ds, small,
                             device=device, compute_dtype=torch.bfloat16,
                             seed=SEED)
            tb.target_batch_size = 1 << 14
            tb.rays_per_batch = 1 << 10
            tb.adapt_ray_batch = False
            if case == "camera":
                tb.optimize_extrinsics = tb.optimize_focal_length = True
                tb.optimize_exposure = True
                tb.cam_grad_interval = 1
            if case == "switches":
                tb.train_envmap = tb.optimize_distortion = True
                tb.depth_supervision_lambda = CAPTURE_DEPTH_LAMBDA
                tb.render_wavefront = False     # every mode by render_tile
                if not tb.optimize_extra_dims:
                    raise RuntimeError("the small capture has no latents")
            gen = torch.Generator().manual_seed(SEED + 7)   # on the CPU

            def train_draws(n_rays, tb=tb, gen=gen):
                rays = draw_train_randoms(gen, n_rays, tb.data.n_images)
                return StepDraws(rays.to(tb.device),
                                 corners(gen, tb.target_batch_size, 1,
                                         tb.device))

            def prep_draws(n_uniform, n_nonuniform, tb=tb, gen=gen):
                # full sweeps only (2 steps): no probes; the jitter and
                # one sampled corner per cell and level
                n = n_uniform + n_nonuniform
                return (None, torch.rand(n, 3, generator=gen).to(tb.device),
                        corners(gen, n, 0, tb.device))

            tb._train_draws, tb._prep_draws = train_draws, prep_draws
            losses[name], grads[name] = [], []
            for _ in range(2):
                tb.training_prep()
                stats = tb.train_step()
                tb._sync_stats(stats)
                losses[name].append(tb.loss_scalar)
                step_grads = {}
                for k in keys:
                    g = stats[k]
                    step_grads.update(g if isinstance(g, dict) else {
                        k.replace("_gradient", ""): g})
                grads[name].append(step_grads)
            modes = RENDER_TILE_MODES if case == "switches" else ("Shade",)
            frames[name] = {mode: tb.render_training_view(
                0, width=48, height=48, render_mode=mode) for mode in modes}
            samples = tb.measured_batch_size
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"])]
        print(f"card vs CPU [{case}], 2 train steps of a small network "
              f"({samples} samples a step): losses {losses['card']} vs "
              f"{losses['cpu']} (relative difference {max(rel):.3g})",
              flush=True)
        if max(rel) > CPU_LOSS_REL:
            raise RuntimeError("training on the card disagrees with the CPU")
        for mode, on_cpu in frames["cpu"].items():
            err = np.abs(frames["card"][mode] - on_cpu)
            print(f"card vs CPU [{case}]: 48x48 {mode} frame max abs "
                  f"{err.max():.3g}, mean abs {err.mean():.3g}", flush=True)
            if not (err.max() <= FRAME_MAX_ABS
                    and err.mean() <= FRAME_MEAN_ABS):
                raise RuntimeError(f"the card's {mode} frame disagrees with "
                                   f"the CPU's")
            if on_cpu[..., 3].max() <= 0.0:
                raise RuntimeError("the small frame evaluated no samples")
        for step, (on_card, on_cpu) in enumerate(zip(grads["card"],
                                                     grads["cpu"])):
            worst = {}
            for k, ref in on_cpu.items():
                top = ref.abs().max().item()
                if top <= 0.0:
                    raise RuntimeError(f"the {k} gradient is zero")
                worst[k] = (on_card[k].cpu() - ref).abs().max().item() / top
            if not worst:
                continue
            print(f"card vs CPU [{case}], step {step + 1}: gradients' "
                  f"largest difference over their largest entry: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()),
                  flush=True)
            if max(worst.values()) > CPU_CAM_GRAD_REL[step]:
                raise RuntimeError(f"the {case} gradients on the card "
                                   f"disagree with the CPU's")


def train_aabb4(ds, cfg, dev, smi):
    """Phase 6 at aabb_scale 4: the scene with three occupancy cascades and
    the cone-angle step, AABB4_STEPS steps with the testbed's defaults; in
    the last AABB4_COUNTED the march's emitted samples are counted by
    cascade."""
    import copy

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.nerf import training
    from instant_ngp_tpu_torch.nerf.march import mip_from_dt
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    ds4 = copy.copy(ds)
    ds4.aabb_scale = 4
    tb = NerfTestbed(ds4, cfg, device=dev, compute_dtype=torch.bfloat16,
                     seed=SEED)
    scene = tb.scene
    if not (scene.max_cascade == 2 and scene.cone_angle_constant > 0):
        raise RuntimeError(f"aabb_scale 4 gave max_cascade "
                           f"{scene.max_cascade}, cone angle "
                           f"{scene.cone_angle_constant}")
    first_loss = tb.train(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb.train(AABB4_STEPS - AABB4_COUNTED - 1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n_cascades = scene.max_cascade + 1
    by_mip = torch.zeros(n_cascades, dtype=torch.int64, device=dev)
    march = training.march_rays

    def counting_march(rays, bitfield, aabb_min, aabb_max, cone_angle,
                       max_mip, *args):
        ts, dts, emit = march(rays, bitfield, aabb_min, aabb_max,
                              cone_angle, max_mip, *args)
        pos = rays.origins[:, None, :] + ts[..., None] * rays.dirs[:, None]
        mip = mip_from_dt(dts, pos, max_mip).clamp(0, max_mip)[emit]
        by_mip.add_(torch.bincount(mip, minlength=n_cascades))
        return ts, dts, emit

    training.march_rays = counting_march
    try:
        last_loss = tb.train(AABB4_COUNTED)
    finally:
        training.march_rays = march
    bits = np.unpackbits(tb.bitfield.cpu().numpy()).reshape(-1, 128 ** 3) \
        .sum(axis=1)[:n_cascades].tolist()
    by_mip = by_mip.tolist()
    n_timed = AABB4_STEPS - AABB4_COUNTED - 1
    print(f"train[aabb_scale 4]: max_cascade {scene.max_cascade}, cone angle "
          f"{scene.cone_angle_constant:.5f}, n_march {tb.n_march}; steps "
          f"2-{n_timed + 1} in {sec:.3f} s: {n_timed / sec:.2f} steps/s "
          f"[{smi}]; loss {first_loss:.6f} -> {last_loss:.6f} at step "
          f"{tb.training_step}; occupied bits by cascade {bits}; samples "
          f"emitted by cascade over the last {AABB4_COUNTED} steps "
          f"{by_mip}", flush=True)
    if not last_loss < first_loss:
        raise RuntimeError("the aabb_scale 4 run's loss did not fall")
    if sum(by_mip[1:]) == 0:
        raise RuntimeError("the march emitted no sample in a cascade above "
                           "0 at aabb_scale 4")


def procedural_image(side, seed):
    """A linear RGB image (side, side, 3) float32: smooth gradients, a zone
    plate in one quadrant, hard-edged rectangles and stripes in another,
    seeded discs of flat colour on top."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v, u = (np.mgrid[0:side, 0:side].astype(np.float32) + 0.5) / side
    img = np.empty((side, side, 3), np.float32)
    img[..., 0] = 0.15 + 0.7 * u
    img[..., 1] = 0.15 + 0.7 * v
    img[..., 2] = 0.5 + 0.35 * np.sin(3.0 * u + 2.0 * v)
    # zone plate in the upper right quadrant: frequency rising outwards
    r2 = (u - 0.75) ** 2 + (v - 0.25) ** 2
    zone = (r2 < 0.22 ** 2)
    img[zone] = (0.5 + 0.45 * np.cos(np.float32(side) * 2.0 * r2[zone])
                 )[:, None]
    # edges in the lower left quadrant: rectangles and thin stripes
    low_left = (u < 0.5) & (v > 0.5)
    for _ in range(40):
        x0, y0 = rng.uniform(0.0, 0.45), rng.uniform(0.5, 0.95)
        w, h = rng.uniform(0.01, 0.1, 2)
        box = low_left & (u >= x0) & (u < x0 + w) & (v >= y0) & (v < y0 + h)
        img[box] = rng.uniform(0.0, 1.0, 3).astype(np.float32)
    stripes = (u > 0.5) & (v > 0.5) & ((np.floor(u * side / 6) % 2) == 0)
    img[stripes] *= 0.3
    for _ in range(12):
        cx, cy, rad = rng.uniform(0.05, 0.95), rng.uniform(0.05, 0.95), \
            rng.uniform(0.01, 0.05)
        disc = (u - cx) ** 2 + (v - cy) ** 2 < rad ** 2
        img[disc] = rng.uniform(0.0, 1.2, 3).astype(np.float32)
    return img


def image_mode(cfg, dev, smi, fused_mlp_forward, variant, profile):
    """Phase 10 -> (kernel launches by the renders, by variant; a row of the
    kernel table for the Image path). With `profile`, 16 more steps of each
    encode under torch.profiler at the end."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.image.testbed_image import ImageTestbed

    t0 = time.perf_counter()
    img = procedural_image(IMAGE_SIDE, SEED)
    make_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    tb = ImageTestbed(img, cfg, seed=SEED, device=dev)
    enc = tb.model.encoding
    widths = [w.shape[0] for w in tb.model.network.weights] + [3]
    if not (enc.n_dims == 2 and enc.n_levels == 16
            and enc.n_features_per_level == 2
            and widths == [32, 64, 64, 3] and tb.random_mode == "Stratified"
            and tb.stochastic_corners_until == IMAGE_STEPS // 2):
        raise RuntimeError(f"the Image testbed is not base.json's "
                           f"(widths {widths})")
    hashed = sum(lvl[4] for lvl in enc.levels)
    print(f"image: {IMAGE_SIDE}x{IMAGE_SIDE} procedural image made in "
          f"{make_s:.1f} s; grid {enc.n_levels} levels ({hashed} hashed), "
          f"{enc.n_entries} entries x 2 features ({4 * enc.n_params / 1e6:.1f}"
          f" MB), finest scale {enc.levels[-1][0]:.1f}; MLP {widths}; "
          f"{sum(p.numel() for p in tb.model.parameters())} parameters",
          flush=True)

    counts = {"train": 0, "render": 0}
    tb.train = counting_launches(fused_mlp_forward, counts, "train",
                                 tb.train)
    tb.compute_mse = counting_launches(fused_mlp_forward, counts, "render",
                                       tb.compute_mse)
    tb.render = counting_launches(fused_mlp_forward, counts, "render",
                                  tb.render)
    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    psnr = [tb.psnr()]
    first_loss = tb.train(1, IMAGE_BATCH)
    rates, losses = [], [first_loss]
    for n in (IMAGE_STEPS // 2 - 1, IMAGE_STEPS // 2):
        stochastic = tb._stoch_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tb.train(n, IMAGE_BATCH))
        torch.cuda.synchronize()
        rates.append((stochastic, n / (time.perf_counter() - t0)))
        psnr.append(tb.psnr())
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for (stochastic, rate), step in zip(rates, (IMAGE_STEPS // 2,
                                                IMAGE_STEPS)):
        print(f"image: {'stochastic' if stochastic else 'exact'} encode, "
              f"steps to {step}: {rate:.2f} steps/s, "
              f"{rate * IMAGE_BATCH:.4g} samples/s at batch {IMAGE_BATCH} "
              f"[{smi}]")
    print(f"image: loss {losses[0]:.6f} at step 1 -> {losses[1]:.6f} at "
          f"step {IMAGE_STEPS // 2} -> {losses[2]:.6f} at step "
          f"{IMAGE_STEPS}; PSNR {psnr[0]:.2f} / {psnr[1]:.2f} / "
          f"{psnr[2]:.2f} dB at steps 0 / {IMAGE_STEPS // 2} / "
          f"{IMAGE_STEPS}; peak {peak_gib:.2f} GiB allocated ({held_gib:.2f} "
          f"GiB of it held by the earlier phases)", flush=True)

    frame_launches = fused_mlp_forward.launches
    times = []
    for _ in range(2):        # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = tb.render(IMAGE_SIDE, IMAGE_SIDE)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    frame_launches = (fused_mlp_forward.launches - frame_launches) // 2
    by_variant = dict(fused_mlp_forward.launches_by_variant)
    del tb.train, tb.compute_mse, tb.render
    print(f"image: frame {IMAGE_SIDE}x{IMAGE_SIDE} (host clock, to a numpy "
          f"array): {1e3 * times[0]:.1f} ms cold, {1e3 * times[1]:.1f} ms "
          f"warm, {frame_launches} kernel launches of "
          f"{tb.render_chunk} rows; launches over the phase: "
          f"{counts['train']} by train steps, {counts['render']} by renders "
          f"and compute_mse, by variant {by_variant} [{smi}]", flush=True)
    if not losses[-1] < losses[0]:
        raise RuntimeError("the Image training loss did not fall")
    if not (psnr[-1] > psnr[0] and psnr[-1] >= IMAGE_MIN_PSNR):
        raise RuntimeError(f"Image PSNR {psnr[-1]:.2f} dB after "
                           f"{IMAGE_STEPS} steps (from {psnr[0]:.2f}; at "
                           f"least {IMAGE_MIN_PSNR} asked)")
    if frame.shape != (IMAGE_SIDE, IMAGE_SIDE, 4) \
            or not np.isfinite(frame).all():
        raise RuntimeError("the Image frame is not finite or of the wrong "
                           "shape")
    if counts["train"] != 0 or counts["render"] == 0 \
            or set(by_variant) != {variant}:
        raise RuntimeError(f"the Image path must launch the kernel from its "
                           f"renders alone, on {variant}: {counts}, "
                           f"{by_variant}")
    if profile:
        profile_image_steps(tb, smi)
    return by_variant, {"frame_ms_warm": 1e3 * times[1],
                        "launches_per_frame": frame_launches,
                        "rows_per_frame": IMAGE_SIDE * IMAGE_SIDE,
                        "psnr_db": psnr, "steps_per_s": [r for _, r in rates],
                        "peak_gib": peak_gib}


def profile_image_steps(tb, smi):
    """--profile: 16 Image train steps with each encode under
    torch.profiler: wall time, the device's busy share, launches a step and
    the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n_steps = 16
    for stochastic in (True, False):
        tb.stochastic_corners = stochastic
        tb.stochastic_corners_until = None
        tb.train(1, IMAGE_BATCH)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tb.train(n_steps, IMAGE_BATCH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _, kernels, self_device_us = profiler_kernels(prof)
        busy = sum(self_device_us(e) for e in kernels) / 1e6
        print(f"profile: {n_steps} Image train steps, "
              f"{'stochastic' if stochastic else 'exact'} encode: "
              f"{1e3 * wall / n_steps:.2f} ms a step wall, device busy "
              f"{100 * busy / wall:.1f} %, "
              f"{sum(e.count for e in kernels) / n_steps:.0f} kernel launches "
              f"a step [{smi}]")
        for e in sorted(kernels, key=self_device_us, reverse=True)[:6]:
            us = self_device_us(e)
            print(f"  {e.key[:60]}: {us / 1e3 / n_steps:.3f} ms a step "
                  f"({100 * us / 1e6 / busy:.1f} % of device time)")


def image_card_against_cpu(cfg, dev):
    """Phase 10's check: 2 train steps of a small image net (the first with
    the stochastic encode, the second exact) on the card and on the CPU
    from the same draws; the losses and a 64x64 frame must agree."""
    import copy

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.image.testbed_image import ImageTestbed
    from instant_ngp_tpu_torch.ops.grid_encoding import (CornerDraws,
                                                         draw_corner_randoms)

    small = copy.deepcopy(cfg)
    small["encoding"].update(n_levels=4, log2_hashmap_size=10,
                             stochastic_corners_until=1)
    img = procedural_image(64, SEED)
    losses, frames = {}, {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        gen = torch.Generator().manual_seed(SEED + 10)     # on the CPU

        def draws(step, n, device=device, gen=gen):
            u = torch.rand(n, 2, generator=gen)
            c = draw_corner_randoms(gen, n, 2, 4, 0)
            return u.to(device), CornerDraws(c.u.to(device), None)

        tb = ImageTestbed(img, small, seed=SEED, device=device, draws=draws)
        losses[name] = [tb.train(1, 1 << 12) for _ in range(2)]
        frames[name] = tb.render(64, 64)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"]))
    err = np.abs(frames["card"] - frames["cpu"])
    print(f"image card vs CPU, 2 train steps of a small net: losses "
          f"{losses['card']} vs {losses['cpu']} (relative difference "
          f"{rel:.3g}); 64x64 frame max abs {err.max():.3g}, mean abs "
          f"{err.mean():.3g}", flush=True)
    if rel > CPU_LOSS_REL or not (err.max() <= FRAME_MAX_ABS
                                  and err.mean() <= FRAME_MEAN_ABS):
        raise RuntimeError("Image training on the card disagrees with the "
                           "CPU")


def mesh_and_flip(tb, smi, fused_mlp_forward, variants):
    """Phase 11 on a trained testbed -> (the kernel's launches by variant
    while the mesh was extracted, the mesh's numbers)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.common import srgb_to_linear
    from instant_ngp_tpu_torch.geom.marching import load_mesh, save_mesh
    from instant_ngp_tpu_torch.metrics import compute_error, compute_error_img

    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verts, faces, colors = tb.compute_marching_cubes_mesh(MESH_RES)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    by_variant = dict(fused_mlp_forward.launches_by_variant)
    radius = np.linalg.norm(verts - 0.5, axis=-1)
    in_band = float((np.abs(radius - 0.22) <= MESH_RADIUS_BAND).mean()) \
        if len(verts) else 0.0
    pct = np.percentile(radius, [5, 50, 95, 100]).round(4).tolist() \
        if len(verts) else [0.0] * 4
    print(f"mesh: compute_marching_cubes_mesh({MESH_RES}) in {mesh_s:.2f} s: "
          f"{len(verts)} vertices, {len(faces)} faces; kernel launches by "
          f"variant {by_variant}; vertex radius about the box's centre "
          f"5/50/95/100 % {pct} (the sphere's 0.22), {100 * in_band:.1f} % "
          f"within {MESH_RADIUS_BAND} [{smi}]", flush=True)
    if len(faces) == 0 or in_band < MESH_IN_BAND \
            or abs(pct[2] - 0.22) > MESH_OUTER_TOL:
        raise RuntimeError(f"the mesh is empty or off the sphere "
                           f"({100 * in_band:.1f} % of its vertices within "
                           f"{MESH_RADIUS_BAND}, the 95th percentile of "
                           f"their radius {pct[2]})")
    if not (np.isfinite(colors).all() and colors.min() >= 0.0
            and colors.max() <= 1.0):
        raise RuntimeError("the mesh's colours are not finite or outside "
                           "[0, 1]")
    check_variants(by_variant, variants, "the mesh path")

    def off_threshold(v):
        return float(np.abs(tb._density_and_input_grad(v)[0] - 2.5).mean())

    before = off_threshold(verts)
    launches = fused_mlp_forward.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moved = tb.optimise_mesh_step(verts, faces, n_steps=4)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    opt_launches = fused_mlp_forward.launches - launches
    after = off_threshold(moved)
    print(f"mesh: 4 optimise_mesh_steps in {opt_s:.2f} s, {opt_launches} "
          f"kernel launches; mean |raw density - 2.5| at the vertices "
          f"{before:.4f} -> {after:.4f}; largest move "
          f"{np.abs(moved - verts).max():.3g} [{smi}]", flush=True)
    if opt_launches != 0 or not after <= before:
        raise RuntimeError("optimise_mesh_step launched the kernel or moved "
                           "the vertices away from the threshold")

    root = tempfile.mkdtemp(prefix="mesh_")
    try:
        sizes = {}
        for suffix in ("ply", "obj"):
            path = os.path.join(root, f"mesh.{suffix}")
            save_mesh(path, verts, faces, colors)
            sizes[suffix] = os.path.getsize(path)
            v, f, c = load_mesh(path)
            if not (np.array_equal(f, faces) and np.allclose(
                    v, verts, rtol=1e-6, atol=1e-7) and np.abs(
                    c - colors).max() <= 1.0 / 255 + 1e-6):
                raise RuntimeError(f"the {suffix} mesh did not read back")
    finally:
        shutil.rmtree(root)
    render = tb.render_training_view(0)
    gt = tb._gt_srgb(0, render.shape[1], render.shape[0], 1)
    flip_map = compute_error_img("FLIP", srgb_to_linear(
        np.clip(render[..., :3], 0, 1)), srgb_to_linear(gt))
    flip = compute_error("FLIP", srgb_to_linear(
        np.clip(render[..., :3], 0, 1)), srgb_to_linear(gt))
    print(f"mesh: written as PLY ({sizes['ply']} bytes) and OBJ "
          f"({sizes['obj']} bytes) and read back; FLIP of view 0 against "
          f"its image: mean {flip:.4f}, max {flip_map.max():.4f}",
          flush=True)
    if not (np.isfinite(flip_map).all() and flip_map.min() >= 0.0
            and flip_map.max() <= 1.0):
        raise RuntimeError("FLIP of view 0 is not finite or outside [0, 1]")
    return by_variant, {"vertices": len(verts), "faces": len(faces),
                        "seconds": mesh_s, "in_band": in_band,
                        "flip_mean": flip}


def pose_recovery(cfg, dev, smi, interval):
    """Phase 8: training cameras moved by a seeded N(0, POSE_NOISE)
    translation and turned by an N(0, POSE_ROT_NOISE) rotation vector;
    POSE_STEPS steps with `optimize_extrinsics`: the mean distance and
    angle of the cameras to the true ones before and after."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    from instant_ngp_tpu_torch.ops.host_adam import rotvec_to_matrix

    ds = make_scene(size=POSE_SIZE)
    true_pos = ds.xforms_start[:, :3, 3].copy()
    true_rot = ds.xforms_start[:, :3, :3].copy()
    rng = np.random.default_rng(SEED + 8)
    shift = rng.normal(0.0, POSE_NOISE, true_pos.shape).astype(np.float32)
    turn = rng.normal(0.0, POSE_ROT_NOISE, true_pos.shape)
    ds.xforms_start = ds.xforms_start.copy()
    ds.xforms_start[:, :3, 3] += shift
    for i, r in enumerate(turn):
        ds.xforms_start[i, :3, :3] = rotvec_to_matrix(r) @ true_rot[i]
    ds.xforms_end = ds.xforms_start.copy()
    tb = NerfTestbed(ds, cfg, device=dev, compute_dtype=torch.bfloat16,
                     seed=SEED)
    tb.optimize_extrinsics = True
    tb.cam_grad_interval = interval

    def pose_error():
        """(mean distance, mean angle in degrees) of the cameras to the
        true ones."""
        xf = np.stack([tb.effective_xform(i) for i in range(ds.n_images)])
        dist = np.linalg.norm(xf[:, :, 3] - true_pos, axis=-1).mean()
        rel = np.einsum("nij,nkj->nik", xf[:, :, :3], true_rot)
        cos = (np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0
        return float(dist), float(np.degrees(
            np.arccos(np.clip(cos, -1.0, 1.0))).mean())

    before = pose_error()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb.train(POSE_STEPS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    after = pose_error()
    updates = POSE_STEPS // tb.n_steps_between_cam_updates
    print(f"pose recovery: {ds.n_images} cameras of {POSE_SIZE}x{POSE_SIZE} "
          f"moved by N(0, {POSE_NOISE}) and turned by N(0, "
          f"{POSE_ROT_NOISE}) rad; {POSE_STEPS} steps with "
          f"optimize_extrinsics, camera gradient on one step per "
          f"{tb._cam_grad_interval_eff()}, in {sec:.2f} s: mean distance "
          f"to the true cameras {before[0]:.5f} -> {after[0]:.5f}, mean "
          f"angle {before[1]:.4f} -> {after[1]:.4f} degrees; largest "
          f"offsets {np.abs(tb.cam_pos_offset).max():.5f}, "
          f"{np.abs(tb.cam_rot_offset).max():.5f} rad; PSNR of view 0 "
          f"{tb.eval_psnr(0):.2f} dB; host reads {tb.host_syncs} [{smi}]",
          flush=True)
    if tb.host_syncs != {"camera_updates": updates,
                         "error_cdfs": POSE_STEPS // 128}:
        raise RuntimeError(f"the host-side updates read the device "
                           f"{tb.host_syncs}, not once per 16 and per 128 "
                           f"steps")
    if not after[0] < before[0]:
        raise RuntimeError("the cameras' distance did not fall")


def profile_training(tb, smi, out_path):
    """CUDA-event spans of one warm train step and of one density update,
    then 16 steps under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from instant_ngp_tpu_torch.nerf import training

    spans = EventSpans()
    model, enc = tb.model, tb.model.pos_encoding
    patches = [
        (training, "generate_rays", "rays + march + compaction"),
        (training, "march_rays", "rays + march + compaction"),
        (training, "compact_samples", "rays + march + compaction"),
        (training, "build_rays", "rays rebuilt under autograd"),
        (enc, "forward", "encode forward"),
        (model.density_net, "forward", "MLP forward (density + RGB)"),
        (model.rgb_net, "forward", "MLP forward (density + RGB)"),
        (model.dir_encoding, "forward", "SH direction encode"),
        (training, "composite_loss", "composite + loss"),
        (torch.autograd, "grad", "backward"),
        (enc, "_table_gradient", "  of which the encode's backward"),
        (enc, "_table_gradient_stochastic",
         "  of which the encode's backward"),
        (tb.optimizer, "step", "optimizer + EMA"),
    ]
    saved = [(obj, attr, obj.__dict__.get(attr)) for obj, attr, _ in patches]
    for obj, attr, name in patches:
        setattr(obj, attr, spans.wrap(name, getattr(obj, attr)))
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tb.train_step()
        end.record()
        end.synchronize()
    finally:
        for obj, attr, old in saved:
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
    step_ms = start.elapsed_time(end)
    print(f"profile: warm train step, stochastic corners "
          f"{tb._stoch_now()}: {step_ms:.2f} ms on the device's "
          f"clock, {tb.rays_per_batch} rays x {tb.n_march} candidates, "
          f"{tb.measured_batch_size} samples at the last sync [{smi}]")
    rest = step_ms
    for name in dict.fromkeys(n for _, _, n in patches):
        ms = spans.ms(name)
        if not name.startswith(" "):
            rest -= ms
        print(f"  {name}: {ms:.2f} ms ({100 * ms / step_ms:.1f} %)")
    print(f"  the rest (background, exposure, error map, stats): "
          f"{rest:.2f} ms "
          f"({100 * rest / step_ms:.1f} %)")

    for name, fn in (("1/4 + 1/4", tb.training_prep),
                     ("full sweep", tb.update_density_grid_full)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        print(f"profile: density update, {name}: "
              f"{start.elapsed_time(end):.1f} ms [{smi}]")

    n_steps = 16
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tb.train_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, kernels, self_device_us = profiler_kernels(prof)
    busy = sum(self_device_us(e) for e in kernels) / 1e6
    print(f"profile: {n_steps} traced train steps {wall:.3f} s wall "
          f"({1e3 * wall / n_steps:.1f} ms a step), device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f} %), "
          f"{sum(e.count for e in kernels) / n_steps:.0f} kernel launches a "
          f"step [{smi}]")
    for e in sorted(kernels, key=self_device_us, reverse=True)[:10]:
        us = self_device_us(e)
        print(f"  {e.key[:60]}: {us / 1e3 / n_steps:.3f} ms a step "
              f"({100 * us / 1e6 / busy:.1f} % of device time), "
              f"{e.count // n_steps} calls a step")
    with open(out_path, "a") as f:
        f.write(f"\n{n_steps} train steps\n")
        f.write(rows.table(sort_by="self_cuda_time_total", row_limit=40))


def trained_scale_params(model, seed):
    """The model's seeded MLP weights, with the hash table drawn from
    U(-1, 1). tcnn's U(-1e-4, 1e-4) init gives density outputs of ~1e-4
    and a density of ~1 everywhere, which would hide a wrong kernel."""
    import numpy as np

    table = np.random.default_rng(seed).uniform(
        -1.0, 1.0, model.pos_encoding.params.numel()).astype(np.float32)
    return {"pos_encoding": table,
            "density_net": [w.detach().cpu().numpy()
                            for w in model.density_net.weights],
            "dir_encoding": {},
            "rgb_net": [w.detach().cpu().numpy()
                        for w in model.rgb_net.weights]}


def cuda_ms(fn, reps=5, inner=10):
    """Median over `reps` of the mean device time of `inner` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def mlp_bound_ms(rows, dims, x_bytes_per_value):
    """(least ms, "bytes" or "operations"): x and the bf16 weights read
    once and the float32 output written once at the card's memory rate,
    against 2 * rows * fan_in * fan_out operations per layer at its bf16
    tensor-core rate."""
    n_weights = sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    moved = rows * (dims[0] * x_bytes_per_value + dims[-1] * 4) + 2 * n_weights
    by_bytes = 1e3 * moved / HBM_BYTES_PER_S
    by_ops = 1e3 * 2 * rows * n_weights / BF16_FLOP_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_kernel(out, ref, what):
    """(max abs, mean abs) error of `out`, raising where it is outside the
    tolerance relative to the reference's scale."""
    import torch

    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    ref_max, ref_mean = ref.abs().max().item(), ref.abs().mean().item()
    if not (torch.isfinite(out).all() and out.shape == ref.shape
            and max_abs <= KERNEL_MAX_REL * ref_max
            and mean_abs <= KERNEL_MEAN_REL * ref_mean):
        raise RuntimeError(
            f"fused_mlp_forward disagrees with its plain version at {what}: "
            f"max abs {max_abs:.3g} mean abs {mean_abs:.3g} (ref max "
            f"{ref_max:.3g} mean {ref_mean:.3g})")
    return max_abs, mean_abs


class KernelPaths:
    """The grid kernels', the march kernel's and the RGB rows kernel's
    launches on each path of the run, counted from 0 over it
    (`grid_kernels.launch_counts`, `march_and_pack.launches` and
    `rgb_net_rows.launches` before and after)."""

    def __init__(self):
        self.by_path = {}

    @staticmethod
    def counts():
        from instant_ngp_tpu_torch.ops.kernels import grid_kernels
        from instant_ngp_tpu_torch.ops.kernels.march_kernels import \
            march_and_pack
        from instant_ngp_tpu_torch.ops.kernels.round_kernels import \
            rgb_net_rows

        return {**grid_kernels.launch_counts(),
                "march_and_pack": march_and_pack.launches,
                "rgb_net_rows": rgb_net_rows.launches}

    def run(self, path, fn, *args, **kwargs):
        before = self.counts()
        try:
            return fn(*args, **kwargs)
        finally:
            counts = self.by_path.setdefault(path, {})
            for key, n in self.counts().items():
                if n != before.get(key, 0):
                    counts[key] = counts.get(key, 0) + n - before.get(key, 0)
            print(f"grid, march and RGB rows kernel launches, {path}: "
                  f"{counts}", flush=True)

    def total(self, *keys):
        return sum(c.get(k, 0) for c in self.by_path.values() for k in keys)


def grid_case(enc_cfg, n_dims, n, dev, seed, padded=False):
    """A GridEncoding of `enc_cfg` on the card with a U(-1, 1) table, n
    points in [-0.05, 1.05]^d, the first on cell faces of every level (m /
    scale, and 0 and 1), grad_out ~ N(0, 1), and corner draws for every j
    -> (enc, x, grad_out, {j: draws}). `padded`: the last eighth of the
    points are a train step's padding, one position with a zero
    gradient."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.ops.grid_encoding import (GridEncoding,
                                                         draw_corner_randoms)

    enc = GridEncoding.from_config(n_dims, enc_cfg).to(dev)
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        enc.params.uniform_(-1.0, 1.0, generator=gen)
    x = torch.rand(n, n_dims, device=dev, generator=gen) * 1.1 - 0.05
    faces = [np.float32(m) / np.float32(s) for s, *_ in enc.levels
             for m in (1, 3, 7)] + [0.0, 1.0]
    k = min(n, len(faces))
    x[:k] = torch.tensor(faces[:k], dtype=torch.float32, device=dev)[:, None]
    g_out = torch.randn(n, enc.n_output_dims, device=dev, generator=gen)
    if padded:
        x[n - n // 8:] = 0.3
        g_out[n - n // 8:] = 0.0
    draws = {j: draw_corner_randoms(gen, n, n_dims, enc.n_levels, j)
             for j in range(n_dims)}
    return enc, x, g_out, draws


def grid_variants(enc, x, g_out, draws, max_level=None):
    """Every grid kernel's call and its plain version's on the same inputs:
    {(kernel name, variant): (kernel call, plain call)}."""
    p = enc.params.detach()
    calls = {("grid_encode_forward", "exact"): (
        lambda: enc._encode(p, x, max_level),
        lambda: enc._encode_plain(p, x, max_level)),
        ("grid_table_gradient", "exact"): (
        lambda: enc._table_gradient(x, g_out, max_level),
        lambda: enc._table_gradient_plain(x, g_out, max_level)),
        ("grid_input_gradient", "exact"): (
        lambda: enc._input_gradient(p, x, g_out, max_level),
        lambda: enc._input_gradient_plain(p, x, g_out, max_level))}

    def deposit(one, dr, j, plain):
        def call():
            enc.stochastic_bwd = one
            try:
                fn = enc._table_gradient_stochastic_plain if plain \
                    else enc._table_gradient_stochastic
                return fn(x, g_out, max_level, dr, j)
            finally:
                enc.stochastic_bwd = False
        return call

    for j, dr in draws.items():
        calls[("grid_encode_forward[stochastic]", f"j{j}")] = (
            lambda dr=dr, j=j: enc._encode_stochastic(p, x, max_level, dr, j),
            lambda dr=dr, j=j: enc._encode_stochastic_plain(p, x, max_level,
                                                            dr, j))
        for one in ((False, True) if j else (True,)):
            name = f"j{j} {'one corner' if one else 'fetched'}"
            calls[("grid_table_gradient[stochastic]", name)] = (
                deposit(one, dr, j, False), deposit(one, dr, j, True))
    return calls


def check_grid_call(kernel, plain, name, variant, what):
    """Kernel against plain version (and the gradients against a second run
    of the kernel) -> (max abs error, the same bits as the plain version,
    the plain version's largest magnitude)."""
    import torch

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"{name} [{variant}] at {what}: shape "
                           f"{tuple(out.shape)} / {tuple(ref.shape)} or "
                           f"not finite")
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    same = torch.equal(out, ref)
    scale = ref.abs().max().item() if ref.numel() else 0.0
    if name.startswith("grid_encode_forward"):
        ok = err <= GRID_MAX_ABS
    elif name == "grid_input_gradient":
        ok = err <= GRID_INPUT_REL * scale
    else:
        ok = err <= GRID_DEPOSIT_REL * scale
    if name != "grid_encode_forward" and not torch.equal(out, kernel()):
        raise RuntimeError(f"{name} [{variant}] at {what} does not repeat "
                           f"bit for bit")
    if not ok:
        raise RuntimeError(f"{name} [{variant}] disagrees with its plain "
                           f"version at {what}: max abs {err:.3g} (reference "
                           f"max {scale:.3g})")
    return err, same, scale


def kernel_times(fn, reps=3):
    """{CUDA kernel name: device ms a call} of `fn` under torch.profiler,
    means over `reps` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    _, kernels, self_us = profiler_kernels(prof)
    return {e.key[:60]: self_us(e) / 1e3 / reps for e in kernels}


def deposit_rows_and_values(enc, x, g_out, draws, one_corner):
    """Every deposit of the exact (or the one-corner stochastic) table
    gradient as (rows (K,) int64, values (K, F)), levels in turn: the
    input of one `index_put_(..., accumulate=True)` call."""
    import torch

    f = enc.n_features_per_level
    rows, values = [], []
    for lvl in range(enc.n_levels):
        g = g_out[:, lvl * f:(lvl + 1) * f]
        if one_corner:
            idx, _ = enc._stochastic_corners(x, lvl, draws[1], 1,
                                             sampled_only=True)[0]
            rows.append(idx)
            values.append(g)
        else:
            idx, weight = enc._level_corners(x, lvl)
            rows.append(idx.reshape(-1))
            values.append((g[:, None, :] * weight[..., None]).reshape(-1, f))
    return torch.cat(rows), torch.cat(values)


def grid_kernels_on_card(dev, smi):
    """Phase 3b: the grid encode's kernels against their plain versions
    (the `_*_plain` methods of GridEncoding, on the same CUDA tensors):
    every configuration's grid (configs/nerf/base.json's and GRID_CONFIGS)
    at GRID_SMALL points, the last eighth padding, with and without
    max_level, then base.json's at
    GRID_POINTS on a U(-1, 1) table, where each kernel and its plain
    version are timed with CUDA events beside the bytes bound and the bytes
    the gathers read -> {kernel name: its row of the result line}."""
    import torch

    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)

    t0 = time.perf_counter()
    rows = {}

    def record(key, err, same, scale):
        row = rows.setdefault(key[0], {"max_abs_err": 0.0,
                                       "ref_max_abs": 0.0,
                                       "bit_equal_to_plain": {}})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ref_max_abs"] = max(row["ref_max_abs"], scale)
        row["bit_equal_to_plain"][key[1]] = \
            row["bit_equal_to_plain"].get(key[1], True) and same

    configs = [("nerf_base", "nerf", "base")] + list(GRID_CONFIGS)
    for i, (name, mode, cfg_name) in enumerate(configs):
        enc_cfg = load_network_config(find_network_config(cfg_name, mode))[
            "encoding"]
        n_dims = 2 if mode == "image" else 3
        for n in GRID_SMALL:
            enc, x, g_out, draws = grid_case(enc_cfg, n_dims, n, dev,
                                             SEED + 10 * i + n, padded=True)
            for max_level in (None, 1.5):
                for key, (kernel, plain) in grid_variants(
                        enc, x, g_out, draws, max_level).items():
                    record(key, *check_grid_call(
                        kernel, plain, *key,
                        f"{name} x {n}, max_level {max_level}"))
            del enc, x, g_out, draws
        torch.cuda.empty_cache()
    print(f"grid kernels at {GRID_SMALL} points of "
          f"{[c[0] for c in configs]}, with and without max_level: ok "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    enc_cfg = load_network_config(find_network_config("base", "nerf"))[
        "encoding"]
    n = GRID_POINTS
    enc, x, g_out, draws = grid_case(enc_cfg, 3, n, dev, SEED + 7)
    f, n_levels, corners = enc.n_features_per_level, enc.n_levels, 8
    table_bytes = 4 * enc.n_params
    x_bytes, out_bytes = 4 * 3 * n, 4 * n * n_levels * f
    u_bytes, axis_bytes = 4 * 3 * n * n_levels, 8 * n * n_levels
    # the bytes each call must move (each input read once, each output
    # written once) and the bytes its gathers read
    moved = {("grid_encode_forward", "exact"):
             x_bytes + table_bytes + out_bytes,
             ("grid_encode_forward[stochastic]", "j1"):
             x_bytes + u_bytes + axis_bytes + table_bytes + out_bytes,
             ("grid_table_gradient", "exact"):
             x_bytes + out_bytes + table_bytes,
             ("grid_table_gradient[stochastic]", "j1 one corner"):
             x_bytes + u_bytes + out_bytes + table_bytes,
             ("grid_input_gradient", "exact"):
             x_bytes + table_bytes + out_bytes + x_bytes}
    gathered = {("grid_encode_forward", "exact"):
                4 * f * n * n_levels * corners,
                ("grid_encode_forward[stochastic]", "j1"):
                4 * f * n * n_levels * 2,
                ("grid_table_gradient", "exact"): 0,
                ("grid_table_gradient[stochastic]", "j1 one corner"): 0,
                ("grid_input_gradient", "exact"):
                4 * f * n * n_levels * corners}
    calls = grid_variants(enc, x, g_out, draws)
    for key, (kernel, plain) in calls.items():
        record(key, *check_grid_call(kernel, plain, *key,
                                     f"nerf_base x {n}"))
        if key not in moved:
            continue
        # in turns: kernel, plain, kernel
        ms = [cuda_ms(kernel)]
        plain_ms = cuda_ms(plain, reps=3, inner=2)
        ms.append(cuda_ms(kernel))
        row = rows[key[0]]
        bound_ms = 1e3 * moved[key] / HBM_BYTES_PER_S
        row.update(variant=key[1], points=n, ms=min(ms), plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by="bytes",
                   bytes_moved=moved[key], bytes_gathered=gathered[key],
                   share_of_bound=bound_ms / min(ms))
        print(f"grid kernel {key[0]} [{key[1]}] x {n} (base.json: L="
              f"{n_levels}, F={f}, {enc.n_entries} rows): kernel "
              f"{min(ms):.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms (bytes: {moved[key] / 1e6:.1f} MB moved; "
              f"{100 * bound_ms / min(ms):.1f} % reached), "
              f"{gathered[key] / 1e6:.1f} MB gathered; bit-equal to plain: "
              f"{row['bit_equal_to_plain'][key[1]]} [{smi}]", flush=True)
        if key[0].startswith("grid_table_gradient"):
            # the deposit's parts (its kernels, by torch.profiler), and one
            # index_put_ call (the plain card path's library call) on the
            # same deposits' rows and values
            one = key[0] != "grid_table_gradient"
            row["kernel_ms"] = kernel_times(kernel)
            dep_rows, dep_values = deposit_rows_and_values(enc, x, g_out,
                                                           draws, one)
            table = torch.zeros(enc.n_entries, f, device=dev)
            row["library_ms"] = cuda_ms(lambda: table.index_put_(
                (dep_rows,), dep_values, accumulate=True), reps=3, inner=2)
            row["library_call"] = (f"index_put_(accumulate=True) of "
                                   f"{dep_rows.numel()} rows")
            del dep_rows, dep_values, table
            print(f"grid kernel {key[0]} [{key[1]}] x {n}: one "
                  f"{row['library_call']}: {row['library_ms']:.4f} ms; "
                  f"parts by kernel (torch.profiler, ms a call) "
                  f"{ {k: round(v, 4) for k, v in row['kernel_ms'].items()} }"
                  f" [{smi}]", flush=True)
    del enc, x, g_out, draws, calls
    torch.cuda.empty_cache()
    print(f"phase 3b (grid kernels): {time.perf_counter() - t0:.1f} s; "
          f"bit-equal to the plain versions: "
          f"{ {k: r['bit_equal_to_plain'] for k, r in rows.items()} }",
          flush=True)
    return rows


def march_visits(wr, origins, dirs, bitfield, step=1 << 14):
    """-> ((R,) int64: the candidates the march kernel visits on each ray:
    on a ray that meets the box, up to and including the first past the
    box's far face, its cap-th emission or the last; 0 on a ray that
    misses it, the visits to candidates inside the box), counted on the
    plain planes."""
    import torch

    from instant_ngp_tpu_torch.nerf.render import _march_start
    from instant_ngp_tpu_torch.nerf.sampler import RayBatch, march_rays

    cfg, lo, hi = wr.cfg, wr.aabb_min, wr.aabb_max
    k = torch.arange(cfg.n_march, device=origins.device)
    parts, n_inside = [], 0
    for i in range(0, origins.shape[0], step):
        o, d = origins[i:i + step], dirs[i:i + step]
        t_start, valid = _march_start(o, d, lo, hi, cfg.cone_angle)
        ts, _, emit = march_rays(RayBatch(o, d, t_start, valid), bitfield,
                                 lo, hi, cfg.cone_angle, cfg.max_mip,
                                 cfg.n_march, cfg.n_march)
        pos = o[:, None, :] + ts[..., None] * d[:, None, :]
        d = d[:, None, :]
        past = (((d <= 0) & (pos < lo)) | ((d >= 0) & (pos > hi))).any(-1)
        at_cap = emit & (torch.cumsum(emit, dim=1)
                         == cfg.max_samples_per_ray)
        last = torch.where(past | at_cap, k, cfg.n_march - 1).amin(dim=1)
        parts.append(torch.where(valid, last + 1, 0))
        inside = ((pos >= lo) & (pos <= hi)).all(-1) & (k <= last[:, None])
        n_inside += int(inside[valid].sum())
    return torch.cat(parts), n_inside


def sass_loop_paths(lib_path, kernel="march_and_pack"):
    """The longest loop of `kernel` in the built library's SASS (cuobjdump
    -sass), from its head to its backward branch -> ({"static": its
    instructions, "through_load": the fewest an iteration that reaches the
    loop's one global load (LDG) executes, "shortest": the fewest an
    iteration or its exit from the loop executes}, the loop's SASS), or
    (None, why not). A call's out-of-line body is not counted: the paths
    are lower bounds of what a visit issues."""
    import re
    import shutil
    from collections import deque

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None, "no cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", out)[1:]
             if kernel in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        return None, f"{len(funcs)} SASS functions named {kernel}"
    # a branch names its target by a label (`(.L_x_3)) or by an address
    instrs, at = [], {}
    for line in funcs[0].splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            at[label.group(1)] = len(instrs)
            continue
        instr = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if instr:
            at[int(instr.group(1), 16)] = len(instrs)
            instrs.append(instr.group(2))

    def target(text):
        branch = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if branch is None:
            return None
        t = branch.group(1)
        return at.get(t if t.startswith(".") else int(t, 16), -1)

    loops = [(i - target(x) + 1, target(x), i) for i, x in enumerate(instrs)
             if target(x) is not None and 0 <= target(x) <= i]
    if not loops:
        return None, f"no backward branch in {kernel}'s SASS"
    n, head, tail = max(loops)
    body = instrs[head:tail + 1]
    loads = [i for i, x in enumerate(body)
             if re.match(r"(@!?U?P\w+\s+)?LDG\b", x)]
    if len(loads) != 1:
        return None, f"{len(loads)} global loads in {kernel}'s loop"

    # the loop's control flow: an index past the body is an exit, and the
    # back branch's edge to the head ends the iteration (index n)
    def succ(i):
        if i == n - 1:
            return [n] + ([i + 1] if body[i].startswith("@") else [])
        if re.match(r"(@!?U?P\w+\s+)?(EXIT|RET)\b", body[i]):
            return [n + 1]
        t = target(body[i])
        if t is None:
            return [i + 1]
        t = t - head if head <= t <= tail else n + 1
        return [t] + ([i + 1] if body[i].startswith("@") else [])

    def fewest(src):
        dist, todo = {src: 1}, deque([src])
        while todo:
            i = todo.popleft()
            for j in succ(i):
                if j not in dist:
                    dist[j] = dist[i] + (j < n)
                    if j < n:
                        todo.append(j)
        return dist

    from_head, from_load = fewest(0), fewest(loads[0])
    paths = {"static": n,
             "through_load": from_head[loads[0]] + from_load[n] - 1,
             "shortest": min(d for j, d in from_head.items() if j >= n)}
    return paths, "\n".join(body)


def march_kernel_on_card(dev, smi, size=800, focal=880.0, tile=1 << 19):
    """Phase 3c (and --march-only): the wavefront renderer's march-and-pack
    kernel against its plain version at the render benchmark's tile (the
    first 2^19 rays of an 800x800 frame from its orbit, focal 1.1 x 800,
    n_march 1024, 512 kept, the shell's bitfield, cone 0): the same bits
    over the columns the rounds read, device times in turns (kernel, plain,
    kernel), the bytes bound and the instruction-issue bound of the
    candidates visited -> its row of the result line."""
    import torch

    from instant_ngp_tpu_torch.nerf.occupancy import shell_bitfield
    from instant_ngp_tpu_torch.nerf.render import (RenderConfig,
                                                   WavefrontRenderer,
                                                   camera_rays_for_frame)
    from instant_ngp_tpu_torch.ops.kernels import _build
    from instant_ngp_tpu_torch.ops.kernels.march_kernels import \
        march_and_pack

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = RenderConfig(n_march=1024, max_samples_per_ray=512,
                       cone_angle=0.0, max_mip=0, rgb_activation="Logistic",
                       density_activation="Exponential")
    lo = torch.zeros(3, device=dev)
    wr = WavefrontRenderer(None, cfg, lo, lo + 1.0)
    origins, dirs = camera_rays_for_frame(
        size, size, [focal, focal], orbit_camera(0.3, 0.4), device=dev)
    origins = origins[:tile].contiguous()
    dirs = dirs[:tile].contiguous()
    bitfield = shell_bitfield(dev)

    def kernel():
        return wr._march_and_pack(origins, dirs, bitfield)

    def plain():
        return wr._march_and_pack_plain(origins, dirs, bitfield)

    before = march_and_pack.launches
    ts, ok, n_cand, valid = kernel()
    p_ts, p_ok, p_n, p_valid = plain()
    if march_and_pack.launches != before + 1:
        raise SystemExit("march: the kernel was not launched")
    rounds = (p_n + wr.chunk - 1) // wr.chunk * wr.chunk
    read = torch.arange(wr._c_pad, device=dev)[None, :] < rounds[:, None]
    same = (torch.equal(valid, p_valid) and torch.equal(n_cand, p_n)
            and torch.equal(ok[read], p_ok[read])
            and torch.equal(ts[read].view(torch.int32),
                            p_ts[read].view(torch.int32)))
    if not same:
        raise SystemExit(f"march: the kernel's rows differ from the plain "
                         f"rows: n_cand {int((n_cand != p_n).sum())} rays, "
                         f"ts {int((ts != p_ts)[read].sum())} columns")
    del ts, ok, n_cand, valid, p_ts, p_ok, read
    ms = [cuda_ms(kernel)]
    plain_ms = cuda_ms(plain, reps=3, inner=1)
    ms.append(cuda_ms(kernel))
    # rays read once; each row written to its last round, with n_cand and
    # valid
    moved = tile * 24 + 5 * int(rounds.sum()) + 9 * tile
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    # issue: each candidate visited runs an iteration of the kernel's loop,
    # at least the fewest SASS instructions of one that reads the bitfield
    # if the candidate lies inside the box, else of any iteration; one warp
    # instruction a clock on each of an SM's four schedulers, 32 lanes
    # each. Lanes whose ray has stopped idle until their warp's last ray
    # stops (the warp steps)
    per_ray, inside = march_visits(wr, origins, dirs, bitfield)
    visits = int(per_ray.sum())
    warp_visits = int(per_ray.view(-1, 32).amax(dim=1).sum())
    paths, loop_sass = sass_loop_paths(_build.build())
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lane_issue_per_s = n_sm * 4 * 32 * sm_mhz * 1e6
    instructions = None if paths is None else (
        inside * paths["through_load"]
        + (visits - inside) * paths["shortest"])
    ops_ms = (None if paths is None
              else 1e3 * instructions / lane_issue_per_s)
    bound_ms, bound_by = ((bytes_ms, "bytes") if ops_ms is None
                          or ops_ms < bytes_ms else (ops_ms, "operations"))
    samples = int(p_n.sum())
    row = {"rays": tile, "samples": samples, "visits": visits,
           "warp_visits": warp_visits,
           "lane_share": visits / (32 * warp_visits),
           "inside_visits": inside, "loop_sass_instructions": paths,
           "instructions": instructions,
           "lane_issue_per_s": lane_issue_per_s,
           "ms": min(ms), "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes_bound_ms": bytes_ms,
           "ops_bound_ms": ops_ms, "bytes_moved": moved,
           "share_of_bound": bound_ms / min(ms),
           "share_of_bytes_bound": bytes_ms / min(ms),
           "share_of_ops_bound": None if ops_ms is None else ops_ms / min(ms),
           "visits_per_ns": visits / (min(ms) * 1e6),
           "bit_equal_to_plain": same}
    if paths is None:
        print(f"march kernel: no instruction count ({loop_sass})")
    else:
        lines = loop_sass.splitlines()
        print(f"march kernel: its loop's SASS ({lines[0]!r} .. "
              f"{lines[-1]!r}): {paths}; {inside} of the visits inside the "
              f"box, {instructions} instructions at least; {n_sm} SMs at "
              f"{sm_mhz:.0f} MHz issue {lane_issue_per_s:.4g} lane "
              f"instructions a second")
    ops = "not counted" if ops_ms is None else (
        f"{ops_ms:.4f} ms, {100 * ops_ms / min(ms):.1f} % reached")
    print(f"march kernel x {tile} rays (n_march 1024, 512 kept, shell, "
          f"cone 0): kernel {min(ms):.4f} ms ({ms}), plain {plain_ms:.3f} "
          f"ms; bounds: bytes {bytes_ms:.4f} ms ({moved / 1e6:.1f} MB; "
          f"{100 * bytes_ms / min(ms):.2f} % reached), issue {ops}; "
          f"{samples} samples, {visits} candidates visited "
          f"({row['visits_per_ns']:.3f} a ns; {warp_visits} warp steps, "
          f"{100 * row['lane_share']:.1f} % of their lanes busy); "
          f"bit-equal to plain: {same} "
          f"({time.perf_counter() - t0:.1f} s) [{smi}]", flush=True)
    print(f"march peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB (the plain planes included)", flush=True)
    return row


def round_rows_on_card(dev, smi, n_rays=1 << 17, k=32):
    """Phase 3d (and --round-only): the network round's RGB-net input rows
    against the plain round's at the render benchmark's network call
    (2^22 rows: the query budget; 32 samples a ray; density outputs of
    N(0, 1), unit directions with the axes and zero components first):
    the same bits, rows and raw density column, at that size and at
    ragged row counts and offsets; device times in turns (kernel, plain,
    kernel) beside the bytes bound -> its row of the result line."""
    import torch

    from instant_ngp_tpu_torch.ops.kernels.round_kernels import (
        rgb_net_rows, rgb_net_rows_plain)

    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(SEED)
    dirs = torch.randn(n_rays, 3, generator=gen, device=dev)
    dirs[:6] = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                             [-0.0, -1, 0], [0, 0, 1], [0, -0.0, -1]],
                            dtype=torch.float32, device=dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    n = n_rays * k
    density = torch.randn(n, 16, generator=gen, device=dev)
    raw = torch.empty(n, device=dev)

    def kernel():
        return rgb_net_rows(density, dirs, k, raw_density=raw)

    def plain():
        return rgb_net_rows_plain(density, dirs, k)

    before = rgb_net_rows.launches
    out = kernel()
    if rgb_net_rows.launches != before + 1:
        raise SystemExit("round: the kernel was not launched")

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    ok = same(out, plain()) and same(raw, density[:, 0].contiguous())
    del out
    for m, row0 in ((1, 0), (31, 5), (33, 100), (100003, 17), (999, n - 999)):
        ok &= same(rgb_net_rows(density[:m], dirs, k, row0),
                   rgb_net_rows_plain(density[:m], dirs, k, row0))
    if not ok:
        raise SystemExit("round: the kernel's rows differ from the plain "
                         "rows")
    ms = [cuda_ms(kernel)]
    plain_ms = cuda_ms(plain, reps=3, inner=2)
    ms.append(cuda_ms(kernel))
    # the density outputs read once, rows and raw density written once,
    # each ray's direction read once
    moved = n * (64 + 128 + 4) + n_rays * 12
    bytes_ms = 1e3 * moved / HBM_BYTES_PER_S
    row = {"rows": n, "samples_per_ray": k, "ms": min(ms),
           "plain_ms": plain_ms, "bound_ms": bytes_ms, "bound_by": "bytes",
           "bytes_moved": moved, "share_of_bound": bytes_ms / min(ms),
           "bit_equal_to_plain": ok}
    print(f"round rows kernel x {n} rows ({k} a ray): kernel {min(ms):.4f} "
          f"ms ({ms}), plain {plain_ms:.3f} ms; bound {bytes_ms:.4f} ms "
          f"({moved / 1e6:.1f} MB; {100 * bytes_ms / min(ms):.1f} % "
          f"reached); bit-equal to plain: {ok} "
          f"({time.perf_counter() - t0:.1f} s) [{smi}]", flush=True)
    return row


def profile_frame(tb, cam, smi, out_path):
    """One warm frame with CUDA-event spans around each layer (device time
    between the events, no extra syncs), one under torch.profiler, and a
    warm density pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from instant_ngp_tpu_torch.nerf.render import WavefrontRenderer
    from instant_ngp_tpu_torch.ops.kernels import round_kernels

    events = EventSpans()
    timed, spans = events.wrap, events.spans

    model = tb.model
    layers = [("hash-grid encode", model.pos_encoding),
              ("density MLP kernel", model.density_net),
              ("SH direction encode (plain round)", model.dir_encoding),
              ("RGB MLP kernel", model.rgb_net)]
    prep = WavefrontRenderer._march_and_pack
    rows = round_kernels.rgb_net_rows
    for name, mod in layers:
        mod.forward = timed(name, mod.forward)
    WavefrontRenderer._march_and_pack = timed("march + pack", prep)
    round_kernels.rgb_net_rows = timed("RGB rows kernel", rows)
    try:
        frame_start = torch.cuda.Event(enable_timing=True)
        frame_end = torch.cuda.Event(enable_timing=True)
        frame_start.record()
        tb.render_frame(WIDTH, HEIGHT, cam, focal_length=FOCAL)
        frame_end.record()
        frame_end.synchronize()
    finally:
        for _, mod in layers:
            del mod.forward
        WavefrontRenderer._march_and_pack = prep
        round_kernels.rgb_net_rows = rows
    frame_ms = frame_start.elapsed_time(frame_end)
    print(f"profile: warm frame {frame_ms:.1f} ms on the device's clock "
          f"[{smi}]")
    rest = frame_ms
    for name, pairs in spans.items():
        ms = sum(s.elapsed_time(e) for s, e in pairs)
        rest -= ms
        print(f"  {name}: {ms:.1f} ms ({100 * ms / frame_ms:.1f} %), "
              f"{len(pairs)} calls")
    print(f"  the rest (rays, alive set, composite): {rest:.1f} ms "
          f"({100 * rest / frame_ms:.1f} %)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tb.render_frame(WIDTH, HEIGHT, cam, focal_length=FOCAL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, kernels, self_device_us = profiler_kernels(prof)
    busy = sum(self_device_us(e) for e in kernels) / 1e6
    print(f"profile: traced warm frame {wall:.3f} s wall, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f} %) [{smi}]")
    for e in sorted(kernels, key=self_device_us, reverse=True)[:8]:
        us = self_device_us(e)
        print(f"  {e.key[:60]}: {us / 1e6:.3f} s "
              f"({100 * us / 1e6 / busy:.1f} % of device time), "
              f"{e.count} calls")
    for e in kernels:
        if "fused_mlp" in e.key:
            us = self_device_us(e)
            print(f"  {e.key[:70]}: {us / 1e3:.3f} ms of device time, "
                  f"{e.count} calls")
    with open(out_path, "w") as f:
        f.write(f"{smi}\n")
        f.write(rows.table(sort_by="self_cuda_time_total", row_limit=40))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb.update_density_grid_full()
    torch.cuda.synchronize()
    print(f"profile: warm density pass {time.perf_counter() - t0:.3f} s "
          f"[{smi}]")


def trained_nerf_lenses(train_tb, cfg, dev, smi):
    """Phase 12: the trained NeRF of phase 6 through the f-theta, latlong
    and equirectangular lenses and through an aperture, each a 48x48 frame
    on the card and on the CPU (the same parameters, density grid and
    bitfield; the aperture's disk samples are drawn on the host)."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.convert import params_to_jax
    from instant_ngp_tpu_torch.nerf.dataset import scene_config
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    cpu_tb = NerfTestbed(scene_config(aabb_scale=1), cfg, device="cpu",
                         compute_dtype=torch.bfloat16, seed=SEED)
    cpu_tb.load_params(params_to_jax(train_tb.inference_params()))
    cpu_tb.density_grid = train_tb.density_grid.cpu()
    cpu_tb.bitfield = train_tb.bitfield.cpu()
    size = 48
    cam = orbit_camera(angle=0.3, elevation=0.4)
    focal = FOCAL * size / WIDTH
    cases = (("FTheta", {"lens_mode": "FTheta",
                         "lens_params": LENS_FTHETA_PARAMS}),
             ("LatLong", {"lens_mode": "LatLong"}),
             ("Equirectangular", {"lens_mode": "Equirectangular"}),
             ("aperture", {"aperture_size": APERTURE_SIZE,
                           "focus_z": APERTURE_FOCUS_Z}))
    for name, kw in cases:
        ours = train_tb.render_frame(size, size, cam, focal_length=focal,
                                     **kw)
        ref = cpu_tb.render_frame(size, size, cam, focal_length=focal, **kw)
        err = np.abs(ours - ref)
        print(f"lenses: the trained model through {name}, {size}x{size} "
              f"card vs CPU: max abs {err.max():.3g}, mean abs "
              f"{err.mean():.3g}; opaque share "
              f"{(ref[..., 3] > 0.5).mean():.3f}", flush=True)
        if not (np.isfinite(ours).all() and ref[..., 3].max() > 0.5):
            raise RuntimeError(f"the {name} frame is not finite or shows "
                               f"nothing")
        if not (err.max() <= FRAME_MAX_ABS and err.mean() <= FRAME_MEAN_ABS):
            raise RuntimeError(f"the {name} frame on the card disagrees "
                               f"with the CPU's")


def procedural_cloud(side, seed):
    """A (side, side, side) float32 density grid: six Gaussian puffs around
    the box's centre, modulated by a product of sines, thresholded and
    scaled to a peak of VOLUME_PEAK (numpy, from the seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = (np.arange(side, dtype=np.float32) + 0.5) / side
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    d = np.zeros((side,) * 3, np.float32)
    for _ in range(6):
        c = rng.uniform(0.32, 0.68, 3).astype(np.float32)
        s = np.float32(rng.uniform(0.07, 0.12))
        d += np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
                    / (2 * s * s))
    d *= 1.0 + 0.35 * np.sin(23 * x + 1) * np.sin(19 * y + 2) * np.sin(29 * z)
    d = np.clip(d - 0.15, 0.0, None)
    return (VOLUME_PEAK * d / d.max()).astype(np.float32)


def visible_network_params(model, seed, density_scale=1.0):
    """An encoding + MLP's seeded weights in the JAX layout, with the grid
    table from U(-1, 1) (tcnn's 1e-4 init gives outputs of ~0, which would
    hide a wrong kernel) and the 4th output column, where there is one,
    scaled by `density_scale`."""
    import numpy as np

    net = [w.detach().cpu().numpy().copy() for w in model.network.weights]
    if net[-1].shape[1] > 3:
        net[-1][:, 3] *= density_scale
    table = model.encoding.params
    return {"encoding": np.random.default_rng(seed).uniform(
        -1.0, 1.0, table.numel()).astype(np.float32), "net": net}


def masked_l2_on(tb, batch):
    """The Volume step's loss of the training model on a fixed batch."""
    import torch

    from instant_ngp_tpu_torch.volume.testbed_volume import _masked_l2

    pos, targets, valid = batch
    with torch.no_grad():
        return float(_masked_l2(tb.model(pos), (targets, valid)))


def profile_window(fn, smi, what, n, top=0):
    """`fn` under torch.profiler -> (wall s, device busy share, kernel
    launches) per call over `n` calls; prints them, and with `top` the
    top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, kernels, self_device_us = profiler_kernels(prof)
    busy = sum(self_device_us(e) for e in kernels) / 1e6
    launches = sum(e.count for e in kernels) / n
    print(f"profile: {what}: {1e3 * wall / n:.1f} ms wall (traced), device "
          f"busy {100 * busy / wall:.1f} %, {launches:.0f} kernel launches "
          f"[{smi}]", flush=True)
    for e in sorted(kernels, key=self_device_us, reverse=True)[:top]:
        us = self_device_us(e)
        print(f"  {e.key[:60]}: {us / 1e3 / n:.3f} ms ({e.count // n} "
              f"launches, {100 * us / 1e6 / busy:.1f} % of device time)")
    return wall / n, busy / wall, launches


def volume_mode(cfg, dev, smi, fused_mlp_forward, variant, profile):
    """Phase 13 -> (the kernel's launches by variant over the phase, the
    Volume path's numbers)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.volume.nanovdb import write_nanovdb
    from instant_ngp_tpu_torch.volume.testbed_volume import (
        MAX_TRAIN_VERTICES, VolumeTestbed, VolumeTrainDraws,
        load_volume_grid)

    t0 = time.perf_counter()
    grid = procedural_cloud(VOLUME_SIDE, SEED)
    root = tempfile.mkdtemp(prefix="volume_")
    try:
        path = os.path.join(root, "cloud.nvdb")
        write_nanovdb(path, grid)
        nvdb_bytes = os.path.getsize(path)
        loaded = load_volume_grid(path)
    finally:
        shutil.rmtree(root)
    if not np.array_equal(loaded, grid):
        raise RuntimeError("the cloud did not read back from its .nvdb")
    tb = VolumeTestbed(loaded, cfg, seed=SEED, device=dev)
    setup_s = time.perf_counter() - t0
    enc, net = tb.model.encoding, tb.model.network
    widths = [w.shape[0] for w in net.weights] + [4]
    if not (enc.n_levels == 16 and enc.n_features_per_level == 2
            and widths == [32, 64, 64, 4] and net.output_activation == "ReLU"
            and tb.world2index_scale == VOLUME_SIDE):
        raise RuntimeError(f"the Volume testbed is not base.json's "
                           f"(widths {widths})")
    bits = int(np.unpackbits(tb.bitgrid.cpu().numpy()).sum())
    print(f"volume: {VOLUME_SIDE}^3 procedural cloud (peak "
          f"{tb.global_majorant:.1f}), written as NanoVDB ({nvdb_bytes} "
          f"bytes) and read back, testbed built: {setup_s:.1f} s; {bits} of "
          f"{128 ** 3} bitgrid cells occupied; grid {enc.n_entries} entries, "
          f"MLP {widths} ReLU/ReLU", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    fixed = tb._generate_training_data(
        VolumeTrainDraws.draw(gen, VOLUME_BATCH // MAX_TRAIN_VERTICES))
    valid_share = fixed[2].float().mean().item()
    counts = {"train": 0, "render": 0}
    tb.train_step = counting_launches(fused_mlp_forward, counts, "train",
                                      tb.train_step)
    tb.render_frame = counting_launches(fused_mlp_forward, counts, "render",
                                        tb.render_frame)
    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    loss_before = masked_l2_on(tb, fixed)
    losses = [tb.train(1, VOLUME_BATCH)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VOLUME_STEPS - 1):
        tb.train_step(VOLUME_BATCH)
    losses.append(tb.train(1, VOLUME_BATCH))
    torch.cuda.synchronize()
    rate = VOLUME_STEPS / (time.perf_counter() - t0)
    loss_after = masked_l2_on(tb, fixed)
    print(f"volume: {VOLUME_STEPS + 1} steps at batch {VOLUME_BATCH} "
          f"({VOLUME_BATCH // MAX_TRAIN_VERTICES} paths, "
          f"{100 * valid_share:.1f} % of the slots valid): {rate:.3f} "
          f"steps/s after the first; loss {losses[0]:.5f} at step 1 -> "
          f"{losses[-1]:.5f} at step {VOLUME_STEPS + 1}; on a fixed batch "
          f"{loss_before:.5f} -> {loss_after:.5f} [{smi}]", flush=True)

    cam = orbit_camera(angle=0.6, elevation=0.3, radius=1.6)
    model_s, launches_per_frame = [], []
    for _ in range(2):        # cold, then warm
        before = fused_mlp_forward.launches_by_variant.get(variant, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_frame = tb.render_frame(WIDTH, HEIGHT, cam)
        torch.cuda.synchronize()
        model_s.append(time.perf_counter() - t0)
        launches_per_frame.append(
            fused_mlp_forward.launches_by_variant.get(variant, 0) - before)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gt_frame = tb.render_frame(WIDTH, HEIGHT, cam, use_gt=True)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    by_variant = dict(fused_mlp_forward.launches_by_variant)
    per_frame = launches_per_frame[-1]
    print(f"volume: frame {WIDTH}x{HEIGHT} of the model: "
          f"{1e3 * model_s[0]:.1f} ms cold, {1e3 * model_s[1]:.1f} ms warm, "
          f"{per_frame} launches of {variant}; opacity mean "
          f"{model_frame[..., 3].mean():.3f}; GT frame {1e3 * gt_s:.1f} ms, "
          f"opacity mean {gt_frame[..., 3].mean():.3f}, max "
          f"{gt_frame[..., 3].max():.3f}; launches over the phase "
          f"{counts} by variant {by_variant} [{smi}]", flush=True)
    if not (np.isfinite(losses).all() and loss_after < loss_before):
        raise RuntimeError("the Volume loss on a fixed batch did not fall")
    for frame in (model_frame, gt_frame):
        if frame.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(frame).all():
            raise RuntimeError("a Volume frame is not finite or of the "
                               "wrong shape")
    if gt_frame[..., 3].max() < 0.5:
        raise RuntimeError("the GT frame does not show the cloud")
    if counts["train"] != 0 or launches_per_frame != [32, 32] \
            or set(by_variant) != {variant}:
        raise RuntimeError(f"the Volume path must launch {variant} 32 "
                           f"times a frame and never in a train step: "
                           f"{counts}, {per_frame}, {by_variant}")
    del tb.train_step, tb.render_frame
    if profile:
        profile_window(lambda: tb.train_step(VOLUME_BATCH), smi,
                       "a Volume train step", 2, 8)
        profile_window(lambda: tb.render_frame(WIDTH, HEIGHT, cam), smi,
                       f"a Volume frame {WIDTH}x{HEIGHT}", 1, 8)
        profile_window(lambda: tb.render_frame(WIDTH, HEIGHT, cam,
                                               use_gt=True), smi,
                       f"a Volume GT frame {WIDTH}x{HEIGHT}", 1, 8)
    return by_variant, {
        "steps_per_s": rate, "loss_first_last": [losses[0], losses[-1]],
        "frame_ms_warm": 1e3 * model_s[1], "gt_frame_ms": 1e3 * gt_s,
        "launches_per_frame": per_frame}


def volume_card_against_cpu(cfg, dev, fused_mlp_forward):
    """Phase 13's check: 2 train steps of a small Volume net (the first
    with the stochastic encode, the second exact) and a 24x24 frame, on the
    card and on the CPU from the same draws and weights."""
    import copy

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.ops.grid_encoding import (CornerDraws,
                                                         draw_corner_randoms)
    from instant_ngp_tpu_torch.volume.testbed_volume import (
        MAX_TRAIN_VERTICES, VolumeRenderDraws, VolumeTestbed,
        VolumeTrainDraws)

    small = copy.deepcopy(cfg)      # 16 levels: the net is 32 wide
    small["encoding"].update(log2_hashmap_size=12,
                             stochastic_corners_until=1)
    n_levels = small["encoding"]["n_levels"]
    grid = procedural_cloud(VOLUME_SIDE, SEED)
    cam = orbit_camera(angle=0.6, elevation=0.3, radius=1.6)
    size = 24
    losses, frames, params = {}, {}, None
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        gen = torch.Generator().manual_seed(SEED + 21)     # on the CPU

        def draws(step, n, device=device, gen=gen):
            d = VolumeTrainDraws.draw(gen, n)
            c = draw_corner_randoms(gen, n * MAX_TRAIN_VERTICES, 3,
                                    n_levels, 0)
            return (VolumeTrainDraws(**{k: v.to(device)
                                        for k, v in vars(d).items()}),
                    CornerDraws(c.u.to(device), None))

        tb = VolumeTestbed(grid, small, seed=SEED, device=device,
                           draws=draws)
        if params is None:
            params = visible_network_params(tb.model, SEED + 22, 40.0)
        tb.trainer.load_state(tb.state, params)
        losses[name] = [tb.train(1, 1 << 12) for _ in range(2)]
        rd = VolumeRenderDraws.draw(gen, size * size)
        before = dict(fused_mlp_forward.launches_by_variant)
        frames[name] = tb.render_frame(size, size, cam,
                                       draws=VolumeRenderDraws(**{
                                           k: v.to(device)
                                           for k, v in vars(rd).items()}))
        if name == "card":
            launched = {k: v - before.get(k, 0) for k, v in
                        fused_mlp_forward.launches_by_variant.items()
                        if v != before.get(k, 0)}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"]))
    err = np.abs(frames["card"] - frames["cpu"])
    print(f"volume card vs CPU, 2 train steps of a small net: losses "
          f"{losses['card']} vs {losses['cpu']} (relative difference "
          f"{rel:.3g}); {size}x{size} frame max abs {err.max():.3g}, mean "
          f"abs {err.mean():.3g}, opacity mean "
          f"{frames['cpu'][..., 3].mean():.3f}", flush=True)
    if rel > CPU_LOSS_REL or not (err.max() <= FRAME_MAX_ABS
                                  and err.mean() <= FRAME_MEAN_ABS):
        raise RuntimeError("Volume mode on the card disagrees with the CPU")
    if frames["cpu"][..., 3].max() < 0.3:
        raise RuntimeError("the small Volume frame shows nothing")
    if launched != {"mma_32x64x8_ReLU_ReLU": 32}:
        raise RuntimeError(f"the small Volume frame launched {launched}")


def bumpy_sphere_obj(path, res):
    """Marching cubes of a bumpy sphere's field on a res^3 grid, written
    as OBJ -> the number of triangles."""
    import numpy as np

    from instant_ngp_tpu_torch.geom.marching import save_mesh
    from instant_ngp_tpu_torch.geom.marching_cubes import marching_cubes

    g = np.linspace(-1.0, 1.0, res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    field = np.sqrt(x * x + y * y + z * z) - 0.62 - 0.07 * np.sin(7 * x) \
        * np.sin(6 * y + 1.0) * np.cos(5 * z)
    verts, faces = marching_cubes(field, 0.0)
    save_mesh(path, verts, faces)
    return len(faces)


def sdf_mode(cfgs, dev, smi, fused_mlp_forward, variant, profile):
    """Phase 14 -> (the kernel's launches by variant over the phase, the
    SDF path's numbers by configuration)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.geom.triangle_bvh import load_obj
    from instant_ngp_tpu_torch.sdf import SdfTestbed

    root = tempfile.mkdtemp(prefix="sdf_")
    out = {}
    try:
        path = os.path.join(root, "bumpy.obj")
        t0 = time.perf_counter()
        n_tris = bumpy_sphere_obj(path, SDF_MESH_RES)
        make_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tris = load_obj(path)
        read_s = time.perf_counter() - t0
        print(f"sdf: bumpy sphere by marching cubes at {SDF_MESH_RES}^3, "
              f"{n_tris} triangles, written as OBJ ({os.path.getsize(path)} "
              f"bytes) in {make_s:.1f} s, load_obj {read_s:.1f} s",
              flush=True)
        if len(tris) != n_tris or n_tris < SDF_MIN_TRIANGLES:
            raise RuntimeError(f"the mesh has {len(tris)} triangles")
        fused_mlp_forward.launches = 0
        fused_mlp_forward.launches_by_variant.clear()
        for name, cfg in cfgs.items():
            out[name] = sdf_config(name, cfg, path, dev, smi,
                                   fused_mlp_forward, variant, profile)
        by_variant = dict(fused_mlp_forward.launches_by_variant)
    finally:
        shutil.rmtree(root)
    if set(by_variant) != {variant}:
        raise RuntimeError(f"the SDF path launched {by_variant}, not "
                           f"{variant} alone")
    return by_variant, out


def sdf_config(name, cfg, path, dev, smi, fused_mlp_forward, variant,
               profile):
    """One SDF configuration at full width on the phase's mesh: training
    (the host sampler and the device step apart), IoU, a frame in every
    render mode with and without shadows, the GT oracles (base only)."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.sdf import SdfTestbed

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb = SdfTestbed(path, cfg, seed=SEED, device=dev)
    setup_s = time.perf_counter() - t0
    widths = [w.shape[0] for w in tb.model.network.weights] + [1]
    want = 24 if name == "takikawa" else 32
    if widths != [want, 64, 64, 1]:
        raise RuntimeError(f"the {name} SDF net is {widths}")
    n_params = tb.model.encoding.params.numel()
    print(f"sdf {name}: testbed (BVH{', octree' if tb.triangle_octree else ''}"
          f") built in {setup_s:.1f} s; encoding {n_params} parameters, MLP "
          f"{widths}", flush=True)
    counts = {"train": 0, "render": 0, "iou": 0}
    paths_before = dict(fused_mlp_forward.launches_by_input_path)
    for attr, kind in (("train_step_on", "train"), ("render_frame", "render"),
                       ("calculate_iou", "iou")):
        setattr(tb, attr, counting_launches(fused_mlp_forward, counts, kind,
                                            getattr(tb, attr)))
    # the host sampler alone, then the device step alone on its samples
    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        batch = tb.generate_training_samples(SDF_BATCH)
        host.append(time.perf_counter() - t0)
    fixed = (torch.from_numpy(batch[0]).to(dev),
             torch.from_numpy(batch[1]).to(dev)[:, None])

    def fixed_loss():
        with torch.no_grad():
            return float(tb.loss_fn(tb.model(fixed[0]), fixed[1]))

    loss_before = fixed_loss()
    device_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tb.train_step_on(*batch)
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
    tb.sample_seconds = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = tb.train(SDF_STEPS, SDF_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss_after = fixed_loss()
    host_per_step = tb.sample_seconds / SDF_STEPS
    print(f"sdf {name}: {SDF_STEPS} steps at batch {SDF_BATCH}: "
          f"{SDF_STEPS / wall:.3f} steps/s; host sampler {1e3 * host[-1]:.1f}"
          f" ms alone, {1e3 * host_per_step:.1f} ms a step in the run; device"
          f" step {min(device_ms):.1f} ms (CUDA events, samples given); loss "
          f"{last:.5f} at step {tb.training_step}; MAPE on a fixed batch "
          f"{loss_before:.5f} -> {loss_after:.5f} [{smi}]", flush=True)
    t0 = time.perf_counter()
    iou = tb.calculate_iou(SDF_IOU_SAMPLES)
    iou_s = time.perf_counter() - t0
    print(f"sdf {name}: IoU {iou:.4f} over {SDF_IOU_SAMPLES} samples "
          f"({iou_s:.1f} s)", flush=True)
    if not (np.isfinite(last) and loss_after < loss_before):
        raise RuntimeError(f"the {name} SDF loss on a fixed batch did not "
                           f"fall")
    if not iou >= SDF_MIN_IOU[name]:
        raise RuntimeError(f"{name} IoU {iou:.4f} under its floor "
                           f"{SDF_MIN_IOU[name]}")

    cam = orbit_camera(angle=0.8, elevation=0.35, radius=1.3)
    modes = [("Shade", False), ("Shade", False), ("Shade", True)]
    if name == "base":
        modes += [("Normals", False), ("Depth", False), ("Positions", False)]
    frames = {}
    for mode, shadows in modes:
        tb.render_with_shadows = shadows
        before = fused_mlp_forward.launches_by_variant.get(variant, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = tb.render_frame(WIDTH, HEIGHT, cam, render_mode=mode)
        torch.cuda.synchronize()
        key = mode + (" with shadows" if shadows else "")
        frames[key] = (1e3 * (time.perf_counter() - t0), frame,
                       fused_mlp_forward.launches_by_variant.get(variant, 0)
                       - before)
        if frame.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(frame).all():
            raise RuntimeError(f"the {name} {key} frame is not finite")
        want = 160 if shadows else 96
        if frames[key][2] != want:
            raise RuntimeError(f"the {name} {key} frame launched {variant} "
                               f"{frames[key][2]} times, not {want}")
    tb.render_with_shadows = False
    print(f"sdf {name}: frames {WIDTH}x{HEIGHT} (ms, launches of {variant}, "
          f"hit share): " + "; ".join(
              f"{k} {ms:.1f} / {n} / {f[..., 3].mean():.3f}"
              for k, (ms, f, n) in frames.items()) + f" [{smi}]", flush=True)
    result = {"steps_per_s": SDF_STEPS / wall,
              "host_sample_ms": 1e3 * host_per_step,
              "device_step_ms": min(device_ms), "iou": iou,
              "frame_ms": {k: v[0] for k, v in frames.items()},
              "launches_per_frame": {k: v[2] for k, v in frames.items()}}
    if name == "base":
        sil = {}
        for oracle in ("RaytracedMesh", "SpheretracedMesh", "SDFBricks"):
            tb.groundtruth_mode = oracle
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = tb.render_frame(WIDTH, HEIGHT, cam, use_gt=True)
            torch.cuda.synchronize()
            result.setdefault("gt_frame_ms", {})[oracle] = \
                1e3 * (time.perf_counter() - t0)
            if not np.isfinite(frame).all():
                raise RuntimeError(f"the {oracle} frame is not finite")
            sil[oracle] = frame[..., 3] > 0.5
        tb.groundtruth_mode = "RaytracedMesh"
        agree = {k: float((v == sil["RaytracedMesh"]).mean())
                 for k, v in sil.items()}
        print(f"sdf: GT frames {WIDTH}x{HEIGHT} (ms): "
              + ", ".join(f"{k} {v:.1f}"
                          for k, v in result["gt_frame_ms"].items())
              + f"; silhouettes against RaytracedMesh {agree} (hit share "
              f"{sil['RaytracedMesh'].mean():.3f}) [{smi}]", flush=True)
        if min(agree.values()) < GT_SILHOUETTE_AGREE \
                or sil["RaytracedMesh"].mean() < 0.05:
            raise RuntimeError("the GT oracles' silhouettes disagree")
        result["silhouette_agreement"] = agree
    if counts["train"] != 0 or counts["iou"] == 0:
        raise RuntimeError(f"the {name} SDF path must launch the kernel "
                           f"from renders and IoU alone: {counts}")
    by_path = {k: v - paths_before.get(k, 0) for k, v in
               fused_mlp_forward.launches_by_input_path.items()
               if v != paths_before.get(k, 0)}
    print(f"sdf {name}: mma launches by input path {by_path} (MLP input "
          f"{widths[0]} wide)", flush=True)
    if set(by_path) != {"ring"}:
        raise RuntimeError(f"the {name} SDF net's launches must all take "
                           f"the input ring: {by_path}")
    result["launches_by_input_path"] = by_path
    for attr in ("train_step_on", "render_frame", "calculate_iou"):
        delattr(tb, attr)
    if profile:
        profile_window(lambda: tb.train(1, SDF_BATCH), smi,
                       f"an SDF {name} train step (host sampler included)",
                       2, 8)
        profile_window(lambda: tb.render_frame(WIDTH, HEIGHT, cam), smi,
                       f"an SDF {name} Shade frame {WIDTH}x{HEIGHT}", 1, 8)
    return result


def sdf_card_against_cpu(cfg, dev, fused_mlp_forward):
    """Phase 14's check: a small SDF net (4 levels up to 128, 2^12
    entries) on a small bumpy sphere takes 2 train steps on the card and on
    the CPU from the same samples (the same numpy stream) and corner draws,
    then the card's weights after 64 more steps are rendered on both: the
    losses and the Depth frame's hit mask and depths must agree."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.ops.grid_encoding import (CornerDraws,
                                                         draw_corner_randoms)
    from instant_ngp_tpu_torch.sdf import SdfTestbed

    small = copy.deepcopy(cfg)   # 16 levels (32 wide) from 8 to 123
    small["encoding"].update(log2_hashmap_size=12, base_resolution=8,
                             per_level_scale=1.2, stochastic_corners_until=1)
    small["optimizer"]["nested"]["nested"]["learning_rate"] = 1e-2
    root = tempfile.mkdtemp(prefix="sdf_small_")
    try:
        path = os.path.join(root, "small.obj")
        bumpy_sphere_obj(path, 24)
        tbs, losses = {}, {}
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            gen = torch.Generator().manual_seed(SEED + 30)

            def draws(step, n, device=device, gen=gen):
                c = draw_corner_randoms(gen, n, 3, 16, 0)
                return CornerDraws(c.u.to(device), None)

            tbs[name] = SdfTestbed(path, small, seed=SEED, device=device,
                                   draws=draws)
            losses[name] = [tbs[name].train(1, 1 << 12) for _ in range(2)]
    finally:
        shutil.rmtree(root)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"]))
    card, cpu = tbs["card"], tbs["cpu"]
    card.train(64, 1 << 12)
    trained = card.trainer.inference_params(card.state)
    cpu.trainer.load_state(cpu.state, {
        "encoding": trained["encoding"].detach().cpu(),
        "net": [w.detach().cpu() for w in trained["net"]]})
    cam = orbit_camera(angle=0.8, elevation=0.35, radius=1.3)
    size = 32
    before = dict(fused_mlp_forward.launches_by_variant)
    ours = card.render_frame(size, size, cam, render_mode="Depth")
    launched = {k: v - before.get(k, 0) for k, v in
                fused_mlp_forward.launches_by_variant.items()
                if v != before.get(k, 0)}
    ref = cpu.render_frame(size, size, cam, render_mode="Depth")
    hit_agree = ((ours[..., 3] > 0.5) == (ref[..., 3] > 0.5)).mean()
    both = (ours[..., 3] > 0.5) & (ref[..., 3] > 0.5)
    close = (np.abs(ours[..., 0] - ref[..., 0]) <= SDF_CPU_DEPTH_TOL)[both]
    print(f"sdf card vs CPU, 2 train steps of a small net: losses "
          f"{losses['card']} vs {losses['cpu']} (relative difference "
          f"{rel:.3g}); after 64 more, a {size}x{size} Depth frame: hit "
          f"masks agree on {100 * hit_agree:.1f} % (hit share "
          f"{ref[..., 3].mean():.3f}), depths within {SDF_CPU_DEPTH_TOL} on "
          f"{100 * close.mean():.1f} % of the common hits", flush=True)
    if rel > CPU_LOSS_REL or hit_agree < SDF_CPU_PIXEL_SHARE \
            or close.mean() < SDF_CPU_PIXEL_SHARE or both.mean() < 0.05:
        raise RuntimeError("SDF mode on the card disagrees with the CPU")
    if launched != {"mma_32x64x8_ReLU_None": 96}:
        raise RuntimeError(f"the small SDF frame launched {launched}")


def check_mode_shape(name, x_all, w, act, out_act, smi):
    """Phase 3 for a shape of the Volume or SDF path: the kernel against
    its plain version at small and ragged row counts and at N_ROWS, then
    the kernel, the general kernel and the plain version timed at N_ROWS
    beside the bound -> the shape's row of the kernel table."""
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        GENERAL, fused_mlp_forward, fused_mlp_forward_plain, kernel_variant)

    for n in SMALL_ROWS:
        check_kernel(fused_mlp_forward(x_all[:n], w, act, out_act),
                     fused_mlp_forward_plain(x_all[:n], w.layers, act,
                                             out_act), f"{name} x {n}")
    x = x_all[:N_ROWS]
    variant = kernel_variant(w.dims, act, out_act)
    ref = fused_mlp_forward_plain(x, w.layers, act, out_act)
    ref_mean = ref.abs().mean().item()
    if ref_mean < KERNEL_MIN_MEAN_ABS:
        raise RuntimeError(f"the {name} reference is too small "
                           f"({ref_mean:.3g}) to check the kernel")
    max_abs, mean_abs = check_kernel(fused_mlp_forward(x, w, act, out_act),
                                     ref, f"{name} x {N_ROWS}")
    check_kernel(fused_mlp_forward(x, w, act, out_act, variant=GENERAL), ref,
                 f"{name} x {N_ROWS}, general kernel")
    ms = [cuda_ms(lambda: fused_mlp_forward(x, w, act, out_act))]
    general_ms = cuda_ms(lambda: fused_mlp_forward(x, w, act, out_act,
                                                   variant=GENERAL))
    plain_ms = cuda_ms(lambda: fused_mlp_forward_plain(x, w.layers, act,
                                                       out_act))
    ms = min(ms + [cuda_ms(lambda: fused_mlp_forward(x, w, act, out_act))])
    bound_ms, bound_by = mlp_bound_ms(N_ROWS, w.dims, 4)
    print(f"kernel {name} {'-'.join(map(str, w.dims))} {act}/{out_act} x "
          f"{N_ROWS} [{variant}]: max abs {max_abs:.3g} mean abs "
          f"{mean_abs:.3g} (ref max {ref.abs().max().item():.3g} mean "
          f"{ref_mean:.3g}) | kernel {ms:.4f} ms, general kernel "
          f"{general_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f} % "
          f"reached) [{smi}]", flush=True)
    return {"dims": list(w.dims), "activations": [act, out_act],
            "rows": N_ROWS, "variant": variant, "max_abs_err": max_abs,
            "mean_abs_err": mean_abs,
            "ref_max_abs": ref.abs().max().item(), "ref_mean_abs": ref_mean,
            "ms": ms, "general_ms": general_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms}


def narrow_input_paths(name, x_all, w, smi):
    """Phase 3 for a net whose input is narrower than its padded width
    (the Takikawa net's 24 of 32): the input path that both mma_input_path
    and the library name for an aligned f32 and bf16 x (the ring, by a
    tensor copy) and for an x 4 bytes off its alignment (per-row loads),
    each held against the plain version at RING_ROWS rows; then the bf16
    ring and the per-row path timed at N_ROWS -> numbers for the shape's
    row of the kernel table."""
    import ctypes

    import torch

    from instant_ngp_tpu_torch.ops.kernels._build import load_library
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        RING, ROWS, fused_mlp_forward, fused_mlp_forward_plain,
        mma_input_path, mma_shape)

    lib = load_library()
    in_p = mma_shape(w.dims)[0]
    d_in = w.dims[0]
    xb_all = x_all.to(torch.bfloat16)
    shifted_all = torch.empty(x_all.numel() + 1,
                              device=x_all.device)[1:].view_as(x_all)
    shifted_all.copy_(x_all)
    cases = {"f32": (x_all, RING), "bf16": (xb_all, RING),
             "f32, 4 bytes off": (shifted_all, ROWS)}
    out = {}
    for tag, (x, want) in cases.items():
        aligned = x.data_ptr() % 16 == 0
        path = mma_input_path(d_in, in_p, x.element_size(), aligned)
        c_path = RING if lib.fused_mlp_mma_input_path(
            d_in, in_p, x.element_size(), int(aligned)) else ROWS
        if not path == c_path == want:
            raise RuntimeError(f"{name} {tag}: input path {path} (library "
                               f"{c_path}), not {want}")
        worst = 0.0
        for n in RING_ROWS:
            before = dict(fused_mlp_forward.launches_by_input_path)
            got = fused_mlp_forward(x[:n], w)
            if fused_mlp_forward.launches_by_input_path.get(path, 0) \
                    != before.get(path, 0) + 1:
                raise RuntimeError(f"{name} {tag} x {n} did not launch "
                                   f"through the {path} path")
            max_abs, _ = check_kernel(got, fused_mlp_forward_plain(
                x[:n], w.layers), f"{name} {tag} x {n} ({path})")
            worst = max(worst, max_abs)
        out[tag] = {"input_path": path, "max_abs_err": worst}
    x, xb, shifted = x_all[:N_ROWS], xb_all[:N_ROWS], shifted_all[:N_ROWS]
    # in turns: ring f32, ring bf16, rows, rows, ring bf16, ring f32
    ms = {k: [] for k in cases}
    for tag, xt in (("f32", x), ("bf16", xb), ("f32, 4 bytes off", shifted),
                    ("f32, 4 bytes off", shifted), ("bf16", xb),
                    ("f32", x)):
        ms[tag].append(cuda_ms(lambda: fused_mlp_forward(xt, w)))
    for tag in cases:
        bytes_per_value = 2 if tag == "bf16" else 4
        out[tag].update(ms=min(ms[tag]), bound_ms=mlp_bound_ms(
            N_ROWS, w.dims, bytes_per_value)[0])
        out[tag]["share_of_bound"] = out[tag]["bound_ms"] / out[tag]["ms"]
    print(f"kernel {name} input paths at {RING_ROWS} rows: " + "; ".join(
        f"{tag} -> {r['input_path']} (max abs {r['max_abs_err']:.3g}), "
        f"{r['ms']:.4f} ms at {N_ROWS} rows, bound {r['bound_ms']:.4f} ms, "
        f"{100 * r['share_of_bound']:.1f} %" for tag, r in out.items())
        + f" [{smi}]", flush=True)
    del xb_all, shifted_all
    return out


def bf16_chain(x, layers, out_act="None"):
    """The net as a chain of bf16 `torch.matmul` + ReLU calls: the
    yardstick of a fused MLP, which no one PyTorch call computes."""
    import torch

    h = x.to(torch.bfloat16)
    for layer in layers[:-1]:
        h = torch.relu(torch.matmul(h, layer))
    h = torch.matmul(h, layers[-1]).float()
    return torch.relu(h) if out_act == "ReLU" else h


def modelled_l2_weight_bytes(dims, rows, n_blocks, resident):
    """Bytes of weights a model of each kernel says it reads from L2 for
    `rows` rows of a net (not measured: no profiler counter reads them on
    this machine). PR 8's layer-at-a-time kernel: every 128-row tile
    copies each layer as a (pad16(fan_in), pad16(fan_out) + 8) bf16 block.
    The wgmma kernel: every tile copies the net's chunks where they stream,
    each block once where they stay `resident` (`n_blocks` blocks)."""
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        wgmma_layer_shapes)

    pad16 = lambda n: (n + 15) // 16 * 16   # noqa: E731
    by_layer = 2 * sum(pad16(i) * (pad16(o) + 8)
                       for i, o in zip(dims[:-1], dims[1:]))
    chunks = 2 * sum(k * n for k, n in wgmma_layer_shapes(dims))
    tiles = -(-rows // 128)
    return {"layer_at_a_time": tiles * by_layer,
            "wgmma": (min(tiles, n_blocks) if resident else tiles) * chunks}


def check_net_shape(name, dims, rng, dev, smi, out_act="None",
                    streamed=False):
    """Phase 3 for a net of the configurations: its kernel (the streamed
    path where `streamed`, else an mma instantiation or the general path)
    against its plain version at small and ragged row counts and at
    N_ROWS, then the kernel, the plain version and the same net as a chain
    of bf16 `torch.matmul` + ReLU calls timed at N_ROWS beside the bound ->
    the shape's row of the kernel table. For a net of the general or the
    streamed path it also prints the wgmma kernel's plan (weights resident
    or streamed, the rings' stages) and the bytes of weights the kernels
    are modelled to read from L2. The weights are
    He-uniform, so a deep ReLU net keeps its outputs' scale."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        STREAMED, kernel_variant, pack_weights)

    variant = kernel_variant(dims, "ReLU", out_act)
    if (variant == STREAMED) != streamed:
        raise RuntimeError(f"the {name} net {dims} takes {variant}")
    w = pack_weights([torch.from_numpy(rng.uniform(
        -np.sqrt(6.0 / i), np.sqrt(6.0 / i), (i, o)).astype(np.float32))
        .to(dev) for i, o in zip(dims[:-1], dims[1:])])
    x = torch.from_numpy(rng.uniform(-1, 1, (N_ROWS, dims[0]))
                         .astype(np.float32)).to(dev)
    return time_net(name, w, x, ("ReLU", out_act), smi, streamed)


def time_net(name, w, x, acts, smi, streamed=False, min_mean=True):
    """check_net_shape's checks and times for packed weights `w` and the
    N_ROWS rows of `x` (whose reference must have a scale the check can
    see where `min_mean`). The general and the streamed path must beat the
    chain."""
    import torch

    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        GENERAL, STREAMED, fused_mlp_forward, fused_mlp_forward_plain,
        kernel_variant, wgmma_plan)

    dims = list(w.dims)
    variant = kernel_variant(dims, *acts)
    for n in SMALL_ROWS:
        check_kernel(fused_mlp_forward(x[:n], w, *acts),
                     fused_mlp_forward_plain(x[:n], w.layers, *acts),
                     f"{name} x {n}")
    ref = fused_mlp_forward_plain(x, w.layers, *acts)
    ref_mean = ref.abs().mean().item()
    if min_mean and ref_mean < KERNEL_MIN_MEAN_ABS:
        raise RuntimeError(f"the {name} reference is too small "
                           f"({ref_mean:.3g}) to check the kernel")
    max_abs, mean_abs = check_kernel(fused_mlp_forward(x, w, *acts), ref,
                                     f"{name} x {N_ROWS}")
    chain = lambda: bf16_chain(x, w.layers, acts[1])   # noqa: E731
    chain_err = (chain() - ref).abs().max().item()
    reps, inner = (3, 3) if streamed else (5, 10)
    # in turns: kernel, chain, plain, chain, kernel
    ms = [cuda_ms(lambda: fused_mlp_forward(x, w, *acts), reps, inner)]
    chain_ms = [cuda_ms(chain, reps, inner)]
    plain_ms = cuda_ms(lambda: fused_mlp_forward_plain(x, w.layers, *acts),
                       reps, inner)
    chain_ms.append(cuda_ms(chain, reps, inner))
    ms.append(cuda_ms(lambda: fused_mlp_forward(x, w, *acts), reps, inner))
    ms, chain_ms = min(ms), min(chain_ms)
    bound_ms, bound_by = mlp_bound_ms(N_ROWS, dims, 4)
    row = {"dims": dims, "activations": list(acts),
           "rows": N_ROWS, "variant": variant, "max_abs_err": max_abs,
           "mean_abs_err": mean_abs, "ref_max_abs": ref.abs().max().item(),
           "ref_mean_abs": ref_mean, "ms": ms, "plain_ms": plain_ms,
           "chain_ms": chain_ms, "chain_max_abs_err": chain_err,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms}
    extra = ""
    if variant in (GENERAL, STREAMED):
        # the kernel's plan and the modelled bytes are printed, not kept
        # in the row: the `kernels` line holds what this run measured
        resident, n_stages, in_stages, _ = wgmma_plan(
            dims, x.dtype, x.data_ptr() % 16 == 0)
        # one block per SM (the kernel's launch bounds)
        l2 = modelled_l2_weight_bytes(
            dims, N_ROWS, torch.cuda.get_device_properties(0)
            .multi_processor_count, resident)
        extra = (f"; weights {'resident' if resident else 'streamed'} "
                 f"({n_stages} weight, {in_stages} input stages); weights "
                 f"from L2, modelled (not measured): "
                 f"{l2['wgmma'] / 1e9:.4f} GB, the layer-at-a-time kernel "
                 f"{l2['layer_at_a_time'] / 1e9:.4f} GB")
    if variant in (GENERAL, STREAMED) and not ms < chain_ms:
        raise RuntimeError(f"the {name} kernel ({variant}, {ms:.4f} ms) is "
                           f"not faster than its bf16 matmul chain "
                           f"({chain_ms:.4f} ms)")
    print(f"kernel {name} {'-'.join(map(str, dims))} {'/'.join(acts)} x "
          f"{N_ROWS} [{variant}]: max abs {max_abs:.3g} mean abs "
          f"{mean_abs:.3g} (ref "
          f"max {ref.abs().max().item():.3g} mean {ref_mean:.3g}) | kernel "
          f"{ms:.4f} ms, bf16 matmul chain {chain_ms:.4f} ms (max abs "
          f"{chain_err:.3g} from plain), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f} % "
          f"reached){extra} [{smi}]", flush=True)
    return row


def write_box_obj(path):
    """The 12 triangles of the cube [-0.5, 0.5]^3 as OBJ."""
    v = [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
         for z in (-0.5, 0.5)]
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    with open(path, "w") as f:
        for p in v:
            f.write("v {} {} {}\n".format(*p))
        for a, b, c, d in quads:
            f.write(f"f {a + 1} {b + 1} {c + 1}\nf {a + 1} {c + 1} {d + 1}\n")


def geometry_scene(root, train_tb):
    """Phase 15's scene in `root`: the bumpy sphere of phase 14 (its OBJ
    made again), a box, and phase 6's trained orbit model as a NeRF object
    through a `.ingp` the port's codec writes; the snapshot is read back
    by the codec and must hold the testbed's raw parameters. -> (the
    scene's path, a camera, numbers of the snapshot)."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.data.snapshot import load_snapshot
    from instant_ngp_tpu_torch.geom.triangle_bvh import load_obj

    bumpy = os.path.join(root, "bumpy.obj")
    n_tris = bumpy_sphere_obj(bumpy, SDF_MESH_RES)
    flat = load_obj(bumpy).reshape(-1, 3)
    extent = float((flat.max(0) - flat.min(0)).max())
    write_box_obj(os.path.join(root, "box.obj"))
    snap = os.path.join(root, "orbit.ingp")
    t0 = time.perf_counter()
    train_tb.save_snapshot(snap)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_snapshot(snap)
    load_s = time.perf_counter() - t0
    raw = train_tb.model.param_tree()
    if loaded["config"] != train_tb.config or not torch.equal(
            loaded["trainer"]["params"]["pos_encoding"],
            raw["pos_encoding"].detach().cpu()) or not all(
            torch.equal(a, b.detach().cpu()) for a, b in zip(
                loaded["trainer"]["params"]["density_net"],
                raw["density_net"])):
        raise RuntimeError("the snapshot read back by the codec differs "
                           "from the testbed it was written from")
    scene = {"geometry": [
        # the bumpy sphere 0.5 wide left of the NeRF object's box, a box
        # 0.25 wide in the box's empty corner, the NeRF object at the
        # origin (its box [0, 1]^3, the orbit scene's sphere inside)
        {"type": "Mesh", "path": "bumpy.obj", "scale": 0.5 / extent,
         "center": (np.array([-0.4, 0.5, 0.5])
                    - flat.mean(0)).tolist()},
        {"type": "Mesh", "path": "box.obj", "scale": 0.25,
         "center": [0.82, 0.2, 0.2]},
        {"type": "Nerf", "path": "orbit.ingp", "center": [0.0, 0.0, 0.0]}]}
    path = os.path.join(root, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f)
    cam = look_at(np.array([0.25, 0.9, -1.5], np.float32),
                  np.array([0.25, 0.5, 0.5], np.float32),
                  np.array([0, 1, 0], np.float32))
    print(f"geometry: bumpy sphere {n_tris} triangles, a box, phase 6's "
          f"model as a NeRF object: .ingp written by the port's codec in "
          f"{save_s:.2f} s ({os.path.getsize(snap) / 2 ** 20:.1f} MiB), "
          f"read back in {load_s:.2f} s", flush=True)
    return path, cam, {"triangles": n_tris, "snapshot_save_s": save_s,
                       "snapshot_load_s": load_s,
                       "snapshot_bytes": os.path.getsize(snap)}


def geometry_mode(root, train_tb, dev, smi, fused_mlp_forward, variants):
    """Phase 15 -> (the kernel's launches by variant over the phase, the
    Geometry path's numbers). Frames of the scene through
    `Testbed.load_file` + `render` at GEOMETRY_SIZE in Shade, Normals and
    Depth, each launching both NeRF nets' instantiations once per chunk of
    the march (ceil(samples / chunk)); a small frame on the card against
    the CPU; a 1920x1080 `screenshot`."""
    import math

    import numpy as np
    import torch

    from instant_ngp_tpu_torch.testbed import Testbed

    path, cam, out = geometry_scene(root, train_tb)
    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    tb = Testbed()
    tb.load_file(path)
    impl = tb.impl
    if len(impl.meshes) != 2 or len(impl.nerfs) != 1 \
            or impl.nerfs[0].model is None:
        raise RuntimeError("the Geometry scene did not load its objects")
    chunk = impl.nerf_chunk_samples
    size = GEOMETRY_SIZE
    frames = {}
    for mode in ("Shade", "Shade", "Normals", "Depth"):   # cold, then warm
        before = dict(fused_mlp_forward.launches_by_variant)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if mode == "Shade":
            frame = tb.render(size, size, camera_matrix=cam)
        else:
            frame = impl.render_frame(size, size, cam, render_mode=mode)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = impl.last_frame_n_samples
        launched = {k: v - before.get(k, 0) for k, v in
                    fused_mlp_forward.launches_by_variant.items()
                    if v != before.get(k, 0)}
        want = math.ceil(n / chunk)
        frames[mode] = {"ms": 1e3 * sec, "samples": n,
                        "launches": launched, "predicted_launches": want,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2 ** 30, "alpha_mean": float(frame[..., 3].mean())}
        print(f"geometry: {mode} {size}x{size} {1e3 * sec:.1f} ms, {n} "
              f"samples of the NeRF object, launches {launched} "
              f"(ceil(samples / {chunk}) = {want} each), peak "
              f"{frames[mode]['peak_gib']:.2f} GiB, alpha mean "
              f"{frames[mode]['alpha_mean']:.3f} [{smi}]", flush=True)
        if frame.shape != (size, size, 4) or not np.isfinite(frame).all() \
                or n <= 0 or launched != {v: want for v in variants}:
            raise RuntimeError(f"the Geometry {mode} frame is wrong: "
                               f"{n} samples, launches {launched}")
    # where a warm Shade frame's time goes: the host's mesh trace, the
    # NeRF object's march on the device (synchronised), the rest
    from instant_ngp_tpu_torch.nerf.render import camera_rays_for_frame

    o_t, d_t = camera_rays_for_frame(size, size, (size * 1.1,) * 2, cam,
                                     device=dev)
    o_np, d_np = o_t.cpu().numpy(), d_t.cpu().numpy()
    t0 = time.perf_counter()
    t_hit, obj, _ = impl.trace_meshes(o_np, d_np)
    trace_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    impl._march_nerf_object(impl.nerfs[0], o_np, d_np,
                            np.where(obj >= 0, t_hit, 1e10))
    torch.cuda.synchronize()
    march_ms = 1e3 * (time.perf_counter() - t0)
    out["warm_shade_split_ms"] = {
        "frame": frames["Shade"]["ms"], "mesh_trace_host": trace_ms,
        "nerf_march": march_ms,
        "rest": frames["Shade"]["ms"] - trace_ms - march_ms}
    print(f"geometry: a warm Shade frame {frames['Shade']['ms']:.1f} ms: "
          f"mesh trace on the host {trace_ms:.1f} ms, NeRF-object march "
          f"{march_ms:.1f} ms, the rest (rays, shading, composite) "
          f"{frames['Shade']['ms'] - trace_ms - march_ms:.1f} ms [{smi}]",
          flush=True)

    # the NeRF object shows in the frame
    shade = tb.render(size, size, camera_matrix=cam)
    nerfs, impl.nerfs = impl.nerfs, []
    mesh_only = impl.render_frame(size, size, cam)
    impl.nerfs = nerfs
    moved = float(np.abs(shade - mesh_only).max(-1).mean())
    if not (moved > 0.01
            and shade[..., 3].mean() > mesh_only[..., 3].mean()):
        raise RuntimeError("the NeRF object does not show in the frame")

    # a small frame on the card against the CPU (the plain versions)
    small = GEOMETRY_SMALL
    fl = small * 1.1
    ours = impl.render_frame(small, small, cam, focal_length=fl)
    cpu = Testbed(device="cpu")
    cpu.load_file(path)
    ref = cpu.impl.render_frame(small, small, cam, focal_length=fl)
    err = np.abs(ours - ref)
    print(f"geometry: {small}x{small} card vs CPU: max abs {err.max():.3g}, "
          f"mean abs {err.mean():.3g}", flush=True)
    if not (err.max() <= FRAME_MAX_ABS and err.mean() <= FRAME_MEAN_ABS):
        raise RuntimeError("the card's Geometry frame disagrees with the "
                           "CPU's")
    del cpu

    # a 1920x1080 screenshot through the facade
    shot = os.path.join(root, "screenshot.png")
    before = dict(fused_mlp_forward.launches_by_variant)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tb.screenshot(shot, *SCREENSHOT, spp=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n = impl.last_frame_n_samples
    launched = {k: v - before.get(k, 0) for k, v in
                fused_mlp_forward.launches_by_variant.items()
                if v != before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"geometry: screenshot {SCREENSHOT[0]}x{SCREENSHOT[1]} "
          f"{sec:.2f} s, {n} samples, launches {launched}, peak "
          f"{peak:.2f} GiB [{smi}]", flush=True)
    if not os.path.getsize(shot) or launched != {
            v: math.ceil(n / chunk) for v in variants}:
        raise RuntimeError("the screenshot is missing or launched "
                           f"{launched}")
    out.update(nerf_object_moves_pixels=moved,
               frames=frames, card_vs_cpu_max_abs=float(err.max()),
               card_vs_cpu_mean_abs=float(err.mean()),
               screenshot={"s": sec, "samples": n, "launches": launched,
                           "peak_gib": peak})
    return dict(fused_mlp_forward.launches_by_variant), out


def wide_nets_and_cli(root, ds, dev, smi, fused_mlp_forward):
    """Phase 16 -> (the kernel's launches by variant over the wide nets'
    path, its numbers). configs/nerf/frequency.json trains WIDE_STEPS steps
    on the orbit scene (density updates included) and renders a frame;
    configs/sdf/frequency.json and oneblob.json take 2 steps on the bumpy
    sphere and render a frame: every launch the streamed kernel's. Then
    the command line as subprocesses on the card: the capture of phase 9
    trained CLI_STEPS steps with --save_snapshot, that snapshot loaded
    with --n_steps 0 and screenshots of two of its views, and the Geometry
    scene of phase 15; each must return 0 and leave its files."""
    import numpy as np
    import torch

    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import STREAMED
    from instant_ngp_tpu_torch.sdf import SdfTestbed

    out = {}
    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    cfg = load_network_config(find_network_config("frequency", "nerf"))
    tb = NerfTestbed(ds, cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = tb.train(1)
    loss = tb.train(WIDE_STEPS - 1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    in_training = fused_mlp_forward.launches_by_variant.get(STREAMED, 0)
    size = WIDE_SIZE
    t0 = time.perf_counter()
    frame = tb.render_frame(size, size, orbit_camera(0.3, 0.4),
                            focal_length=size * 1.1)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    out["nerf_frequency"] = {
        "steps": WIDE_STEPS, "s": train_s, "first_loss": first,
        "loss": loss, "launches_in_training": in_training,
        "frame_ms": 1e3 * frame_s, "frame_samples": tb.last_frame_n_samples}
    print(f"wide: nerf frequency.json {WIDE_STEPS} steps in {train_s:.2f} s "
          f"({WIDE_STEPS / train_s:.2f} steps/s), loss {first:.4f} -> "
          f"{loss:.4f}, {in_training} streamed launches by the density "
          f"updates; frame {size}x{size} {1e3 * frame_s:.1f} ms, "
          f"{tb.last_frame_n_samples} samples [{smi}]", flush=True)
    if not (np.isfinite(loss) and in_training > 0 and np.isfinite(frame).all()
            and tb.last_frame_n_samples > 0):
        raise RuntimeError("configs/nerf/frequency.json did not train and "
                           "render through the streamed kernel")
    del tb
    bumpy = os.path.join(root, "bumpy.obj")
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 2.5]],
                   np.float32)
    for name in ("frequency", "oneblob"):
        cfg = load_network_config(find_network_config(name, "sdf"))
        stb = SdfTestbed(bumpy, cfg, device=dev, seed=SEED)
        loss = stb.train(2, batch_size=1 << 16)
        before = fused_mlp_forward.launches_by_variant.get(STREAMED, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = stb.render_frame(size, size, cam)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = fused_mlp_forward.launches_by_variant.get(STREAMED, 0) - before
        out[f"sdf_{name}"] = {"loss": loss, "frame_ms": 1e3 * sec,
                              "frame_launches": n}
        print(f"wide: sdf {name}.json 2 steps (loss {loss:.4f}), frame "
              f"{size}x{size} {1e3 * sec:.1f} ms, {n} streamed launches "
              f"[{smi}]", flush=True)
        if not (np.isfinite(loss) and n > 0 and np.isfinite(frame).all()):
            raise RuntimeError(f"configs/sdf/{name}.json did not render "
                               f"through the streamed kernel")
        del stb
    by_variant = dict(fused_mlp_forward.launches_by_variant)
    if set(by_variant) != {STREAMED}:
        raise RuntimeError(f"the wide nets launched {by_variant}")

    # the command line, as a user runs it
    cap = os.path.join(root, "capture")
    path, _ = write_capture(cap, 64, WIDTH, CAPTURE_EXTRA_DIMS)
    snap = os.path.join(root, "capture.ingp")
    shots = os.path.join(root, "shots")
    runs = [
        ("train", ["--scene", path, "--n_steps", str(CLI_STEPS),
                   "--save_snapshot", snap], [snap]),
        ("reload", ["--scene", path, "--load_snapshot", snap, "--n_steps",
                    "0", "--screenshot_transforms", path,
                    "--screenshot_frames", "0", "1", "--screenshot_dir",
                    shots, "--width", str(WIDE_SIZE), "--height",
                    str(WIDE_SIZE), "--screenshot_spp", "1"],
         [os.path.join(shots, "0000.exr"), os.path.join(shots, "0001.exr")]),
        ("geometry", [os.path.join(root, "scene.json"), "--n_steps", "0",
                      "--screenshot_dir", os.path.join(root, "geo_shot"),
                      "--width", str(GEOMETRY_SIZE), "--height",
                      str(GEOMETRY_SIZE), "--screenshot_spp", "1"],
         [os.path.join(root, "geo_shot", "screenshot.png")])]
    env = dict(os.environ, PYTHONPATH=REPO)
    out["cli"] = {}
    for tag, args, files in runs:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "instant_ngp_tpu_torch",
                               *args], cwd=root, env=env, capture_output=True,
                              text=True, timeout=600)
        sec = time.perf_counter() - t0
        missing = [f for f in files if not os.path.isfile(f)]
        last = proc.stdout.strip().splitlines()[-1:] or [""]
        print(f"cli: {tag}: rc {proc.returncode} in {sec:.1f} s, "
              f"{last[0]}", flush=True)
        if proc.returncode != 0 or missing:
            raise RuntimeError(f"the command line's {tag} run failed (rc "
                               f"{proc.returncode}, missing {missing}):\n"
                               f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        out["cli"][tag] = {"rc": proc.returncode, "s": sec}
    return by_variant, out



def deposit_ab(cfg, image_cfg, dev, smi):
    """--deposit-ab: the plain table gradient summed by `index_put_` (the
    plain version's deposit, in an order the indices fix) against
    `index_add_` (atomic adds), swapped in turns (put, add, add, put) in
    one process, with the grid kernels' sorted deposit
    (`grid_kernels.table_gradient`, what the train steps run) timed
    beside them: the gradient alone at the shapes of a NeRF train step
    (exact, and the one-corner stochastic deposit) and of an Image step.
    The error map's deposit the same way: alone, at the default step's
    rays and map, and in 16 default NeRF steps (base.json, batch 2^18,
    after 32 steps of warm-up)."""
    import torch

    from instant_ngp_tpu_torch.image.testbed_image import ImageTestbed
    from instant_ngp_tpu_torch.nerf import training
    from instant_ngp_tpu_torch.nerf.sampler import RayBatch
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu_torch.ops import grid_encoding

    put = grid_encoding.ordered_deposit

    def add(grad, rows, values):
        grad.index_add_(0, rows, values)

    variants = {"index_put_": put, "index_add_": add}
    results = {}

    def ab(name, fn, n, module=grid_encoding):
        """`module`'s deposit swapped in turns: the table gradient's
        (grid_encoding) or the error map's (training)."""
        for v in ("index_put_", "index_add_", "index_add_", "index_put_"):
            module.ordered_deposit = variants[v]
            fn()                                   # one untimed call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            results.setdefault(name, {}).setdefault(v, []).append(
                1e3 * (time.perf_counter() - t0) / n)
        module.ordered_deposit = put
        r = results[name]
        print(f"deposit A/B: {name}: index_put_ "
              f"{statistics.mean(r['index_put_']):.3f} ms, index_add_ "
              f"{statistics.mean(r['index_add_']):.3f} ms (in turns "
              f"{[round(x, 3) for x in r['index_put_']]} / "
              f"{[round(x, 3) for x in r['index_add_']]}) [{smi}]",
              flush=True)

    ds = make_scene()
    nerf = NerfTestbed(ds, cfg, device=dev, compute_dtype=torch.bfloat16,
                       seed=SEED)
    img = ImageTestbed(procedural_image(IMAGE_SIDE, SEED), image_cfg,
                       seed=SEED, device=dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    n = 1 << 18
    for name, enc, j in (("NeRF table gradient, exact", nerf.model
                          .pos_encoding, None),
                         ("NeRF table gradient, stochastic one-corner",
                          nerf.model.pos_encoding, 1),
                         ("Image table gradient, exact", img.model.encoding,
                          None)):
        x = torch.rand(n, enc.n_dims, device=dev, generator=gen)
        g_out = torch.randn(n, enc.n_output_dims, device=dev, generator=gen)
        if j is None:
            plain = lambda e=enc, x=x, g=g_out: \
                e._table_gradient_plain(x, g, None)     # noqa: E731
            kernel = lambda e=enc, x=x, g=g_out: \
                e._table_gradient(x, g, None)           # noqa: E731
        else:
            draws = grid_encoding.draw_corner_randoms(gen, n, enc.n_dims,
                                                      enc.n_levels, j)
            plain = lambda e=enc, x=x, g=g_out, d=draws, j=j: \
                e._table_gradient_stochastic_plain(x, g, None, d, j)  # noqa
            kernel = lambda e=enc, x=x, g=g_out, d=draws, j=j: \
                e._table_gradient_stochastic(x, g, None, d, j)  # noqa
        ab(f"{name} ({n} samples), plain version", plain, 16)
        results[f"{name} ({n} samples), grid kernel"] = \
            cuda_ms(kernel, reps=4, inner=16)
        print(f"deposit A/B: {name} ({n} samples): grid kernel "
              f"{results[f'{name} ({n} samples), grid kernel']:.3f} ms "
              f"[{smi}]", flush=True)
    nerf.train(32)
    # the error map's deposit alone at this step's rays and map, then in
    # the step with the table gradient left sorted
    n_rays = nerf.rays_per_batch
    cw, ch = nerf._error_map_res
    rays = RayBatch(None, None, None, None,
                    img_idx=torch.randint(0, ds.n_images, (n_rays,),
                                          device=dev, generator=gen),
                    uv=torch.rand(n_rays, 2, device=dev, generator=gen))
    loss = torch.rand(n_rays, device=dev, generator=gen)
    ab(f"NeRF error-map deposit ({n_rays} rays, {cw}x{ch} cells x "
       f"{ds.n_images} images)",
       lambda: training.error_map_delta(nerf._error_map, rays, loss,
                                        (cw, ch)), 64, training)
    ab("NeRF train step, defaults, error map's deposit alone swapped",
       nerf.train_step, 16, training)
    return results


def step_times(cfg, dev, smi, n_warm=48, n_timed=64):
    """--step-times: NeRF train steps of base.json at the testbed's batch
    on the synthetic orbit scene, with the defaults (stochastic-corner
    encode, one-corner table gradient) and with the exact encode: the host
    clock's ms a step over `n_timed` steps after `n_warm` (`train_step`
    alone, no density update), and the table gradient's CUDA-event ms a
    call in those steps. Only public entry points, so that the same script
    times an older checkout of the package (run it from there)."""
    import torch

    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    ds = make_scene()
    out = {}
    for mode in ("default", "exact"):
        tb = NerfTestbed(ds, cfg, device=dev, compute_dtype=torch.bfloat16,
                         seed=SEED)
        tb.stochastic_corners = mode == "default"
        tb.train(n_warm)
        enc = tb.model.pos_encoding
        spans = EventSpans()
        patches = ("_table_gradient", "_table_gradient_stochastic")
        for attr in patches:
            setattr(enc, attr, spans.wrap("table gradient",
                                          getattr(enc, attr)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_timed):
            tb.train_step()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_timed
        for attr in patches:
            delattr(enc, attr)
        calls = spans.calls("table gradient")
        out[mode] = {"step_ms": step_ms, "table_gradient_ms":
                     spans.ms("table gradient") / max(calls, 1),
                     "table_gradient_calls": calls}
        print(f"step times: {mode}: {step_ms:.4f} ms a step (host clock, "
              f"{n_timed} steps after {n_warm}); table gradient "
              f"{out[mode]['table_gradient_ms']:.4f} ms a call (CUDA "
              f"events, {calls} calls) [{smi}]", flush=True)
        del tb
        torch.cuda.empty_cache()
    print(json.dumps({"step_times": out}), flush=True)
    return out


# -- phase 17: data- and level-parallel NeRF ---------------------------------
def _rank_testbed(ds, cfg, mesh):
    """A base.json testbed at full width (bf16 compute, weights from SEED)
    on this rank's card; on `mesh` where one is given."""
    import torch

    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed

    torch.backends.cuda.matmul.allow_tf32 = False
    return NerfTestbed(ds, cfg, compute_dtype=torch.bfloat16, seed=SEED,
                       mesh=mesh)


def _split_draws(both, n, part):
    """Rows part*n .. (part+1)*n of every field of a TrainDraws."""
    return type(both)(*(None if v is None else v[part * n:(part + 1) * n]
                        for v in both))


def _step_errors(got, ref, table_key="pos_encoding"):
    """How one step's parameters and Adam moments `got` (trees of tensors)
    stand against `ref`, by the CPU tests' rules: the moments to rtol 1e-4
    / atol 1e-7 everywhere; the parameters to the same on at least 99 %
    of each leaf's entries and within one Adam step (lr 1e-2) on the rest
    (Adam's eps of 1e-15 turns float32 noise in a near-zero gradient into
    a full step of either sign) -> the worst numbers, and whether they
    hold."""
    from instant_ngp_tpu_torch.ops.optimizers import tree_leaves

    out = {"moment_violations": 0, "param_close_share": 1.0,
           "param_max_diff": 0.0}
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(got[key]), tree_leaves(ref[key])):
            bad = (a - b).abs() > 1e-7 + 1e-4 * b.abs()
            out["moment_violations"] += int(bad.sum())
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(ref["params"])):
        diff = (a - b).abs()
        close = (diff <= 1e-7 + 1e-4 * b.abs()).float().mean().item()
        out["param_close_share"] = min(out["param_close_share"], close)
        out["param_max_diff"] = max(out["param_max_diff"],
                                    diff.max().item())
    out["ok"] = (out["moment_violations"] == 0
                 and out["param_close_share"] > 0.99
                 and out["param_max_diff"] <= 2e-2)
    return out


def pair_collectives_job():
    """Every collective of parallel/mesh.py on CUDA tensors of two gloo
    ranks that share one card -> {name: values as this rank sees them}."""
    import torch

    from instant_ngp_tpu_torch.parallel import mesh as pm

    mesh = pm.Mesh({"data": 2}, "cuda")
    g, r = mesh.group("data"), float(mesh.rank)
    x = torch.tensor([r + 1.0, 2.0 * r], device=mesh.device)
    return {"device": str(mesh.device),
            "all_reduce": pm.psum(x, g).tolist(),
            "all_gather_into_tensor": pm.all_gather(x, g).tolist(),
            "reduce_scatter_tensor": pm.psum_scatter(x, g).tolist(),
            "broadcast": pm.broadcast(x, g).tolist()}


def pair_step_job(ds, cfg, n_rays, max_k):
    """One sharded train step of two gloo ranks on one card at full
    width, each from its half of one set of draws (exact encode, no error
    map, every cell occupied: the capacity cannot truncate); rank 0 then
    takes the same step on one testbed over both halves and holds the two
    against each other."""
    import torch

    from instant_ngp_tpu_torch.nerf.parallel import make_sharded_train_step
    from instant_ngp_tpu_torch.nerf.sampler import draw_train_randoms
    from instant_ngp_tpu_torch.nerf.training import nerf_train_step
    from instant_ngp_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"data": 2}, "cuda")
    rank = mesh.index("data")
    tb = _rank_testbed(ds, cfg, mesh)
    bits = torch.full_like(tb.bitfield, 255)
    mean = torch.zeros((), device=tb.device)
    both = draw_train_randoms(torch.Generator().manual_seed(SEED + 17),
                              2 * n_rays, tb.data.n_images).to(tb.device)

    def cfg_of(t, rays):
        return t._train_cfg(rays, max_k)._replace(stochastic_corners=False,
                                                  use_error_map=False)

    step = make_sharded_train_step(tb.model, tb.optimizer,
                                   cfg_of(tb, n_rays), tb.aabb_min,
                                   tb.aabb_max, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = step(tb.opt_state, tb.data, bits, mean,
                 _split_draws(both, n_rays, rank))
    torch.cuda.synchronize()
    out = {"ms": 1e3 * (time.perf_counter() - t0),
           "loss": float(stats["loss"]),
           "measured": float(stats["measured_batch_size"]),
           "capacity": cfg_of(tb, n_rays).sample_capacity}
    if rank == 0:
        ref = _rank_testbed(ds, cfg, None)
        ref_stats = nerf_train_step(
            ref.model, ref.optimizer, cfg_of(ref, 2 * n_rays), ref.aabb_min,
            ref.aabb_max, ref.opt_state, ref.data, bits, mean, both)
        out["ref_loss"] = float(ref_stats["loss"])
        out["ref_measured"] = float(ref_stats["measured_batch_size"])
        out["errors"] = _step_errors(
            {"params": tb.model.param_tree(), "m": tb.opt_state["m"],
             "v": tb.opt_state["v"]},
            {"params": ref.model.param_tree(), "m": ref.opt_state["m"],
             "v": ref.opt_state["v"]})
    return out


def pair_loop_job(ds, cfg, n_steps):
    """n_steps of `NerfTestbed(mesh=)` with the defaults (stochastic
    encode, error map, sharded density updates) on two gloo ranks of one
    card -> the digests of everything replicated, the loss and the time of
    each step, and this rank's first rays."""
    import torch

    from instant_ngp_tpu_torch.determinism import digest
    from instant_ngp_tpu_torch.ops.optimizers import tree_leaves
    from instant_ngp_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"data": 2}, "cuda")
    tb = _rank_testbed(ds, cfg, mesh)
    first_uv = tb._train_draws(64).rays.uv.cpu().numpy()
    ms = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tb.train(1)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {"ms": ms, "loss": loss, "first_uv": first_uv,
            "measured": tb.measured_batch_size,
            "digests": {
                "params": digest(*tree_leaves(tb.model.param_tree())),
                "opt": digest(*tree_leaves(
                    [tb.opt_state[k] for k in ("step", "m", "v", "ema")])),
                "density_grid": digest(tb.density_grid),
                "bitfield": digest(tb.bitfield),
                "error_map": digest(tb._error_map)}}


def pair_tp_job(ds, cfg, n_rays, max_k):
    """One hybrid (data=1, model=2) step of two gloo ranks on one card at
    full width, against the data-parallel step of one testbed from the same
    draws; and the level-sharded features against the plain encode."""
    import torch

    from instant_ngp_tpu_torch.nerf.sampler import draw_train_randoms
    from instant_ngp_tpu_torch.nerf.training import nerf_train_step
    from instant_ngp_tpu_torch.parallel.mesh import Mesh, all_gather
    from instant_ngp_tpu_torch.parallel.tp import make_tp_train_step, tp_state

    mesh = Mesh({"data": 1, "model": 2}, "cuda")
    index, group = mesh.index("model"), mesh.group("model")
    tb = _rank_testbed(ds, cfg, None)
    ref = _rank_testbed(ds, cfg, None)
    cfg_step = tb._train_cfg(n_rays, max_k)._replace(
        stochastic_corners=False, use_error_map=False)
    bits = torch.full_like(tb.bitfield, 255)
    mean = torch.zeros((), device=tb.device)
    draws = draw_train_randoms(torch.Generator().manual_seed(SEED + 19),
                               n_rays, tb.data.n_images).to(tb.device)

    step, grid = make_tp_train_step(tb.model, tb.optimizer, cfg_step,
                                    tb.aabb_min, tb.aabb_max, mesh)
    # the features of this rank's levels against the plain encode
    x = torch.rand(1 << 18, 3, device=tb.device,
                   generator=torch.Generator(tb.device).manual_seed(SEED))
    with torch.no_grad():
        block = grid.shard(grid.pack(tb.model.pos_encoding.params), index)
        feats = grid.local_features(block, x, index, group)
        plain = tb.model.pos_encoding(x)
    feat_err = (feats - plain).abs()
    feats_ok = bool((feat_err <= 1e-7 + 1e-5 * plain.abs()).all())

    state = tp_state(tb.model, tb.optimizer, grid, index)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = step(state, tb.data, bits, mean, draws)
    torch.cuda.synchronize()
    tp_ms = 1e3 * (time.perf_counter() - t0)
    nerf_train_step(ref.model, ref.optimizer, cfg_step, ref.aabb_min,
                    ref.aabb_max, ref.opt_state, ref.data, bits, mean, draws)

    def whole(tree):
        return dict(tree, pos_encoding=grid.unpack(all_gather(
            tree["pos_encoding"].detach(), group)))

    errors = _step_errors(
        {"params": whole(state["params"]), "m": whole(state["opt"]["m"]),
         "v": whole(state["opt"]["v"])},
        {"params": ref.model.param_tree(), "m": ref.opt_state["m"],
         "v": ref.opt_state["v"]})
    return {"ms": tp_ms, "loss": float(stats["loss"]), "errors": errors,
            "features_max_abs": feat_err.max().item(),
            "features_ok": feats_ok}


def sharded_on_card(ds, cfg, dev, smi, fused_mlp_forward):
    """Phase 17a: a 1-rank NCCL mesh trains and renders on the card ->
    the numbers of the phase, the kernel's launches by the sharded density
    updates and the sharded render among them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from instant_ngp_tpu_torch.nerf.parallel import make_sharded_render
    from instant_ngp_tpu_torch.nerf.render import camera_rays_for_frame
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu_torch.parallel.mesh import (collective_log,
                                                     data_parallel_mesh)

    mesh = data_parallel_mesh()
    if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
        raise RuntimeError(f"the default mesh is not NCCL on the card: "
                           f"{dist.get_backend()}, {mesh.device}")
    tb = NerfTestbed(ds, cfg, compute_dtype=torch.bfloat16, seed=SEED,
                     mesh=mesh)
    plain_tb = NerfTestbed(ds, cfg, device=dev, compute_dtype=torch.bfloat16,
                           seed=SEED)
    psnr_before = tb.eval_psnr(0)
    counts = {"prep": 0, "step": 0}
    prep, step = tb.training_prep, tb.train_step
    tb.training_prep = counting_launches(fused_mlp_forward, counts, "prep",
                                         prep)
    tb.train_step = counting_launches(fused_mlp_forward, counts, "step",
                                      step)
    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    first_loss = tb.train(1)
    tb.train(TRAIN_WARMUP - 1)
    plain_tb.train(TRAIN_WARMUP)
    n_timed = TRAIN_STEPS - TRAIN_WARMUP
    rates = {}
    # in turns: sharded, plain, sharded, plain, each half of the window
    for name, t in (("mesh", tb), ("plain", plain_tb)) * 2:
        collective_log.enabled = name == "mesh"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = t.train(n_timed // 2)
        torch.cuda.synchronize()
        rates.setdefault(name, []).append(
            (n_timed // 2) / (time.perf_counter() - t0))
        if name == "mesh":
            last_loss = loss
    collective_log.enabled = False
    coll_ms = collective_log.total_ms()
    collective_log.reset()
    del tb.training_prep, tb.train_step
    psnr_after = tb.eval_psnr(0)
    launches_prep = counts["prep"]
    print(f"mesh[1 rank, nccl]: {TRAIN_STEPS} steps, loss {first_loss:.6f}"
          f" -> {last_loss:.6f}; PSNR of view 0 {psnr_before:.2f} -> "
          f"{psnr_after:.2f} dB; {statistics.mean(rates['mesh']):.2f} "
          f"steps/s against {statistics.mean(rates['plain']):.2f} unsharded "
          f"(the same {n_timed} steps each, in turns: "
          f"{[round(r, 2) for r in rates['mesh']]} vs "
          f"{[round(r, 2) for r in rates['plain']]}); collectives "
          + ", ".join(f"{k} {v / n_timed:.4f} ms" for k, v in
                      coll_ms.items())
          + f" a step (CUDA events, {n_timed} steps); kernel launches: "
          f"{counts['prep']} by sharded density updates, {counts['step']} by"
          f" train steps [{smi}]", flush=True)

    # a 400x400 frame through make_sharded_render, against the same
    # model's render_tile frame
    tile = 1 << 13
    cam = orbit_camera(angle=0.3, elevation=0.4)
    origins, dirs = camera_rays_for_frame(WIDTH, HEIGHT, (FOCAL, FOCAL), cam,
                                          device=dev)
    n_pix = origins.shape[0]
    n_tiles = -(-n_pix // tile)
    pad = n_tiles * tile - n_pix
    # padding rays start far outside the box and point away from it
    origins = torch.cat([origins, origins.new_full((pad, 3), 10.0)])
    dirs = torch.cat([dirs, dirs.new_tensor([[1.0, 0.0, 0.0]]).expand(pad,
                                                                      3)])
    render = make_sharded_render(tb.inference_model,
                                 tb._render_config("Shade", 1e-2, tile),
                                 tb.aabb_min, tb.aabb_max, mesh)
    before = fused_mlp_forward.launches
    by_variant_before = dict(fused_mlp_forward.launches_by_variant)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render(origins.view(n_tiles, tile, 3),
                     dirs.view(n_tiles, tile, 3), tb.bitfield,
                     torch.zeros(3, device=dev))
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    launches_render = fused_mlp_forward.launches - before
    render_by_variant = {
        k: v - by_variant_before.get(k, 0)
        for k, v in fused_mlp_forward.launches_by_variant.items()
        if v != by_variant_before.get(k, 0)}
    frame = torch.cat([out["rgb"].reshape(-1, 3),
                       out["alpha"].reshape(-1, 1)], -1)[:n_pix]
    frame = frame.reshape(HEIGHT, WIDTH, 4).cpu().numpy()
    tb.render_wavefront = False
    ref = tb.render_frame(WIDTH, HEIGHT, cam, focal_length=FOCAL)
    err = np.abs(frame - ref)
    print(f"mesh[1 rank, nccl]: sharded render {WIDTH}x{HEIGHT} in "
          f"{n_tiles} tiles of {tile}: {render_s:.3f} s, "
          f"{int(out['n_samples'])} samples, {launches_render} kernel "
          f"launches {render_by_variant}; against render_tile's frame max "
          f"abs "
          f"{err.max():.3g}, mean abs {err.mean():.3g} [{smi}]",
          flush=True)
    dist.destroy_process_group()

    if not last_loss < first_loss:
        raise RuntimeError("the mesh testbed's loss did not fall")
    if not psnr_after >= TRAIN_MIN_PSNR["default"]:
        raise RuntimeError(f"the mesh testbed's PSNR of view 0 is "
                           f"{psnr_after:.2f} dB (at least "
                           f"{TRAIN_MIN_PSNR['default']} asked)")
    if launches_prep == 0 or counts["step"] != 0 or launches_render == 0:
        raise RuntimeError(f"the kernel must be launched by the sharded "
                           f"density updates and render and by no train "
                           f"step: {counts}, render {launches_render}")
    if not (err.max() <= FRAME_MAX_ABS and err.mean() <= FRAME_MEAN_ABS) \
            or ref[..., 3].max() <= 0.0:
        raise RuntimeError("the sharded frame disagrees with render_tile's")
    if set(coll_ms) != {"all_reduce", "all_gather"}:
        raise RuntimeError(f"the mesh steps ran collectives {coll_ms}")
    return {
        "launches_density_updates": launches_prep,
        "launches_render": launches_render,
        "launches_render_by_variant": render_by_variant,
        "steps_per_s": rates, "collective_ms_per_step": {
            k: v / n_timed for k, v in coll_ms.items()},
        "psnr_db": psnr_after, "frame_max_abs": float(err.max())}


def two_ranks_on_card(ds, cfg, smi):
    """Phase 17b: two gloo ranks share the card (NCCL refuses two ranks on
    one device)."""
    import numpy as np

    from instant_ngp_tpu_torch.parallel.ranks import RankPool

    n_rays, max_k = 1 << 12, 32
    t0 = time.perf_counter()
    with RankPool(2, backend="gloo") as pool:
        spawn_s = time.perf_counter() - t0
        coll = pool.run(pair_collectives_job)
        want = {"all_reduce": [[3.0, 2.0]] * 2,
                "all_gather_into_tensor": [[1.0, 0.0, 2.0, 2.0]] * 2,
                "reduce_scatter_tensor": [[3.0], [2.0]],
                "broadcast": [[1.0, 0.0]] * 2}
        got = {k: [c[k] for c in coll] for k in want}
        print(f"pair[2 ranks, gloo, one card]: spawned in {spawn_s:.1f} s; "
              f"collectives on CUDA tensors ({coll[0]['device']}, "
              f"{coll[1]['device']}): {got}", flush=True)
        if got != want:
            raise RuntimeError(f"gloo's collectives on CUDA tensors: {got}, "
                               f"expected {want}")
        step = pool.run(pair_step_job, ds, cfg, n_rays, max_k)
        loop = pool.run(pair_loop_job, ds, cfg, 8)
        tp = pool.run(pair_tp_job, ds, cfg, 2 * n_rays, max_k)
    err = step[0]["errors"]
    print(f"pair: one sharded step at full width, {n_rays} rays x 2 ranks "
          f"(capacity {step[0]['capacity']} a rank), "
          f"{[round(s['ms'], 2) for s in step]} ms; loss {step[0]['loss']:.6f}"
          f" vs one testbed's {step[0]['ref_loss']:.6f}, samples "
          f"{step[0]['measured']:.0f} vs {step[0]['ref_measured']:.0f}; "
          f"moments off tolerance {err['moment_violations']}, parameters "
          f"within it {100 * err['param_close_share']:.3f} % (max diff "
          f"{err['param_max_diff']:.3g}) [{smi}]", flush=True)
    digests = [r["digests"] for r in loop]
    same = {k: digests[0][k] == digests[1][k] for k in digests[0]}
    print(f"pair: 8 steps with the defaults, ms a step "
          f"{[round(m, 1) for m in loop[0]['ms']]} (rank 0), loss "
          f"{loop[0]['loss']:.6f}, {loop[0]['measured']} samples; rank 1 "
          f"bit-identical to rank 0: {same} [{smi}]", flush=True)
    terr = tp[0]["errors"]
    print(f"pair: tensor-parallel step (data=1, model=2), {2 * n_rays} rays:"
          f" {[round(r['ms'], 2) for r in tp]} ms, loss {tp[0]['loss']:.6f};"
          f" against the data-parallel step: moments off tolerance "
          f"{terr['moment_violations']}, parameters within it "
          f"{100 * terr['param_close_share']:.3f} % (max diff "
          f"{terr['param_max_diff']:.3g}); level-sharded features against "
          f"the plain encode, max abs {tp[0]['features_max_abs']:.3g} "
          f"[{smi}]", flush=True)
    if not (err["ok"] and step[0]["measured"] == step[0]["ref_measured"]
            and abs(step[0]["loss"] - step[0]["ref_loss"])
            <= 1e-5 * abs(step[0]["ref_loss"])):
        raise RuntimeError("the two ranks' step disagrees with one "
                           "testbed's")
    if not all(same.values()):
        raise RuntimeError(f"the replicas parted after 8 steps: {same}")
    if np.array_equal(loop[0]["first_uv"], loop[1]["first_uv"]):
        raise RuntimeError("the two ranks drew the same rays")
    if not (terr["ok"] and all(r["features_ok"] for r in tp)):
        raise RuntimeError("the tensor-parallel step or its features "
                           "disagree with the data-parallel ones")
    return {"step_ms": [s["ms"] for s in step],
            "loop_ms": loop[0]["ms"], "tp_ms": [r["ms"] for r in tp],
            "bit_identical": same}


def main():
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT",
                        help="also profile a warm frame; the profiler's "
                             "table goes to OUT")
    parser.add_argument("--curve", action="store_true",
                        help="also train 1024 steps under the protocol of "
                             "the JAX package's quality record and print "
                             "PSNR by step beside it")
    parser.add_argument("--grid-only", action="store_true",
                        help="after the build, only run phase 3b (the grid "
                             "kernels) and stop")
    parser.add_argument("--march-only", action="store_true",
                        help="after the build, only check and time the "
                             "march-and-pack kernel (march_kernel_on_card) "
                             "and stop")
    parser.add_argument("--round-only", action="store_true",
                        help="after the build, only check and time the "
                             "network round's RGB rows kernel "
                             "(round_rows_on_card) and stop")
    parser.add_argument("--deposit-ab", action="store_true",
                        help="after the build, only time the table "
                             "gradient's deposit by index_put_ against "
                             "index_add_ (deposit_ab) and stop")
    parser.add_argument("--step-times", action="store_true",
                        help="after the build, only time default and exact "
                             "NeRF train steps (step_times) and stop")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, REPO)
    from instant_ngp_tpu_torch.config import (find_network_config,
                                              load_network_config)
    from instant_ngp_tpu_torch.nerf.dataset import scene_config
    from instant_ngp_tpu_torch.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu_torch.ops.encodings import sh_basis
    from instant_ngp_tpu_torch.ops.grid_encoding import GridEncoding
    from instant_ngp_tpu_torch.ops.kernels import _build
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        fused_mlp_forward, fused_mlp_forward_plain)

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 is f32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(lib_path, REPO)}", flush=True)
    log = (lib_path.parent / "build.log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Function properties for" in line:
                print(f"  ptxas: {line.split('for ')[-1].strip()[:72]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    if args.grid_only:
        grid_kernels_on_card(dev, smi)
        return
    if args.march_only:
        march_kernel_on_card(dev, smi)
        return
    if args.round_only:
        round_rows_on_card(dev, smi)
        return
    if args.step_times:
        step_times(load_network_config(find_network_config("base", "nerf")),
                   dev, smi)
        return
    if args.deposit_ab:
        deposit_ab(load_network_config(find_network_config("base", "nerf")),
                   load_network_config(find_network_config("base", "image")),
                   dev, smi)
        return

    # the network of the main path, at full width, weights from a seed
    cfg = load_network_config(find_network_config("base", "nerf"))
    scene = scene_config(aabb_scale=1)
    tb = NerfTestbed(scene, cfg, device=dev, compute_dtype=torch.bfloat16,
                     seed=SEED)
    model = tb.model
    params = trained_scale_params(model, SEED)
    tb.load_params(params)
    print(f"network: grid {model.pos_encoding.n_entries} entries x "
          f"{model.pos_encoding.n_features_per_level} features, density "
          f"{[w.shape[1] for w in model.density_net.weights]}, rgb "
          f"{[w.shape[1] for w in model.rgb_net.weights]}", flush=True)

    # phase 3: kernel vs plain, on the path's inputs
    from instant_ngp_tpu_torch.ops.kernels.mlp_kernels import (
        GENERAL, MMA_STAGES, kernel_variant, pack_weights)

    gen = torch.Generator().manual_seed(SEED + 1)
    n_max = max(N_ROWS, *OTHER_ROWS)
    with torch.no_grad():
        pos = torch.rand(n_max, 3, generator=gen).to(dev)
        d = torch.randn(n_max, 3, generator=gen)
        d = ((d / d.norm(dim=-1, keepdim=True) + 1.0) * 0.5).to(dev)
        feats = model.pos_encoding(pos).contiguous()
        dens_w = model.density_net.kernel_weights()
        dens_plain = fused_mlp_forward_plain(feats, dens_w.layers)
        dirw = d * 2.0 - 1.0
        rgb_in = torch.cat([dens_plain, sh_basis(4, dirw[:, 0], dirw[:, 1],
                                                 dirw[:, 2])], -1).contiguous()
        rgb_w = model.rgb_net.kernel_weights()
        del pos, d, dirw, dens_plain
        path_shapes = (("density", feats, dens_w), ("rgb", rgb_in, rgb_w))

        # small and ragged first: a hang would show here
        worst = 0.0
        for name, x, w in path_shapes:
            for n in SMALL_ROWS:
                ref = fused_mlp_forward_plain(x[:n], w.layers)
                max_abs, _ = check_kernel(fused_mlp_forward(x[:n], w), ref,
                                          f"{name} x {n}")
                check_kernel(fused_mlp_forward(x[:n].to(torch.bfloat16), w),
                             ref, f"{name} x {n}, bf16 input")
                worst = max(worst, max_abs)
        print(f"kernel at {SMALL_ROWS} rows, both path shapes, f32 and "
              f"bf16 input: ok (max abs {worst:.3g})", flush=True)

        other = {}
        rng = np.random.default_rng(SEED + 2)
        for dims, act, out_act in OTHER_SHAPES:
            ws = [torch.from_numpy(rng.uniform(
                -np.sqrt(6.0 / (i + o)), np.sqrt(6.0 / (i + o)), (i, o))
                .astype(np.float32)).to(dev)
                for i, o in zip(dims[:-1], dims[1:])]
            w = pack_weights(ws)
            x = torch.from_numpy(rng.normal(size=(SMALL_ROWS[-1], dims[0]))
                                 .astype(np.float32)).to(dev)
            ref = fused_mlp_forward_plain(x, w.layers, act, out_act)
            max_abs, mean_abs = check_kernel(
                fused_mlp_forward(x, w, act, out_act), ref, str(dims))
            tag = "-".join(map(str, dims)) + f" {act}/{out_act}"
            other[tag] = {"variant": kernel_variant(dims, act, out_act),
                          "rows": x.shape[0], "max_abs_err": max_abs,
                          "mean_abs_err": mean_abs}
            print(f"kernel {tag} x {x.shape[0]} [{other[tag]['variant']}]: "
                  f"max abs {max_abs:.3g} mean abs {mean_abs:.3g}",
                  flush=True)

        shapes = {}
        for name, x_all, w in path_shapes:
            x = x_all[:N_ROWS]
            variant = kernel_variant(w.dims)
            if variant == GENERAL:
                raise RuntimeError(f"the {name} shape {w.dims} has no "
                                   f"instantiation of the mma kernel")
            ref = fused_mlp_forward_plain(x, w.layers)
            ref_mean = ref.abs().mean().item()
            if ref_mean < KERNEL_MIN_MEAN_ABS:
                raise RuntimeError(f"the {name} reference is too small "
                                   f"({ref_mean:.3g}) to check the kernel")
            max_abs, mean_abs = check_kernel(fused_mlp_forward(x, w), ref,
                                             f"{name} x {N_ROWS}")
            check_kernel(fused_mlp_forward(x, w, variant=GENERAL), ref,
                         f"{name} x {N_ROWS}, general kernel")
            # in turns: general, kernel, plain, kernel, general
            general_ms = [cuda_ms(lambda: fused_mlp_forward(
                x, w, variant=GENERAL))]
            ms = [cuda_ms(lambda: fused_mlp_forward(x, w))]
            plain_ms = cuda_ms(lambda: fused_mlp_forward_plain(x, w.layers))
            ms.append(cuda_ms(lambda: fused_mlp_forward(x, w)))
            general_ms.append(cuda_ms(lambda: fused_mlp_forward(
                x, w, variant=GENERAL)))
            ms, general_ms = min(ms), min(general_ms)
            bound_ms, bound_by = mlp_bound_ms(N_ROWS, w.dims, 4)
            by_rows = {}
            for n in OTHER_ROWS:
                xn = x_all[:n]
                by_rows[str(n)] = {
                    "ms": cuda_ms(lambda: fused_mlp_forward(xn, w)),
                    "general_ms": cuda_ms(lambda: fused_mlp_forward(
                        xn, w, variant=GENERAL)),
                    "bound_ms": mlp_bound_ms(n, w.dims, 4)[0]}
            # the input ring at each depth, and the same kernel without it
            # (an input that is not 16-byte aligned takes plain loads)
            ring = {str(k): cuda_ms(lambda: fused_mlp_forward(x, w, stages=k))
                    for k in (1, 2, 3, 4)}
            shifted = torch.empty(x.numel() + 1, device=dev)[1:].view_as(x)
            shifted.copy_(x)
            check_kernel(fused_mlp_forward(shifted, w), ref,
                         f"{name} x {N_ROWS}, unaligned input")
            no_ring_ms = cuda_ms(lambda: fused_mlp_forward(shifted, w))
            del shifted
            xb = x.to(torch.bfloat16)
            bf16_ms = cuda_ms(lambda: fused_mlp_forward(xb, w))
            del xb
            shapes[name] = {
                "dims": list(w.dims), "rows": N_ROWS, "variant": variant,
                "max_abs_err": max_abs, "mean_abs_err": mean_abs,
                "ref_max_abs": ref.abs().max().item(),
                "ref_mean_abs": ref_mean,
                "ms": ms, "general_ms": general_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms,
                "ms_by_rows": by_rows, "ms_by_ring_depth": ring,
                "ms_plain_loads": no_ring_ms, "ms_bf16_input": bf16_ms}
            print(f"kernel {name} {'-'.join(map(str, w.dims))} x {N_ROWS} "
                  f"[{variant}, ring of {MMA_STAGES}]: max abs {max_abs:.3g} "
                  f"mean abs {mean_abs:.3g} (ref max "
                  f"{shapes[name]['ref_max_abs']:.3g} mean {ref_mean:.3g}) | "
                  f"kernel {ms:.4f} ms, general kernel {general_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; {100 * bound_ms / ms:.1f} % reached) "
                  f"[{smi}]", flush=True)
            for n, r in by_rows.items():
                print(f"  x {n}: kernel {r['ms']:.4f} ms, general kernel "
                      f"{r['general_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms [{smi}]")
            print("  ring depth " + ", ".join(
                f"{k}: {v:.4f} ms" for k, v in ring.items())
                + f"; plain loads, no ring: {no_ring_ms:.4f} ms; bf16 "
                f"input: {bf16_ms:.4f} ms [{smi}]", flush=True)
            if not (ms < general_ms):
                raise RuntimeError(f"the mma kernel is not faster than the "
                                   f"general kernel at the {name} shape")
        # the RGB net of a capture with latent dims: 16 + 16 + 4 inputs
        # pad to 48, for which the mma kernel has no instantiation, so the
        # general kernel is this shape's path
        from instant_ngp_tpu_torch.ops.mlp import MLP

        latent_net = MLP.from_config(32 + CAPTURE_EXTRA_DIMS, 3,
                                     cfg["rgb_network"],
                                     compute_dtype=torch.bfloat16)
        latent_net.init_params(torch.Generator().manual_seed(SEED + 3))
        latent_net.to(dev)
        w = latent_net.kernel_weights()
        codes = 0.1 * torch.randn(N_ROWS, CAPTURE_EXTRA_DIMS, generator=gen)
        x = torch.cat([rgb_in[:N_ROWS], codes.to(dev)], -1).contiguous()
        variant = kernel_variant(w.dims)
        if variant != GENERAL:
            raise RuntimeError(f"the latent-dims shape {w.dims} was expected "
                               f"on the general path, not {variant}")
        shapes["rgb_latent"] = time_net("rgb_latent", w, x, ("ReLU", "None"),
                                        smi, min_mean=False)
        shapes["rgb_latent"]["general_ms"] = shapes["rgb_latent"]["ms"]
        # the nets of Volume and SDF mode (phases 13, 14): 32-64-64-4
        # ReLU/ReLU on its own instantiation, 32-64-64-1 and the Takikawa
        # net's 24-64-64-1 on the 32x64x8 ReLU/None one (24 inputs: the
        # ring by a tensor copy that zero-fills the padded columns)
        for name, dims, out_act in (("volume", [32, 64, 64, 4], "ReLU"),
                                    ("sdf", [32, 64, 64, 1], "None"),
                                    ("takikawa", [24, 64, 64, 1], "None")):
            ws = [torch.from_numpy(rng.uniform(
                -np.sqrt(6.0 / (i + o)), np.sqrt(6.0 / (i + o)), (i, o))
                .astype(np.float32)).to(dev)
                for i, o in zip(dims[:-1], dims[1:])]
            x_mode = feats[:, :dims[0]].contiguous()
            shapes[name] = check_mode_shape(name, x_mode, pack_weights(ws),
                                            "ReLU", out_act, smi)
            if dims[0] < 32:
                shapes[name]["input_paths"] = narrow_input_paths(
                    name, x_mode, pack_weights(ws), smi)
            del x_mode
        del feats, rgb_in, path_shapes, x, x_all, ref, latent_net, codes
        # the nets whose weights do not fit in shared memory at once:
        # configs/nerf/frequency.json's and none.json's, configs/sdf/
        # frequency.json's and oneblob.json's, on the streamed kernel
        wide = {name: check_net_shape(name, dims, rng, dev, smi,
                                      streamed=True)
                for name, dims in WIDE_NETS}
        # every other net of the configurations, beside its matmul chain
        config_nets = {name: check_net_shape(name, dims, rng, dev, smi,
                                             out_act=out_act)
                       for name, dims, out_act in CONFIG_NETS}
        torch.cuda.empty_cache()

    # phase 3b: the grid encode's kernels against their plain versions
    grid_rows = grid_kernels_on_card(dev, smi)
    # phase 3c: the march-and-pack kernel against its plain version
    march_row = march_kernel_on_card(dev, smi)
    torch.cuda.empty_cache()
    # phase 3d: the network round's RGB rows kernel against the plain round
    round_row = round_rows_on_card(dev, smi)
    torch.cuda.empty_cache()

    # phase 4: the main path, through the testbed's entry points; from here
    # on no plain grid method may run on a CUDA tensor, and every path
    # counts its grid and march launches from 0
    GridEncoding.plain_calls_on_cuda = 0
    kernel_paths = KernelPaths()
    cam = orbit_camera(angle=0.3, elevation=0.4)
    fused_mlp_forward.launches = 0
    fused_mlp_forward.launches_by_variant.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kernel_paths.run("density pass", tb.update_density_grid_full)
    torch.cuda.synchronize()
    density_s = time.perf_counter() - t0
    launches_density = fused_mlp_forward.launches
    by_variant_density = dict(fused_mlp_forward.launches_by_variant)
    occupied = int(np.unpackbits(tb.bitfield.cpu().numpy()).sum())
    frames = []
    for _ in range(2):   # a cold frame, then a warm one
        by_variant_before = dict(fused_mlp_forward.launches_by_variant)
        t0 = time.perf_counter()
        frame = kernel_paths.run("render", tb.render_frame, WIDTH, HEIGHT,
                               cam, focal_length=FOCAL)
        torch.cuda.synchronize()
        frames.append((time.perf_counter() - t0, tb.last_frame_n_samples))
    launches = fused_mlp_forward.launches
    by_variant = dict(fused_mlp_forward.launches_by_variant)
    # the two shapes of the pinhole, LDR paths (phases 4 and 6), each on
    # its instantiation of the mma kernel
    main_shapes = {k: shapes[k] for k in ("density", "rgb")}
    main_variants = {k: v["variant"] for k, v in main_shapes.items()}
    for shape in main_shapes.values():
        v = shape["variant"]
        shape["launches_per_frame"] = (by_variant.get(v, 0)
                                       - by_variant_before.get(v, 0))
        shape["launches_per_density_pass"] = by_variant_density.get(v, 0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"density pass: {tb.density_grid.numel()} cells in "
          f"{density_s:.3f} s, {occupied} occupied bits, "
          f"{launches_density} kernel launches [{smi}]")
    for tag, (sec, n) in zip(("cold", "warm"), frames):
        print(f"frame {WIDTH}x{HEIGHT} ({tag}): {sec:.3f} s, {n} samples, "
              f"{n / sec:.4g} samples/s [{smi}]")
    print(f"main path: {launches} kernel launches {by_variant}, peak "
          f"{peak_gib:.2f} GiB allocated", flush=True)
    if launches_density == 0 or launches <= launches_density:
        raise RuntimeError("the main path did not launch fused_mlp_forward "
                           "in both phases")
    check_variants(by_variant, main_variants, "the render path")
    if any(s["launches_per_frame"] == 0 for s in main_shapes.values()) \
            or shapes["density"]["launches_per_density_pass"] == 0:
        raise RuntimeError("a frame or the density pass did not launch the "
                           "mma kernel's instantiation for its shape")
    if frame.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(frame).all():
        raise RuntimeError("the frame is not finite or has the wrong shape")
    if frames[-1][1] <= 0 or frame[..., 3].max() <= 0.0:
        raise RuntimeError("the frame evaluated no samples")
    # each network call of a round writes its RGB rows by one launch: as
    # many as the density net's
    density_calls = shapes["density"]["launches_per_frame"]
    rows_launches = kernel_paths.by_path["render"].get("rgb_net_rows", 0)
    if rows_launches != 2 * density_calls:
        raise RuntimeError(f"the render path launched the RGB rows kernel "
                           f"{rows_launches} times in two frames, not once "
                           f"per network call ({density_calls} a frame)")

    # phase 5: the same testbed on the CPU, through the plain versions
    cpu_tb = NerfTestbed(scene, cfg, device="cpu",
                         compute_dtype=torch.bfloat16, seed=SEED)
    cpu_tb.load_params(params)
    cpu_tb.density_grid = tb.density_grid.cpu()
    cpu_tb.bitfield = tb.bitfield.cpu()
    small = (48, 48)
    focal_small = FOCAL * small[0] / WIDTH
    ours = tb.render_frame(*small, cam, focal_length=focal_small)
    ref = cpu_tb.render_frame(*small, cam, focal_length=focal_small)
    err = np.abs(ours - ref)
    print(f"frame {small[0]}x{small[1]} card vs CPU: max abs "
          f"{err.max():.3g}, mean abs {err.mean():.3g}")
    if not (err.max() <= FRAME_MAX_ABS and err.mean() <= FRAME_MEAN_ABS):
        raise RuntimeError("the card's frame disagrees with the CPU's")
    off = [w.copy() for w in params["density_net"]]
    off[-1] = off[-1] * 0.5
    cpu_tb.load_params(dict(params, density_net=off))
    moved = np.abs(cpu_tb.render_frame(*small, cam, focal_length=focal_small)
                   - ref).mean()
    print(f"frame {small[0]}x{small[1]} with the density net's output "
          f"layer halved: mean abs change {moved:.3g}")
    if moved < FRAME_SENSITIVITY * FRAME_MEAN_ABS:
        raise RuntimeError("the frame comparison cannot see a wrong "
                           "density network")

    # phases 6 to 8: training
    t0 = time.perf_counter()
    ds = make_scene()
    print(f"scene: {ds.n_images} views of {ds.images[0].shape[1]}x"
          f"{ds.images[0].shape[0]} raytraced in "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    train_tb, by_variant_train, by_variant_phase6 = kernel_paths.run(
        "train default", train_on_card, ds, cfg, dev, smi, fused_mlp_forward,
        "default")
    exact_tb, _, _ = kernel_paths.run("train exact", train_on_card, ds, cfg,
                                    dev, smi, fused_mlp_forward, "exact")
    t_new = time.perf_counter()
    repeat = repeatable_training(ds, cfg, dev, smi)
    sweep = determinism_sweep(ds, dev, smi)
    print(f"phases 6b-6c (repeat, determinism sweep): "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    launches_train = sum(by_variant_train.values())
    check_variants(by_variant_phase6, main_variants, "the training path")
    train_aabb4(ds, cfg, dev, smi)
    for shape in main_shapes.values():
        shape["launches_per_128_train_steps"] = by_variant_train.get(
            shape["variant"], 0)
    card_against_cpu(cfg, dev)
    for interval in POSE_INTERVALS:
        pose_recovery(cfg, dev, smi, interval)

    if args.profile:
        profile_frame(tb, cam, smi, args.profile)
        profile_training(train_tb, smi, args.profile)
        profile_training(exact_tb, smi, args.profile)
    del exact_tb

    # phase 9: a capture from disk; its RGB net has latent dims and takes
    # the general kernel, its density net the mma kernel as before
    by_variant_capture, mode_times = kernel_paths.run(
        "capture", capture_from_disk, cfg, dev, smi, fused_mlp_forward,
        {"density": shapes["density"]["variant"],
         "rgb_latent": shapes["rgb_latent"]["variant"]}, args.profile)
    launches_capture = sum(by_variant_capture.values())
    if kernel_paths.by_path["capture"].get("rgb_net_rows", 0):
        raise RuntimeError("the capture's RGB net has latent dims: its "
                           "rounds must not launch the RGB rows kernel")
    for name in ("density", "rgb_latent"):
        shapes[name]["launches_on_the_capture_path"] = \
            by_variant_capture[shapes[name]["variant"]]
    shapes["rgb_latent"]["frames_400x400_by_mode"] = mode_times

    # phase 10: Image mode at configs/image/base.json's width; its net is
    # 32-64-64-3 like the NeRF RGB net and takes the same instantiation
    image_cfg = load_network_config(find_network_config("base", "image"))
    by_variant_image, image_path = kernel_paths.run(
        "image", image_mode, image_cfg, dev, smi, fused_mlp_forward,
        shapes["rgb"]["variant"], args.profile)
    launches_image = sum(by_variant_image.values())
    image_card_against_cpu(image_cfg, dev)
    rows = image_path["rows_per_frame"]
    image_path.update(
        variant=shapes["rgb"]["variant"],
        bound_ms_per_frame=mlp_bound_ms(rows, shapes["rgb"]["dims"], 4)[0],
        kernel_ms_per_chunk=shapes["rgb"]["ms_by_rows"][str(1 << 21)]["ms"],
        bound_ms_per_chunk=mlp_bound_ms(1 << 21, shapes["rgb"]["dims"],
                                        4)[0])
    shapes["rgb"]["image_path"] = image_path

    # phase 11: the mesh tools and FLIP on phase 6's trained model
    by_variant_mesh, mesh_path = mesh_and_flip(
        train_tb, smi, fused_mlp_forward, main_variants)
    launches_mesh = sum(by_variant_mesh.values())
    for shape in main_shapes.values():
        shape["launches_on_the_mesh_path"] = by_variant_mesh[
            shape["variant"]]

    # phase 12: the trained model through the f-theta, latlong and
    # equirectangular lenses and an aperture, card against CPU
    t_new = time.perf_counter()
    trained_nerf_lenses(train_tb, cfg, dev, smi)

    # phase 13: Volume mode at configs/volume/base.json's width; its net
    # takes the mma kernel's ReLU/ReLU instantiation
    volume_cfg = load_network_config(find_network_config("base", "volume"))
    by_variant_volume, volume_path = kernel_paths.run(
        "volume", volume_mode, volume_cfg, dev, smi, fused_mlp_forward,
        shapes["volume"]["variant"], args.profile)
    launches_volume = sum(by_variant_volume.values())
    volume_card_against_cpu(volume_cfg, dev, fused_mlp_forward)
    shapes["volume"]["volume_path"] = volume_path

    # phase 14: SDF mode at configs/sdf/base.json's and takikawa.json's
    # widths; both nets take the 32x64x8 ReLU/None instantiation
    sdf_cfgs = {name: load_network_config(find_network_config(name, "sdf"))
                for name in ("base", "takikawa")}
    by_variant_sdf, sdf_path = kernel_paths.run(
        "sdf", sdf_mode, sdf_cfgs, dev, smi, fused_mlp_forward,
        shapes["sdf"]["variant"], args.profile)
    launches_sdf = sum(by_variant_sdf.values())
    sdf_card_against_cpu(sdf_cfgs["base"], dev, fused_mlp_forward)
    shapes["sdf"]["sdf_path"] = sdf_path.get("base")
    shapes["takikawa"]["sdf_path"] = sdf_path.get("takikawa")
    print(f"phases 12-14 (lenses, Volume, SDF): "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)

    # phase 15: Geometry mode, the scene of a mesh, a box and phase 6's
    # model through a .ingp of the port's codec; the NeRF object's nets
    # take the density and RGB instantiations
    import shutil
    import tempfile

    t_new = time.perf_counter()
    work = tempfile.mkdtemp(prefix="geometry_")
    try:
        by_variant_geometry, geometry_path = kernel_paths.run(
            "geometry", geometry_mode, work, train_tb, dev, smi,
            fused_mlp_forward, tuple(main_variants.values()))
        launches_geometry = sum(by_variant_geometry.values())
        del train_tb
        torch.cuda.empty_cache()
        # phase 16: the wide nets train and render on the streamed kernel;
        # the command line on the card
        by_variant_wide, wide_path = wide_nets_and_cli(
            work, ds, dev, smi, fused_mlp_forward)
        launches_wide = sum(by_variant_wide.values())
    finally:
        shutil.rmtree(work)
    print(f"phases 15-16 (Geometry, wide nets, CLI): "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)

    # phase 17: data- and level-parallel NeRF at base.json's width: a
    # 1-rank NCCL mesh, then two gloo ranks sharing the card
    t_new = time.perf_counter()
    sharded_path = sharded_on_card(ds, cfg, dev, smi, fused_mlp_forward)
    launches_sharded = (sharded_path["launches_density_updates"]
                        + sharded_path["launches_render"])
    sharded_path.update(two_ranks_on_card(ds, cfg, smi))
    print(f"phase 17 (mesh, two ranks): {time.perf_counter() - t_new:.1f} s",
          flush=True)

    if args.curve:
        train_curve(ds, cfg, dev, smi)

    # the grid kernels on the main paths: every path launched them, and no
    # plain grid method ran on a CUDA tensor anywhere since phase 4
    grid_keys = {
        "grid_encode_forward": ("encode_forward[exact]",),
        "grid_encode_forward[stochastic]": ("encode_forward[stochastic]",),
        "grid_table_gradient": ("table_gradient[exact]",),
        "grid_table_gradient[stochastic]": ("table_gradient[one_corner]",
                                            "table_gradient[fetched]"),
        "grid_input_gradient": ("input_gradient[exact]",)}
    replaces = {"grid_encode_forward": 329, "grid_table_gradient": 329,
                "grid_input_gradient": 329,
                "grid_encode_forward[stochastic]": 817,
                "grid_table_gradient[stochastic]": 817}
    print(f"grid kernel launches by path: {kernel_paths.by_path}; plain grid "
          f"calls on CUDA tensors: {GridEncoding.plain_calls_on_cuda}",
          flush=True)
    if GridEncoding.plain_calls_on_cuda != 0:
        raise RuntimeError(f"{GridEncoding.plain_calls_on_cuda} plain grid "
                           f"calls on CUDA tensors on the main paths")
    every_grid_key = [k for keys in grid_keys.values() for k in keys]
    for path in GRID_PATHS:
        if not sum(kernel_paths.by_path.get(path, {}).get(k, 0)
                   for k in every_grid_key):
            raise RuntimeError(f"the {path} path launched no grid kernel")
    for name, keys in grid_keys.items():
        if kernel_paths.total(*keys) == 0:
            raise RuntimeError(f"{name} was launched on no main path")
    # the frames of the wavefront renderer march on the kernel
    for path in MARCH_PATHS:
        if not kernel_paths.by_path.get(path, {}).get("march_and_pack"):
            raise RuntimeError(f"the {path} path launched no march kernel")
    grid_entries = [{
        "name": name,
        "route": "cuda",
        "source": "instant_ngp_tpu_torch/csrc/grid_encoding.cu",
        "replaces": f"instant_ngp_tpu/ops/grid_encoding.py:{replaces[name]}",
        # on GRID_PATHS, each counted from 0 (a table-gradient launch is
        # its radix sort's passes and its sum, one wrapper call)
        "launches": kernel_paths.total(*keys),
        "launches_by_path": {path: sum(c.get(k, 0) for k in keys)
                             for path, c in kernel_paths.by_path.items()},
        **{k: grid_rows[name][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        # no PyTorch call computes a grid encode; the deposits' rows and
        # values summed by one index_put_ call, for the table gradient
        "library_ms": grid_rows[name].get("library_ms"),
        **{k: grid_rows[name][k] for k in (
            "ref_max_abs", "variant", "points", "bytes_moved",
            "bytes_gathered", "share_of_bound", "bit_equal_to_plain")},
    } for name, keys in grid_keys.items()]
    march_entry = {
        "name": "march_and_pack",
        "route": "cuda",
        "source": "instant_ngp_tpu_torch/csrc/nerf_march.cu",
        # no TPU kernel: the JAX package marches with plain XLA
        "replaces": None,
        "counterpart": "instant_ngp_tpu/nerf/sampler.py:213 (plain XLA)",
        # every path, each counted from 0: a launch marches a frame's
        # tile of rays
        "launches": kernel_paths.total("march_and_pack"),
        "launches_by_path": {
            path: c["march_and_pack"]
            for path, c in kernel_paths.by_path.items()
            if c.get("march_and_pack")},
        # no one PyTorch call marches a ray
        "library_ms": None,
        **march_row}
    round_entry = {
        "name": "rgb_net_rows",
        "route": "cuda",
        "source": "instant_ngp_tpu_torch/csrc/nerf_network_round.cu",
        # no TPU kernel: the JAX package builds the RGB net's input with
        # plain XLA
        "replaces": None,
        "counterpart": "instant_ngp_tpu/nerf/model.py:111 (plain XLA)",
        # every path, each counted from 0: a launch writes one network
        # call's rows of a wavefront round
        "launches": kernel_paths.total("rgb_net_rows"),
        "launches_by_path": {
            path: c["rgb_net_rows"]
            for path, c in kernel_paths.by_path.items()
            if c.get("rgb_net_rows")},
        # no one PyTorch call writes these rows
        "library_ms": None,
        **round_row}

    kernels = [{
        "name": "fused_mlp_forward",
        "route": "cuda",
        "source": "instant_ngp_tpu_torch/csrc/fused_mlp_mma.cu",
        "replaces": "instant_ngp_tpu/ops/pallas/mlp_kernels.py:31",
        # the main paths, each counted from 0: the render path (a density
        # pass and two frames), 128 training steps, the capture's path
        # (128 steps, a frame per render mode, the eval), Image mode (512
        # steps, three PSNR renders and two 4096x4096 frames), the mesh
        # (extraction at 256^3; its optimisation launches nothing), Volume
        # mode (training, a fixed batch's loss, three frames) and SDF mode
        # (both configurations: training, IoU, frames, the brick oracle
        # launches nothing), Geometry mode and the 1-rank mesh (its sharded
        # density updates and its sharded 400x400 frame)
        "launches": launches + launches_train + launches_capture
        + launches_image + launches_mesh + launches_volume + launches_sdf
        + launches_geometry + launches_sharded,
        "launches_render_path": launches,
        "launches_train_path": launches_train,
        "launches_capture_path": launches_capture,
        "launches_image_path": launches_image,
        "launches_mesh_path": launches_mesh,
        "launches_volume_path": launches_volume,
        "launches_sdf_path": launches_sdf,
        "launches_geometry_path": launches_geometry,
        "launches_sharded_path": launches_sharded,
        # which paths launch each instantiation (and the general kernel)
        "instantiations": {
            shapes["density"]["variant"]: [
                "render", "train (density updates, frames)", "capture",
                "mesh", "geometry", "sharded density update",
                "sharded render"],
            shapes["rgb"]["variant"]: ["render", "train (frames)", "image",
                                       "mesh", "sdf (base and Takikawa)",
                                       "geometry", "sharded render"],
            shapes["volume"]["variant"]: ["volume"],
            shapes["rgb_latent"]["variant"]: ["capture (RGB net with "
                                              "latent dims)"]},
        "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
        # one network evaluation of N_ROWS samples of the pinhole paths:
        # both MLPs (the latent-dims RGB shape has its own numbers under
        # "shapes")
        "ms": sum(s["ms"] for s in main_shapes.values()),
        "plain_ms": sum(s["plain_ms"] for s in main_shapes.values()),
        "bound_ms": sum(s["bound_ms"] for s in main_shapes.values()),
        "bound_by": "bytes" if all(s["bound_by"] == "bytes"
                                   for s in main_shapes.values())
        else "operations",
        # no one PyTorch call computes a fused multi-layer MLP
        "library_ms": None,
        "general_ms": sum(s["general_ms"] for s in main_shapes.values()),
        "shapes": shapes,
        "mesh_path": mesh_path,
        "geometry_path": geometry_path,
        # phases 6b-6c: what the kernel's path trains repeats bit for bit
        "train_repeat": repeat,
        "determinism_sweep": sweep,
        "sharded_path": sharded_path,
        "config_nets": config_nets,
        "other_shapes": other,
    }, {
        # the general path of the same TPU kernel (csrc/fused_mlp_wgmma.cu,
        # whose plan keeps these nets' weights resident): every net
        # without an instantiation whose weights pass the general rule;
        # its path is phase 9's RGB net of a capture with latent dims,
        # counted from 0 over the phase
        "name": "fused_mlp_forward[general]",
        "route": "cuda",
        "source": "instant_ngp_tpu_torch/csrc/fused_mlp_wgmma.cu",
        "replaces": "instant_ngp_tpu/ops/pallas/mlp_kernels.py:31",
        "launches": by_variant_capture.get(GENERAL, 0),
        "max_abs_err": max(shapes["rgb_latent"]["max_abs_err"],
                           config_nets["image_frequency_oneblob"]
                           ["max_abs_err"]),
        # the capture's RGB net 36-64-64-3 at N_ROWS rows; configs/image/
        # frequency.json's and oneblob.json's 64-64-64-3 under "shapes"
        "ms": shapes["rgb_latent"]["ms"],
        "plain_ms": shapes["rgb_latent"]["plain_ms"],
        "bound_ms": shapes["rgb_latent"]["bound_ms"],
        "bound_by": shapes["rgb_latent"]["bound_by"],
        # no one PyTorch call computes it; the chain of bf16 matmul and
        # ReLU calls is the yardstick
        "library_ms": None,
        "chain_ms": shapes["rgb_latent"]["chain_ms"],
        "shapes": {"rgb_latent": shapes["rgb_latent"],
                   "image_frequency_oneblob":
                       config_nets["image_frequency_oneblob"]},
    }, {
        # the streamed path of the same kernel: its launches for the nets
        # outside the general rule, whether the kernel's plan streams
        # their weights (the deep nets) or keeps them resident (the
        # 1-hidden-layer RGB nets; the plan is printed in phase 3); its path is
        # phase 16's
        # (configs/nerf/frequency.json trained and rendered, configs/sdf/
        # frequency.json and oneblob.json rendered), counted from 0
        "name": "fused_mlp_forward[streamed]",
        "route": "cuda",
        "source": "instant_ngp_tpu_torch/csrc/fused_mlp_wgmma.cu",
        "replaces": "instant_ngp_tpu/ops/pallas/mlp_kernels.py:31",
        "launches": launches_wide,
        "max_abs_err": max(s["max_abs_err"] for s in wide.values()),
        # configs/nerf/frequency.json's density net at N_ROWS rows, the
        # widest of the path; every net has its row under "shapes"
        "ms": wide["nerf_frequency_density"]["ms"],
        "plain_ms": wide["nerf_frequency_density"]["plain_ms"],
        "bound_ms": wide["nerf_frequency_density"]["bound_ms"],
        "bound_by": wide["nerf_frequency_density"]["bound_by"],
        # no one PyTorch call computes it; the chain of bf16 matmul and
        # ReLU calls is the yardstick
        "library_ms": None,
        "chain_ms": wide["nerf_frequency_density"]["chain_ms"],
        "shapes": wide,
        "wide_path": wide_path,
    }] + grid_entries + [march_entry, round_entry]
    print(json.dumps({"kernels": kernels}))
    print(smi)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
