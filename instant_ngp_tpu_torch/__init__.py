"""instant_ngp_tpu_torch: the PyTorch/CUDA port of instant_ngp_tpu.

Module names mirror the JAX package (`instant_ngp_tpu`), which stays the
reference each module is held against by the `tests/test_torch_*.py`
tests. The port imports torch and numpy only, never jax or the JAX
package. Kernels written for Hopper live under `csrc/` and are built on
first use by `ops/kernels/_build.py`.

Ported so far: NeRF mode (`nerf/testbed_nerf.py`: training, rendering,
meshes), and Image, Volume and SDF mode (`image/testbed_image.py`,
`volume/testbed_volume.py`, `sdf/testbed_sdf.py`) on the shared trainer
base (`ops/trainer.py`), with the fused MLP forward at inference as a CUDA
kernel (`ops/kernels/mlp_kernels.py`). SDF mode's triangle BVH is host
C++ (`csrc/triangle_bvh.cpp`), built with g++ on first use.
"""
