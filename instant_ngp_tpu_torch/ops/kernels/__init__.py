"""Kernel wrappers written for Hopper, each beside its plain PyTorch version.

A wrapper runs its plain version for a tensor on the CPU and launches its
kernel for a CUDA tensor (or raises); it never falls back from one to the
other. (The grid encode's, the march's and the RGB rows' wrappers take
CUDA tensors only: the methods of `ops/grid_encoding.py::GridEncoding` and
of `nerf/render.py` that call them make that choice.) Sources live in
`instant_ngp_tpu_torch/csrc/` and are compiled by `_build.py` on first use.
"""
