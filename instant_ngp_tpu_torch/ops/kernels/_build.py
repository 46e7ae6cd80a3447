"""Build the CUDA sources under `instant_ngp_tpu_torch/csrc/` with nvcc into
one shared library with a plain C interface, and load it with ctypes.

Each source is compiled by its own nvcc process, all started together, and
the objects are linked into one library. It goes to
`build/instant_ngp_tpu_torch/<hash>/` under the repository root, keyed by a
hash of the sources and flags, so an edit rebuilds. A failed build raises
with nvcc's output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "instant_ngp_tpu_torch"
LIB_NAME = "libinstant_ngp_tpu_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless this exact build exists; return the
    library's path. The compiler's log is kept beside it as build.log."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objects = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for obj, src in zip(objects, _sources())]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    codes = [proc.returncode for proc in procs]
    if not any(codes):
        cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                     *map(str, objects)])
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        outputs.append(link.stdout + link.stderr)
        codes.append(link.returncode)
    for obj in objects:
        obj.unlink(missing_ok=True)
    log = "".join(f"{' '.join(cmd)}\n{out}"
                  for cmd, out in zip(cmds, outputs))
    if any(codes):
        raise RuntimeError(f"nvcc failed ({codes}):\n{log}")
    (out_dir / "build.log").write_text(
        f"{log}{time.perf_counter() - t0:.1f} s\n")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dims = ctypes.POINTER(ctypes.c_int)
    # (x, x_is_bf16, w, w_elems, out, n_rows, n_layers, dims, hidden_act,
    #  out_act[, n_stages], stream)
    lib.fused_mlp_forward_launch.argtypes = [
        ptr, i32, ptr, i32, ptr, i32, i32, dims, i32, i32, ptr]
    lib.fused_mlp_mma_launch.argtypes = [
        ptr, i32, ptr, i32, ptr, i32, i32, dims, i32, i32, i32, ptr]
    lib.fused_mlp_mma_has_variant.argtypes = [i32, dims, i32, i32]
    for fn in (lib.fused_mlp_forward_launch, lib.fused_mlp_mma_launch,
               lib.fused_mlp_mma_has_variant):
        fn.restype = ctypes.c_int
    return lib
