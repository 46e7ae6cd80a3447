"""Build the CUDA sources under `instant_ngp_tpu_torch/csrc/` with nvcc into
one shared library with a plain C interface, and load it with ctypes; and
build the host C++ sources there (`*.cpp`: the triangle BVH) with g++.

Each CUDA source is compiled by its own nvcc process, all started
together, and the objects are linked into one library. It goes to
`build/instant_ngp_tpu_torch/<hash>/` under the repository root, keyed by a
hash of the sources and flags, so an edit rebuilds. A host library goes to
a directory keyed the same way by its own source and flags, and needs g++
only. A failed build raises with the compiler's output. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
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


#: the flags of native/Makefile, so the port's copy of a host source gives
#: the same bits as the JAX package's build of it
HOST_CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]


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


def _host_cpu() -> bytes:
    """What -march=native compiles for: the machine and, where Linux says,
    the CPU's model and flags (a checkout copied to another host rebuilds)."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            ident += "".join(sorted({line for line in f if line.startswith(
                ("model name", "flags"))}))
    except OSError:
        pass
    return ident.encode()


def build_host_library(source: str) -> Path:
    """Compile `csrc/<source>` (C++ for the host) with g++ into a shared
    library unless this exact build exists for this CPU; return its
    path."""
    src = CSRC_DIR / source
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update(_host_cpu())
    h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{src.stem}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
    cmd = [shutil.which("g++") or "g++", *HOST_CXX_FLAGS, str(src),
           "-shared", "-lpthread", "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dims = ctypes.POINTER(ctypes.c_int)
    # (x, x_is_bf16, w, w_elems or w_bytes, out, n_rows, n_layers, dims,
    #  hidden_act, out_act, [n_stages,] stream)
    lib.fused_mlp_mma_launch.argtypes = [
        ptr, i32, ptr, i32, ptr, i32, i32, dims, i32, i32, i32, ptr]
    lib.fused_mlp_wgmma_launch.argtypes = [
        ptr, i32, ptr, ctypes.c_longlong, ptr, i32, i32, dims, i32, i32, ptr]
    # (n_layers, dims, x_is_bf16, aligned, out[4])
    lib.fused_mlp_wgmma_plan.argtypes = [i32, dims, i32, i32, dims]
    lib.fused_mlp_mma_has_variant.argtypes = [i32, dims, i32, i32]
    # (d_in, in_p, elem_bytes, aligned)
    lib.fused_mlp_mma_input_path.argtypes = [i32, i32, i32, i32]
    # the grid encode (csrc/grid_encoding.cu): (ints, scales, ...)
    i64, f32s = ctypes.c_longlong, ctypes.POINTER(ctypes.c_float)
    # (x, table, u, axis, out, n, active, j, stream)
    lib.grid_forward_launch.argtypes = [
        dims, f32s, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
    # (n_dims, n, active, mode, j)
    lib.grid_deposit_count.argtypes = [i32, i64, i32, i32, i32]
    lib.grid_deposit_count.restype = i64
    # (n_dims, n_features, n_entries, n, active, mode, j, out[5])
    lib.grid_deposit_scratch.argtypes = [i32, i32, i64, i64, i32, i32, i32,
                                         ctypes.POINTER(ctypes.c_longlong)]
    lib.grid_deposit_scratch.restype = None
    # (x, u, axis, grad_out, records, counts, totals, keys 0, perm 0,
    #  keys 1, perm 1, n_valid, grad, n_entries, n, active, mode, j, stream)
    lib.grid_table_gradient_launch.argtypes = [
        dims, f32s, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr, ptr, i64, i64, i32, i32, i32, ptr]
    # (x, table, grad_out, grad_x, n, active, stream)
    lib.grid_input_gradient_launch.argtypes = [
        dims, f32s, ptr, ptr, ptr, ptr, i64, i32, ptr]
    # the wavefront march (csrc/nerf_march.cu): (origins, dirs, bitfield,
    #  aabb_min, aabb_max, consts, cone, max_mip, n_march, max_samples,
    #  n_cols, chunk, n_rays, ts, ok, n_cand, valid, stream)
    lib.nerf_march_pack_launch.argtypes = [ptr] * 5 + [f32s] + [i32] * 6 + [
        i64] + [ptr] * 5
    for fn in (lib.fused_mlp_mma_launch, lib.fused_mlp_wgmma_launch,
               lib.fused_mlp_wgmma_plan, lib.fused_mlp_mma_has_variant,
               lib.fused_mlp_mma_input_path, lib.grid_forward_launch,
               lib.grid_table_gradient_launch,
               lib.grid_input_gradient_launch, lib.nerf_march_pack_launch):
        fn.restype = ctypes.c_int
    return lib
