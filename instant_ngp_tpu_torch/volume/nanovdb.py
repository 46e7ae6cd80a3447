"""Minimal NanoVDB FloatGrid reader/writer (no OpenVDB dependency), numpy
only (counterpart of instant_ngp_tpu/volume/nanovdb.py, byte for byte: a
file written by one package reads identically in the other).

The original instant-ngp loads `.nvdb` files and samples them through the
NanoVDB CUDA accessor (testbed_volume.cu:572-650, load_volume). Here the
sparse tree is decoded ONCE on the host into a dense index-space array
over the grid's indexBBox, which `VolumeTestbed` moves to the device and
samples by gathers.

Layout follows NanoVDB ABI 32.3 (the version the reference vendors:
dependencies/nanovdb/nanovdb/NanoVDB.h):

- file header (16B) + per-grid metadata (176B) + name
  (testbed_volume.cu:545-570 documents this exact framing)
- GridData 672B: magic, checksum, version, flags, gridIndex, gridCount,
  gridSize, name[256], Map (264B), worldBBox (6d), voxelSize (3d),
  gridClass, gridType, blindMetadataOffset, blindMetadataCount
- TreeData 64B: nodeOffset[4] (byte offsets from tree start to first
  leaf/lower/upper/root), nodeCount[3], tileCount[3], voxelCount
- RootData 64B: index bbox (6i), tableSize, background/min/max/avg/std,
  then `tableSize` tiles of 32B: key (u64: x>>12 in bits 42+, y>>12 in
  21..41, z>>12 in 0..20), child byte-offset (relative to root, 0 =>
  constant tile), state, value
- Upper node 270400B (32^3): bbox, flags, valueMask(4096B),
  childMask(4096B), min/max/avg/std, 32768 x 8B tile union (child
  offsets relative to the upper node)
- Lower node 33856B (16^3): same shape with 512B masks and 4096 tiles
- Leaf 2144B (8^3): bboxMin(3i), bboxDif(3B), flags(1B),
  valueMask(64B), min/max/avg/std, 512 float values

Traversal indices n = (x << 2*LOG2DIM) | (y << LOG2DIM) | z with x/y/z
the node-local coordinates (NanoVDB.h CoordToOffset).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0" little-endian
GRID_TYPE_FLOAT = 1
GRID_CLASS_FOG = 2

GRID_DATA_SIZE = 672
TREE_DATA_SIZE = 64
ROOT_DATA_SIZE = 64
ROOT_TILE_SIZE = 32
UPPER_SIZE = 8256 + 32768 * 8
LOWER_SIZE = 1088 + 4096 * 8
LEAF_SIZE = 96 + 512 * 4
# field offsets within internal nodes: bbox(24) flags(8) masks stats table
UPPER_VMASK, UPPER_CMASK, UPPER_TABLE = 32, 32 + 4096, 8256
LOWER_VMASK, LOWER_CMASK, LOWER_TABLE = 32, 32 + 512, 1088
LEAF_VALUES = 96


def _mask_bits(buf: np.ndarray, off: int, nbits: int) -> np.ndarray:
    """Bool array of a NanoVDB Mask<LOG2DIM> (u64 words, LSB-first)."""
    words = buf[off:off + nbits // 8]
    return np.unpackbits(words, bitorder="little").astype(bool)


def _key_to_coord(key: int) -> np.ndarray:
    mask21 = (1 << 21) - 1
    xyz = np.array([(key >> 42) & mask21, (key >> 21) & mask21,
                    key & mask21], np.uint64)
    return (np.uint32(xyz) << np.uint32(12)).astype(np.int32)


def _coord_to_key(ijk) -> int:
    x, y, z = (np.uint32(v) for v in ijk)
    return (int(z >> np.uint32(12))
            | (int(y >> np.uint32(12)) << 21)
            | (int(x >> np.uint32(12)) << 42))


def read_nanovdb_dense(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Decode the first FloatGrid of a .nvdb file into a dense (X, Y, Z)
    float32 array over its indexBBox. Returns (dense, meta)."""
    from .testbed_volume import load_nanovdb_header

    meta = load_nanovdb_header(path)
    if meta["grid_type"] != GRID_TYPE_FLOAT:
        raise ValueError(f"only FloatGrid supported, got {meta['grid_type']}")
    with open(path, "rb") as f:
        f.seek(meta["data_offset"])
        grid = np.frombuffer(f.read(meta["grid_size"]), np.uint8)

    bbmin, bbmax = meta["index_bbox"]
    shape = np.maximum(bbmax - bbmin, 1)
    tree = GRID_DATA_SIZE
    root = tree + int(np.frombuffer(grid, np.uint64, 1, tree + 24)[0])

    background, = np.frombuffer(grid, np.float32, 1, root + 28)
    dense = np.full(shape, background, np.float32)
    n_tiles, = np.frombuffer(grid, np.uint32, 1, root + 24)

    def fill(org, side, value):
        """Write a constant `side`^3 region (clipped to bbox)."""
        lo = np.maximum(org - bbmin, 0)
        hi = np.minimum(org + side - bbmin, shape)
        if (hi > lo).all():
            dense[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = value

    def read_leaf(off, org):
        vals = np.frombuffer(grid, np.float32, 512, off + LEAF_VALUES)
        lo = np.maximum(org - bbmin, 0)
        hi = np.minimum(org + 8 - bbmin, shape)
        if (hi <= lo).any():
            return
        block = vals.reshape(8, 8, 8)  # (x, y, z) per CoordToOffset
        s = lo - (org - bbmin)  # clip inside the 8^3 block
        e = s + (hi - lo)
        dense[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = \
            block[s[0]:e[0], s[1]:e[1], s[2]:e[2]]

    def read_internal(off, org, log2dim, child_total, vmask_o, cmask_o,
                      table_o, read_child):
        dim = 1 << log2dim
        n = dim ** 3
        child_mask = _mask_bits(grid, off + cmask_o, n)[:n]
        table_u = np.frombuffer(grid, np.int64, n, off + table_o)
        table_f = np.frombuffer(grid, np.float32, 2 * n, off + table_o)[::2]
        idx = np.arange(n)
        x = idx >> (2 * log2dim)
        y = (idx >> log2dim) & (dim - 1)
        z = idx & (dim - 1)
        child_side = 1 << child_total
        origins = org[None, :] + np.stack([x, y, z], -1) * child_side
        # constant tiles: batch non-background fills
        const = ~child_mask & (table_f != background)
        for i in np.nonzero(const)[0]:
            fill(origins[i], child_side, table_f[i])
        for i in np.nonzero(child_mask)[0]:
            read_child(off + int(table_u[i]), origins[i])

    def read_lower(off, org):
        read_internal(off, org, 4, 3, LOWER_VMASK, LOWER_CMASK,
                      LOWER_TABLE, read_leaf)

    def read_upper(off, org):
        read_internal(off, org, 5, 7, UPPER_VMASK, UPPER_CMASK,
                      UPPER_TABLE, read_lower)

    for t in range(int(n_tiles)):
        toff = root + ROOT_DATA_SIZE + t * ROOT_TILE_SIZE
        key, = np.frombuffer(grid, np.uint64, 1, toff)
        child, = np.frombuffer(grid, np.int64, 1, toff + 8)
        org = _key_to_coord(int(key))
        if child == 0:
            value, = np.frombuffer(grid, np.float32, 1, toff + 20)
            if value != background:
                fill(org, 1 << 12, value)
        else:
            read_upper(root + int(child), org)

    meta = dict(meta)
    meta["background"] = float(background)
    return dense, meta


def write_nanovdb(path: str, dense: np.ndarray,
                  origin=(0, 0, 0), voxel_size: float = 1.0,
                  background: float = 0.0, name: str = "density",
                  grid_class: int = GRID_CLASS_FOG) -> None:
    """Write a dense float32 array as a single-FloatGrid .nvdb file
    (ABI 32.3, uncompressed codec) readable by the reference's
    load_volume and by `read_nanovdb_dense`. Leaves that are entirely
    background are stored as constant tiles (sparse)."""
    dense = np.asarray(dense, np.float32)
    origin = np.asarray(origin, np.int32)
    if (origin % 4096).any():
        raise ValueError("origin must be 4096-aligned (one root tile)")
    shape = np.asarray(dense.shape, np.int64)
    if (shape > 4096).any():
        raise ValueError("single-root-tile writer supports <= 4096^3")

    # pad to 8^3 leaves
    pshape = (shape + 7) // 8 * 8
    pad = np.full(pshape, background, np.float32)
    pad[:shape[0], :shape[1], :shape[2]] = dense
    nl = pshape // 8  # leaves per axis
    leaf_blocks = pad.reshape(nl[0], 8, nl[1], 8, nl[2], 8
                              ).transpose(0, 2, 4, 1, 3, 5)
    occupied = np.abs(leaf_blocks - background).max(axis=(3, 4, 5)) > 0

    # one upper node; lower nodes for every 128^3 region containing data
    n_low = (nl + 15) // 16
    lower_origs, leaf_lists = [], []
    for lx in range(n_low[0]):
        for ly in range(n_low[1]):
            for lz in range(n_low[2]):
                sel = occupied[lx * 16:lx * 16 + 16, ly * 16:ly * 16 + 16,
                               lz * 16:lz * 16 + 16]
                if sel.any():
                    lower_origs.append((lx, ly, lz))
                    leaf_lists.append(np.argwhere(sel))
    n_leaf = sum(len(v) for v in leaf_lists)

    root_size = ROOT_DATA_SIZE + ROOT_TILE_SIZE
    upper_off = root_size  # upper node's root-relative position
    lower0 = root_size + UPPER_SIZE
    leaf0 = lower0 + len(lower_origs) * LOWER_SIZE
    tree_size = leaf0 + n_leaf * LEAF_SIZE
    grid_size = GRID_DATA_SIZE + TREE_DATA_SIZE + tree_size
    buf = bytearray(grid_size)

    mn = float(dense.min()) if dense.size else background
    mx = float(dense.max()) if dense.size else background

    # ---- GridData
    version = (32 << 21) | (3 << 10) | 3
    struct.pack_into("<QQIIIIQ", buf, 0, MAGIC, 0, version, 0, 0, 1,
                     grid_size)
    struct.pack_into("256s", buf, 40, name.encode())
    map_off = 296
    matf = np.eye(3, dtype=np.float32).ravel() * voxel_size
    invf = np.eye(3, dtype=np.float32).ravel() / voxel_size
    struct.pack_into("<9f9f3ff", buf, map_off, *matf, *invf, 0, 0, 0, 1.0)
    struct.pack_into("<9d9d3dd", buf, map_off + 88,
                     *matf.astype(np.float64), *invf.astype(np.float64),
                     0, 0, 0, 1.0)
    wmin = origin * voxel_size
    wmax = (origin + shape) * voxel_size
    struct.pack_into("<6d", buf, 560, *wmin.astype(np.float64),
                     *wmax.astype(np.float64))
    struct.pack_into("<3d", buf, 608, voxel_size, voxel_size, voxel_size)
    struct.pack_into("<IIqI", buf, 632, grid_class, GRID_TYPE_FLOAT, 0, 0)

    # ---- TreeData (offsets relative to tree start)
    tree = GRID_DATA_SIZE
    root_off = TREE_DATA_SIZE  # root directly after TreeData
    struct.pack_into("<4Q3I3IQ", buf, tree,
                     root_off + leaf0, root_off + lower0,
                     root_off + root_size, root_off,
                     n_leaf, len(lower_origs), 1, 0, 0, 0,
                     int((np.abs(pad - background) > 0).sum()))

    # ---- RootData + one tile
    root = tree + root_off
    struct.pack_into("<6iIfffff", buf, root, *origin, *(origin + shape),
                     1, background, mn, mx, 0.0, 0.0)
    key = _coord_to_key(origin)
    struct.pack_into("<qqIf", buf, root + ROOT_DATA_SIZE, key,
                     root_size, 1, background)

    def fill_table_background(off, n):
        """Non-child table slots must carry the background value: the
        accessor returns mTable[n].value for any untouched region."""
        bg_tile = struct.pack("<fI", background, 0) * n
        buf[off:off + 8 * n] = bg_tile

    # ---- Upper node
    up = root + root_size
    struct.pack_into("<6iQ", buf, up, *origin, *(origin + shape), 0)
    fill_table_background(up + UPPER_TABLE, 32768)
    cmask = np.zeros(32768 // 8, np.uint8)
    for li, (lx, ly, lz) in enumerate(lower_origs):
        n = (lx << 10) | (ly << 5) | lz
        cmask[n >> 3] |= 1 << (n & 7)
        struct.pack_into("<q", buf, up + UPPER_TABLE + n * 8,
                         lower0 + li * LOWER_SIZE - upper_off)
    buf[up + UPPER_CMASK:up + UPPER_CMASK + 4096] = cmask.tobytes()
    struct.pack_into("<4f", buf, up + 8224, mn, mx, 0, 0)

    # ---- Lower nodes + leaves
    leaf_i = 0
    for li, ((lx, ly, lz), leaves) in enumerate(zip(lower_origs,
                                                    leaf_lists)):
        lo = root + lower0 + li * LOWER_SIZE
        lorg = origin + np.array([lx, ly, lz]) * 128
        struct.pack_into("<6iQ", buf, lo, *lorg, *(lorg + 128), 0)
        fill_table_background(lo + LOWER_TABLE, 4096)
        cmask = np.zeros(4096 // 8, np.uint8)
        for (ex, ey, ez) in leaves:
            n = (int(ex) << 8) | (int(ey) << 4) | int(ez)
            cmask[n >> 3] |= 1 << (n & 7)
            leaf_byte = leaf0 + leaf_i * LEAF_SIZE
            struct.pack_into("<q", buf, lo + LOWER_TABLE + n * 8,
                             leaf_byte - (lower0 + li * LOWER_SIZE))
            gl = np.array([lx * 16 + ex, ly * 16 + ey, lz * 16 + ez])
            lf = root + leaf_byte
            lorg8 = origin + gl * 8
            struct.pack_into("<3i3BB", buf, lf, *lorg8, 7, 7, 7, 0)
            buf[lf + 16:lf + 80] = b"\xff" * 64
            block = leaf_blocks[gl[0], gl[1], gl[2]]
            struct.pack_into("<4f", buf, lf + 80, float(block.min()),
                             float(block.max()), 0, 0)
            buf[lf + LEAF_VALUES:lf + LEAF_VALUES + 2048] = \
                block.astype("<f4").tobytes()
            leaf_i += 1
        buf[lo + LOWER_CMASK:lo + LOWER_CMASK + 512] = cmask.tobytes()
        struct.pack_into("<4f", buf, lo + 1072, mn, mx, 0, 0)

    # ---- file framing (header + metadata + name), testbed_volume.cu:546-569
    with open(path, "wb") as f:
        f.write(struct.pack("<QIHH", MAGIC, version, 1, 0))
        nameb = name.encode() + b"\0"
        f.write(struct.pack("<QQQQII", grid_size, grid_size + 192 +
                            len(nameb), 0, int((np.abs(pad - background)
                                               > 0).sum()),
                            GRID_TYPE_FLOAT, grid_class))
        f.write(struct.pack("<6d", *wmin.astype(np.float64),
                            *wmax.astype(np.float64)))
        f.write(struct.pack("<6i", *origin, *(origin + shape)))
        f.write(struct.pack("<3d", voxel_size, voxel_size, voxel_size))
        f.write(struct.pack("<I", len(nameb)))
        f.write(struct.pack("<4I", n_leaf, len(lower_origs), 1, 1))
        f.write(struct.pack("<3I", 0, 0, 0))
        f.write(struct.pack("<HHI", 0, 0, version))
        f.write(nameb)
        f.write(bytes(buf))
