"""The port's image I/O (`data/exr.py`, `data/images.py`) and its numpy
colour helpers against the JAX package's: what one package writes the
other reads, bit for bit for `.bin` and float EXR files (both store raw
float16 / float32 values; a half EXR rounds to float16 once, the same way
on both sides), and `read_image` follows the same conventions (LDR files
are sRGB and come back linear with premultiplied alpha; EXR and `.bin`
are linear already). PNG round trips agree to one 8-bit step."""

import os

import numpy as np
import pytest

from instant_ngp_tpu import common as jcommon
from instant_ngp_tpu.data import exr as jexr
from instant_ngp_tpu.data import images as jimages
from instant_ngp_tpu_torch import common
from instant_ngp_tpu_torch.data import exr, images


def _image(seed, h, w, c):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 2.0, (h, w, c)).astype(np.float32)
    img[0, 0] = 0.0
    img[-1, -1] = 1.0
    return img


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
def test_exr_round_trip_and_cross_read(tmp_path, channels, half):
    img = _image(channels, 13, 17, channels)
    ours, theirs = str(tmp_path / "ours.exr"), str(tmp_path / "theirs.exr")
    exr.write_exr(ours, img, half=half)
    jexr.write_exr(theirs, img, half=half)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()             # the same file, byte for byte
    expect = img.astype(np.float16).astype(np.float32) if half else img
    for reader in (exr.read_exr, jexr.read_exr):
        for path in (ours, theirs):
            back, names = reader(path)
            assert names == {1: ["Y"], 2: ["R", "G"], 3: ["R", "G", "B"],
                             4: ["R", "G", "B", "A"]}[channels]
            assert back.dtype == np.float32 and back.shape == img.shape
            np.testing.assert_array_equal(back, expect)


def test_exr_reads_zip_compressed_scanlines(tmp_path):
    """A ZIP (16 scanlines a chunk) half EXR assembled by hand with the
    predictor and the byte split of the format: both readers undo them."""
    import struct
    import zlib

    h, w = 21, 9
    # a smooth ramp, so that the chunks do compress
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / w, yy / h, (xx + yy) / (w + h)],
                   -1).astype(np.float16)
    names = ["B", "G", "R"]

    def attr(name, atype, payload):
        return name.encode() + b"\0" + atype.encode() + b"\0" \
            + struct.pack("<i", len(payload)) + payload

    chlist = b"".join(n.encode() + b"\0" + struct.pack("<i", 1) + b"\0" * 4
                      + struct.pack("<ii", 1, 1) for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (attr("channels", "chlist", chlist)
              + attr("compression", "compression", b"\x03")
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    chunks = []
    for y0 in range(0, h, 16):
        raw = b"".join(img[y, :, 2 - k].tobytes()
                       for y in range(y0, min(y0 + 16, h)) for k in range(3))
        packed = zlib.compress(exr._interleave_and_predict(raw))
        assert len(packed) < len(raw)
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)
    preamble = struct.pack("<iI", 0x01312F76, 2) + header
    offsets, off = [], len(preamble) + 8 * len(chunks)
    for c in chunks:
        offsets.append(off)
        off += len(c)
    path = str(tmp_path / "zip.exr")
    with open(path, "wb") as f:
        f.write(preamble + struct.pack(f"<{len(chunks)}Q", *offsets)
                + b"".join(chunks))
    for reader in (exr.read_exr, jexr.read_exr):
        back, got = reader(path)
        assert got == ["R", "G", "B"]
        np.testing.assert_array_equal(back, img.astype(np.float32))
    raw = os.urandom(101)
    assert exr._unpredict_and_interleave(
        exr._interleave_and_predict(raw)) == raw


@pytest.mark.parametrize("channels", [3, 4])
def test_bin_round_trip_and_cross_read(tmp_path, channels):
    img = _image(7 + channels, 11, 6, channels)
    ours, theirs = str(tmp_path / "ours.bin"), str(tmp_path / "theirs.bin")
    images.write_bin_image(ours, img)
    jimages.write_bin_image(theirs, img)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    expect = img.astype(np.float16).astype(np.float32)
    for reader in (images.read_bin_image, jimages.read_bin_image,
                   images.read_image, jimages.read_image):
        back = reader(theirs)
        assert back.shape == (11, 6, 4)
        np.testing.assert_array_equal(back[..., :channels], expect)
        if channels == 3:
            assert (back[..., 3] == 1.0).all()


@pytest.mark.parametrize("ext", [".png", ".jpg", ".exr", ".bin"])
@pytest.mark.parametrize("channels", [3, 4])
def test_read_and_write_image_follow_the_jax_conventions(tmp_path, ext,
                                                         channels):
    img = np.clip(_image(11, 16, 12, channels) * 0.5, 0.0, 1.0)
    if channels == 4:
        img[..., :3] *= img[..., 3:4]            # premultiplied
    ours, theirs = str(tmp_path / ("ours" + ext)), \
        str(tmp_path / ("theirs" + ext))
    images.write_image(ours, img)
    jimages.write_image(theirs, img)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    a, b = images.read_image(theirs), jimages.read_image(ours)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32
    # what comes back is what went in, to the file format's precision: an
    # 8-bit sRGB step is up to 2.4 / 255 in linear values, and both the
    # colour and the alpha are rounded; a JPEG drops the alpha, so the
    # colours come back straight, and blurs noise by a few steps more
    tol = {".png": 1e-2, ".jpg": 0.2, ".exr": 1e-3, ".bin": 1e-3}[ext]
    expect = img
    if ext == ".jpg" and channels == 4:
        with np.errstate(divide="ignore", invalid="ignore"):
            expect = np.where(img[..., 3:4] != 0,
                              img[..., :3] / img[..., 3:4], 0.0)
    kept = 3 if ext == ".jpg" else channels
    np.testing.assert_allclose(a[..., :kept], expect[..., :kept], atol=tol)
    np.testing.assert_array_equal(
        images.read_image(theirs, linearize=False),
        jimages.read_image(theirs, linearize=False))


def test_colour_helpers_and_image_mse_match_jax():
    x = np.linspace(-0.1, 1.5, 4001).astype(np.float32)
    np.testing.assert_array_equal(common.srgb_to_linear(x),
                                  jcommon.srgb_to_linear(x))
    np.testing.assert_array_equal(common.linear_to_srgb(x),
                                  jcommon.linear_to_srgb(x))
    inside = x[(x >= 0) & (x <= 1)]
    np.testing.assert_allclose(
        common.srgb_to_linear(common.linear_to_srgb(inside)), inside,
        atol=1e-6)
    a, b = _image(1, 8, 8, 3), _image(2, 8, 8, 3)
    for quantize in (False, True):
        assert images.image_mse(a, b, quantize) == \
            jimages.image_mse(a, b, quantize)
    assert images.image_mse(a, a) == 0.0
    box = common.BoundingBox.unit()
    assert box.contains(np.array([0.5, 0.5, 0.5])) \
        and not box.contains(np.array([1.5, 0.5, 0.5]))
    np.testing.assert_array_equal(box.center, jcommon.BoundingBox.unit().center)
    assert {m.value for m in common.RenderMode} <= \
        {m.value for m in jcommon.RenderMode}
