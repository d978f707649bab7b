"""The port's image loading (data/images.py, no OpenCV) against OpenCV and
the JAX package's copy on the CPU: `resize_linear` / `resize_area` within
one uint8 step of cv2.resize (OpenCV's SIMD sums round otherwise) and a
mean under 0.05 steps, float `resize_linear` bit-equal to OpenCV's portable
code; `read_png` bit-exact against cv2.imread over every filter and colour
type, `write_png` read back by both; `load_and_preprocess_images` within
one step (1/255), mean under 0.05/255.
"""
import struct
import zlib

import cv2
import numpy as np
import pytest

from vggt_slam_tpu.data import images as jimages
from vggt_slam_tpu_torch.data import images


def _frame(h, w, seed=0, ch=3):
    """Smooth colour field with edges and noise, (h, w, ch) uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = [127 + 100 * np.sin(xx / (9 + 4 * c) + yy / (13 + c))
            for c in range(ch)]
    img = np.stack(base, -1) + rng.normal(0, 12, (h, w, ch))
    img[h // 3:h // 2, w // 4:w // 2] = rng.uniform(0, 255, ch)
    return np.clip(img, 0, 255).astype(np.uint8)


def _filter_rows(px, bpp, kinds):
    """PNG-filter each row of (h, stride) uint8 with kinds[y % len]."""
    h, stride = px.shape
    cur = px.astype(np.int64)
    out = bytearray()
    for y in range(h):
        x = cur[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        b = cur[y - 1] if y else np.zeros(stride, np.int64)
        c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
        kind = kinds[y % len(kinds)]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out += bytes([kind]) + ((x - pred) & 255).astype(np.uint8).tobytes()
    return bytes(out)


def _write_png(path, px, color, kinds=(0, 1, 2, 3, 4), palette=None):
    h, w = px.shape[:2]
    ch = 1 if px.ndim == 2 else px.shape[2]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))

    data = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(
        _filter_rows(px.reshape(h, w * ch), ch, kinds)))
    data += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _close_to_cv2(got, want):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert diff.max() <= 1, diff.max()
    assert diff.mean() < 0.05, diff.mean()


@pytest.mark.parametrize("hw,out_wh", [
    ((480, 640), (518, 392)),     # TUM RGB-D, 7-Scenes: the path that runs
    ((480, 640), (518, 388)),
    ((300, 400), (518, 392)),     # enlarging
    ((99, 70), (518, 728)),
])
def test_resize_linear_matches_cv2(hw, out_wh):
    img = _frame(*hw, seed=1)
    _close_to_cv2(images.resize_linear(img, *out_wh),
                  cv2.resize(img, out_wh, interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("hw,out_wh", [
    ((640, 640), (518, 518)),     # square frames: interim_h == new_h
    ((480, 640), (518, 388)),     # fractional in both axes
    ((1036, 1036), (518, 518)),   # integer scale: a plain mean
    ((684, 1200), (518, 295)),
])
def test_resize_area_matches_cv2(hw, out_wh):
    img = _frame(*hw, seed=2)
    _close_to_cv2(images.resize_area(img, *out_wh),
                  cv2.resize(img, out_wh, interpolation=cv2.INTER_AREA))


def test_float_resizes_match_cv2():
    img = _frame(120, 160, seed=3).astype(np.float32) / 255.0
    np.testing.assert_allclose(
        images.resize_linear(img, 97, 61),
        cv2.resize(img, (97, 61), interpolation=cv2.INTER_LINEAR),
        atol=1e-5)
    np.testing.assert_allclose(
        images.resize_area(img, 97, 61),
        cv2.resize(img, (97, 61), interpolation=cv2.INTER_AREA), atol=1e-5)


@pytest.mark.parametrize("hw,out_wh", [((120, 160), (97, 61)),
                                       ((7, 9), (224, 224)),
                                       ((300, 41), (52, 40))])
def test_float_resize_linear_is_opencv_portable_bit_for_bit(hw, out_wh):
    """OpenCV's portable INTER_LINEAR (IPP off), which the semantic
    embedder's crops go through: equal bit for bit, edge columns too."""
    img = _frame(*hw, seed=5).astype(np.float32) / 255.0
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        want = cv2.resize(img, out_wh, interpolation=cv2.INTER_LINEAR)
    finally:
        cv2.ipp.setUseIPP(was)
    np.testing.assert_array_equal(images.resize_linear(img, *out_wh), want)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "palette"])
def test_png_reader_is_bit_exact_with_cv2(tmp_path, kind):
    rng = np.random.default_rng(4)
    path = str(tmp_path / f"{kind}.png")
    if kind == "gray":
        _write_png(path, _frame(37, 53, ch=1)[..., 0], 0)
    elif kind == "rgb":
        _write_png(path, _frame(37, 53), 2)
    elif kind == "rgba":
        _write_png(path, _frame(37, 53, ch=4), 6)
    else:
        pal = rng.integers(0, 256, (200, 3))
        _write_png(path, rng.integers(0, 200, (37, 53)).astype(np.uint8), 3,
                   palette=pal)
    got = images.load_image(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,)])
def test_png_reader_every_row_filter(tmp_path, kinds):
    path = str(tmp_path / "f.png")
    _write_png(path, _frame(23, 31, seed=5), 2, kinds=kinds)
    np.testing.assert_array_equal(images.read_png(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("hw", [(1, 9), (9, 1), (41, 17), (480, 640)])
def test_png_reader_mixed_filters_any_shape(tmp_path, hw):
    # Average and Paeth rows go through the anti-diagonal wavefront; one
    # row, one column, tall and TUM-sized frames
    path = str(tmp_path / "m.png")
    _write_png(path, _frame(*hw, seed=7), 2, kinds=(4, 3, 4, 1, 2, 0))
    np.testing.assert_array_equal(images.read_png(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("hw", [(1, 9), (37, 53), (392, 518)])
def test_png_writer_reads_back(tmp_path, hw):
    """`write_png` (each row's filter chosen as libpng's adaptive choice)
    -> the in-repo reader and OpenCV give back the frame bit for bit."""
    path = str(tmp_path / "w.png")
    img = _frame(*hw, seed=9)
    kinds = images.write_png(path, img)
    assert kinds.shape == (hw[0],) and kinds.max() <= 4
    np.testing.assert_array_equal(images.read_png(path), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), img)


def test_png_written_by_cv2_and_unsupported_pngs(tmp_path):
    path = str(tmp_path / "cv.png")
    img = _frame(48, 64, seed=6)
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(images.load_image(path), img)
    deep = str(tmp_path / "depth16.png")
    cv2.imwrite(deep, (img[..., 0].astype(np.uint16) * 200))
    with pytest.raises(ValueError, match="depth16.png"):
        images.load_image(deep)
    with pytest.raises(FileNotFoundError):
        images.load_image(str(tmp_path / "missing.png"))


def test_jpeg_goes_through_pil_or_names_the_formats(tmp_path, monkeypatch):
    path = str(tmp_path / "a.jpg")
    img = _frame(48, 64, seed=7)
    cv2.imwrite(path, img)
    got = images.load_image(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.shape == want.shape and got.dtype == np.uint8
    # two JPEG decoders: the same image to within their IDCT rounding
    assert np.abs(got.astype(int) - want.astype(int)).mean() < 1.0
    import builtins
    real_import = builtins.__import__

    def no_decoders(name, *a, **kw):
        if name.split(".")[0] in ("PIL", "torchvision"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_decoders)
    with pytest.raises(RuntimeError, match=r"a\.jpg.*PNG.*PIL"):
        images.load_image(path)


def test_folder_preprocess_matches_reference(tmp_path):
    """A PNG folder of 480x640 frames through both packages' loaders:
    the reference decodes and resizes with OpenCV, the port without."""
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i:04d}.png"))
        cv2.imwrite(paths[-1], _frame(480, 640, seed=10 + i))
    (tmp_path / "depth_0001.png").write_bytes(b"")
    (tmp_path / "rgb.txt").write_text("")
    assert images.list_image_folder(str(tmp_path)) == \
        jimages.list_image_folder(str(tmp_path))
    got = images.load_and_preprocess_images(paths)
    want = jimages.load_and_preprocess_images(paths)
    assert got.shape == want.shape == (3, 3, 392, 518)
    diff = np.abs(got - want) * 255
    assert diff.max() <= 1 + 1e-3 and diff.mean() < 0.05
    # square frames take the INTER_AREA branch
    sq = _frame(640, 640, seed=20)
    diff = np.abs(images.preprocess_array(sq)
                  - jimages.preprocess_array(sq)) * 255
    assert diff.max() <= 1 + 1e-3 and diff.mean() < 0.05
