"""Image loading and preprocessing for the VGGT input pipeline (a copy of
vggt_slam_tpu/data/images.py without OpenCV): resize to width 518 with the
height rounded to the 14-px patch, values in [0, 1], (S, 3, H, W) float32.
PNG (8-bit, and 16-bit gray by `read_png_unchanged`) is decoded on zlib
and native/png.cpp (built by g++) and written by `write_png` and
`write_png16`; other formats, JPEG included, by PIL or torchvision where
one imports. The reference's INTER_NEAREST, INTER_LINEAR and INTER_AREA
resizes are numpy with OpenCV's conventions.
"""
from __future__ import annotations

import glob
import os
import re
import struct
import zlib

import numpy as np

TARGET_WIDTH = 518
PATCH = 14


def preprocessed_hw(orig_h: int, orig_w: int,
                    target_width: int = TARGET_WIDTH) -> tuple[int, int]:
    new_h = int(round(orig_h * target_width / orig_w / PATCH)) * PATCH
    return max(PATCH, min(new_h, target_width)), target_width


# Decoding

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}     # gray, RGB, palette, RGBA


_PNG_LIB = []     # native/png.cpp's library, built by g++ at first use


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The five PNG row filters undone in C -> (h, stride) uint8."""
    if not _PNG_LIB:
        import ctypes

        from vggt_slam_tpu_torch.native import build_library, paths
        lib = ctypes.CDLL(build_library(*paths("png")))
        lib.png_unfilter.restype = ctypes.c_int32
        lib.png_unfilter.argtypes = [ctypes.c_void_p] + 3 * [
            ctypes.c_int32] + [ctypes.c_void_p]
        _PNG_LIB.append(lib)
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    if _PNG_LIB[0].png_unfilter(rows.ctypes.data, h, stride, bpp,
                                out.ctypes.data):
        raise ValueError(f"bad PNG row filter {rows[:, 0].max()}")
    return out


def _png_parts(path: str):
    """(IHDR fields, palette or None, inflated image data) of a PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    return hdr, palette, zlib.decompress(b"".join(idat))


def _pixels(path, raw, h, stride, bpp):
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    try:
        return _unfilter(raw, h, stride, bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit gray, RGB, RGBA or palette PNG that is not
    interlaced -> (H, W, 3) uint8 BGR, as cv2.imread(IMREAD_COLOR) gives
    (alpha dropped). Raises ValueError on any other PNG."""
    (w, h, depth, color, _, _, interlace), palette, raw = _png_parts(path)
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0 or \
            (color == 3 and palette is None):
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); the reader takes 8-bit gray, "
            f"RGB, RGBA and palette PNGs that are not interlaced, and "
            f"read_png_unchanged 16-bit gray")
    ch = _PNG_CHANNELS[color]
    px = _pixels(path, raw, h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        rgb = palette[np.minimum(px[..., 0], len(palette) - 1)]
    elif ch == 1:
        rgb = np.repeat(px, 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def read_png_unchanged(path: str) -> np.ndarray:
    """A 16-bit gray PNG (7-Scenes depth) -> (H, W) uint16, as
    cv2.imread(IMREAD_UNCHANGED) gives; any other PNG as `read_png`."""
    (w, h, depth, color, _, _, interlace), _, raw = _png_parts(path)
    if depth != 16 or color != 0 or interlace != 0:
        return read_png(path)
    # the filters work on bytes: 2 a pixel, big-endian samples
    px = _pixels(path, raw, h, 2 * w, 2)
    return px.view(">u2").astype(np.uint16)


def _filter_rows(x: np.ndarray, bpp: int, kinds=None):
    """(h, stride) bytes as int16 -> filtered rows with their type byte
    first. Each row takes `kinds[row]`, or libpng's adaptive rule (the
    least absolute sum of signed residuals)."""
    h, n = x.shape
    up = np.concatenate([np.zeros((1, n), np.int16), x[:-1]])
    left = np.concatenate([np.zeros((h, bpp), np.int16), x[:, :-bpp]], 1)
    ul = np.concatenate([np.zeros((h, bpp), np.int16), up[:, :-bpp]], 1)
    pa, pb, pc = (np.abs(up - ul), np.abs(left - ul),
                  np.abs(left + up - 2 * ul))
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    res = np.stack([(x - p) & 255 for p in (0, left, up, (left + up) >> 1,
                                            paeth)]).astype(np.uint8)
    kind = np.abs(res.view(np.int8).astype(np.int32)).sum(2).argmin(0) \
        if kinds is None else np.resize(np.asarray(kinds, np.intp), h)
    return np.concatenate([kind[:, None].astype(np.uint8),
                           res[kind, np.arange(h)]], 1), kind


def _write_png_file(path, w, h, depth, color, rows):
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xffffffff))

    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_png(path, bgr):
    """(H, W, 3) uint8 BGR -> an 8-bit RGB PNG, rows filtered adaptively.
    Returns the rows' filter types."""
    h, w = bgr.shape[:2]
    rows, kind = _filter_rows(
        bgr[..., ::-1].reshape(h, w * 3).astype(np.int16), 3)
    _write_png_file(path, w, h, 8, 2, rows)
    return kind


def write_png16(path, gray, kinds=None):
    """(H, W) uint16 -> a 16-bit gray PNG; each row filtered by `kinds`
    (cycled) or adaptively. Returns the rows' filter types."""
    h, w = gray.shape
    be = np.ascontiguousarray(gray, ">u2").view(np.uint8).reshape(h, 2 * w)
    rows, kind = _filter_rows(be.astype(np.int16), 2, kinds)
    _write_png_file(path, w, h, 16, 0, rows)
    return kind


def _read_other(path: str) -> np.ndarray:
    """JPEG and the other formats through PIL or torchvision -> BGR."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        with Image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
        return np.ascontiguousarray(rgb[..., ::-1])
    try:
        from torchvision.io import ImageReadMode, decode_image, read_file
    except ImportError:
        raise RuntimeError(
            f"cannot decode {path}: PNG is read in-repo; other formats "
            f"(JPEG included) need PIL or torchvision, and neither "
            f"imports") from None
    rgb = decode_image(read_file(path), mode=ImageReadMode.RGB)
    return np.ascontiguousarray(rgb.permute(1, 2, 0).numpy()[..., ::-1])


def load_image(path: str) -> np.ndarray:
    """Decode one image file -> (H, W, 3) uint8 BGR."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cannot read image: {path}")
    with open(path, "rb") as f:
        is_png = f.read(8) == _PNG_SIG
    return read_png(path) if is_png else _read_other(path)


# Resizing (cv2.resize's INTER_NEAREST, INTER_LINEAR, INTER_AREA in numpy)

def resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), INTER_NEAREST): source index floor(x / (w /
    W)) in double, clamped to W - 1 (not INTER_NEAREST_EXACT's centres)."""
    H, W = img.shape[:2]
    x = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))), W - 1)
    y = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))), H - 1)
    return img[y.astype(np.intp)[:, None], x.astype(np.intp)]

def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR taps: half-pixel centres, clamped edges, no
    antialiasing; 11-bit fixed-point weights (w0 + w1 = 2048)."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i0 = np.floor(f)
    frac = f - i0
    i0 = i0.astype(np.int64)
    w1 = np.rint(frac * np.float32(2048)).astype(np.int64)
    w0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int64)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w0, w1,
            frac)


def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), INTER_LINEAR) for (H, W, C): uint8 in OpenCV's
    fixed point (within one step where its scalar tail rounds otherwise); float
    in float32 as OpenCV's portable code, bit for bit (its IPP build differs by
    ~2e-5)."""
    H, W = img.shape[:2]
    x0, x1, ax0, ax1, fx = _linear_taps(W, w)
    y0, y1, by0, by1, fy = _linear_taps(H, h)
    if img.dtype == np.uint8:
        src = img.astype(np.int64)
        rows = (src[:, x0] * ax0[None, :, None] + src[:, x1]
                * ax1[None, :, None])                     # (H, w, C), 2^11
        # the vertical pass as OpenCV's SIMD path rounds it: 16-bit high
        # products of the rows (>> 4) and weights, then (sum + 2) >> 2
        out = ((((rows[y0] >> 4) * by0[:, None, None]) >> 16)
               + (((rows[y1] >> 4) * by1[:, None, None]) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    # OpenCV's float path: a column whose taps clamp to one source column
    # takes it with weight 1 (rows blend their clamped neighbours)
    fx = np.where(x0 == x1, np.float32(0), fx)
    fx, fy = fx[None, :, None], fy[:, None, None]
    rows = src[:, x0] * (1 - fx) + src[:, x1] * fx
    return (rows[y0] * (1 - fy) + rows[y1] * fy).astype(np.float32)


def _area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) INTER_AREA weights (OpenCV computeResizeAreaTab): each
    output cell averages the input pixels it covers, with fractional
    weights at its two ends."""
    scale = n_in / n_out
    A = np.zeros((n_out, n_in))
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            A[d, s1 - 1] = (s1 - f1) / cell
        A[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            A[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return A


def resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), INTER_AREA) for shrinking (H, W, C): box weights
    at fractional scales, a plain mean at integer ones; uint8 rounds as
    OpenCV."""
    H, W = img.shape[:2]
    cols = np.tensordot(img.astype(np.float64), _area_matrix(W, w),
                        axes=(1, 1))                      # (H, C, w)
    out = np.tensordot(_area_matrix(H, h), cols, axes=(1, 0)
                       ).transpose(0, 2, 1)
    if img.dtype != np.uint8:
        return out.astype(np.float32)
    integer = H % h == 0 and W % w == 0
    out = np.floor(out + 0.5) if integer else np.rint(out)
    return np.clip(out, 0, 255).astype(np.uint8)


def preprocess_array(img_rgb: np.ndarray,
                     target_width: int = TARGET_WIDTH) -> np.ndarray:
    """(H, W, 3) uint8/float RGB -> (3, h, w) float32 in [0, 1]."""
    H, W = img_rgb.shape[:2]
    new_h, new_w = preprocessed_hw(H, W, target_width)
    interim_h = int(round(H * new_w / W))
    if (H, W) == (new_h, new_w):
        resized = img_rgb
    elif interim_h < new_h:
        # the reference resizes to interim_h first and throws it away
        resized = resize_linear(img_rgb, new_w, new_h)
    else:
        resize = resize_area if interim_h < H else resize_linear
        resized = resize(img_rgb, new_w, interim_h)
        if interim_h > new_h:
            top = (interim_h - new_h) // 2
            resized = resized[top:top + new_h]
    out = resized.astype(np.float32)
    if img_rgb.dtype == np.uint8:
        out /= 255.0
    return np.transpose(out, (2, 0, 1))


def preprocess_frames(frames_bgr, target_width: int = TARGET_WIDTH):
    """Decoded (H, W, 3) uint8 BGR frames -> (S, 3, H, W) float32 batch."""
    imgs = [preprocess_array(np.ascontiguousarray(f[..., ::-1]),
                             target_width) for f in frames_bgr]
    if len({im.shape for im in imgs}) != 1:
        raise ValueError("mixed image shapes after preprocess")
    return np.stack(imgs, axis=0)


def load_and_preprocess_images(paths, target_width: int = TARGET_WIDTH):
    """Image paths -> (S, 3, H, W) float32 batch (uniform shape)."""
    return preprocess_frames([load_image(p) for p in paths], target_width)


def sort_images_by_number(image_paths):
    def extract(path):
        m = re.search(r"\d+(?:\.\d+)?", os.path.basename(path))
        return float(m.group()) if m else float("inf")
    return sorted(image_paths, key=extract)


def downsample_images(image_names, factor: int):
    return image_names[::factor]


def list_image_folder(folder: str):
    """Glob, drop depth/txt/json/db files, numeric sort."""
    names = [f for f in glob.glob(os.path.join(folder, "*"))
             if not any(t in os.path.basename(f).lower()
                        for t in ("depth", "txt", "json", "db"))]
    return sort_images_by_number(names)
