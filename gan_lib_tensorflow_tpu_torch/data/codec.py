"""Image decoding and resizing for the image-folder loaders, equal byte for
byte to what the reference's loaders get from Pillow
(``Image.open(path).convert("RGB")``, ``crop``, ``resize(..., BILINEAR)``).

- ``decode_rgb``: JPEG through the hand-written decoder ``csrc/imgcodec.cpp``
  (baseline and progressive Huffman, libjpeg's islow IDCT, fancy upsampling
  and YCbCr tables), built at first use by ``ops/cuda_lib.py`` with the
  host's C++ compiler; PNG inflated by ``zlib`` and unfiltered by the same
  library; uncompressed BMP in numpy; WebP (lossy VP8, lossless VP8L,
  alpha, the extended and animated formats) through the hand-written
  decoder ``csrc/webpdec.cpp``: the RGB of the first frame on its canvas,
  as Pillow's animation decoder gives it. What it cannot decode
  (arithmetic-coded, 12-bit or lossless JPEG, compressed BMP, a WebP frame
  that is not a key frame, a truncated or corrupt file) raises
  ``ValueError`` naming the file. Nothing falls back.
- ``crop`` and ``resize_bilinear``: Pillow's box convention and its
  ``BILINEAR`` resample (``Resample.c``: an antialiased triangle of support
  ``max(in / out, 1)``, 22-bit fixed-point weights, the horizontal pass
  first, each pass only where its size changes).
- ``to_float_div``: the reference folder loaders' normalize, a float32
  division by 127.5 and then a subtraction of 1. It differs from
  ``data/base.py``'s ``normalize_u8`` (the fused multiply-add form of the
  native and packed paths) in the last bit for 205 of the 256 byte values.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import zlib
from typing import Tuple

import numpy as np

from ..ops.cuda_lib import KernelLibrary

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2


def _declare(lib: ctypes.CDLL) -> None:
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.gl_jpeg_info.argtypes = [u8p, ctypes.c_size_t, ip, ip, ip]
    lib.gl_jpeg_info.restype = ctypes.c_int
    lib.gl_jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_int, ctypes.c_int]
    lib.gl_jpeg_decode.restype = ctypes.c_int
    lib.gl_png_unfilter.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, u8p]
    lib.gl_png_unfilter.restype = ctypes.c_int


def _declare_webp(lib: ctypes.CDLL) -> None:
    u8p, ip = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.gl_webp_info.argtypes = [u8p, ctypes.c_size_t, ip, ip]
    lib.gl_webp_info.restype = ctypes.c_int
    lib.gl_webp_decode.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int32)]
    lib.gl_webp_decode.restype = ctypes.c_int


library = KernelLibrary("imgcodec", _declare, suffix=".cpp")
webp_library = KernelLibrary("webpdec", _declare_webp, suffix=".cpp")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(lib, status: int, path: str) -> None:
    if status != 0:
        raise ValueError(f"{path}: {lib.gl_error_string(status).decode()}")


def _decode_jpeg(buf: bytes, path: str) -> np.ndarray:
    lib = library.load()
    data = np.frombuffer(buf, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.gl_jpeg_info(_ptr(data), data.size, ctypes.byref(w), ctypes.byref(h),
                                 ctypes.byref(c)), path)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib, lib.gl_jpeg_decode(_ptr(data), data.size, _ptr(out), w.value, h.value), path)
    return out


def _decode_webp(buf: bytes, path: str, features=None) -> np.ndarray:
    """RGBA uint8 ``[H, W, 4]`` of the first frame on its canvas; with
    ``features`` (a ctypes int32 array of ``len(WEBP_FEATURES)``) also what
    the decode met."""
    lib = webp_library.load()
    data = np.frombuffer(buf, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.gl_webp_info(_ptr(data), data.size, ctypes.byref(w), ctypes.byref(h)), path)
    out = np.empty((h.value, w.value, 4), np.uint8)
    _check(lib, lib.gl_webp_decode(_ptr(data), data.size, _ptr(out), w.value, h.value,
                                   features), path)
    return out


def _read_webp(path: str) -> bytes:
    with open(path, "rb") as f:
        buf = f.read()
    if not _is_webp(buf):
        raise ValueError(f"{path}: not a WebP file")
    return buf


def decode_webp_rgba(path: str) -> np.ndarray:
    """A WebP file as Pillow's ``Image.open(path).convert("RGBA")``: the
    non-premultiplied RGBA of its first frame on its canvas."""
    return _decode_webp(_read_webp(path), path)


WEBP_FEATURES = ("lossless", "predictors", "filter", "partitions", "segments", "sharpness",
                 "alpha", "flags")


def webp_features(path: str) -> dict:
    """The parts of the format a WebP file's decode met (``csrc/webpdec.cpp``
    ``Features``: VP8L transforms, codes and predictor modes, the VP8 loop
    filter, partitions, segments and sharpness, the ALPH method and filter,
    the container): a test's check of what its fixtures cover."""
    out = (ctypes.c_int32 * len(WEBP_FEATURES))()
    _decode_webp(_read_webp(path), path, out)
    return dict(zip(WEBP_FEATURES, out))


def _is_webp(buf: bytes) -> bool:
    return buf[:4] == b"RIFF" and buf[8:12] == b"WEBP"


def _png_chunks(buf: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(buf):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        crc = buf[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {tag!r}")
        if zlib.crc32(tag + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: PNG chunk {tag!r} fails its CRC")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n


def png_text(path: str) -> dict:
    """The text chunks of a PNG (``tEXt``, and ``iTXt`` stored uncompressed):
    keyword -> value."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    out = {}
    for tag, body in _png_chunks(buf, path):
        if tag == b"tEXt":
            key, _, value = body.partition(b"\0")
            out[key.decode("latin-1")] = value.decode("latin-1")
        elif tag == b"iTXt":
            key, _, rest = body.partition(b"\0")
            if rest[:1] == b"\0":  # not compressed; skip method, language, translated key
                _, _, rest = rest[2:].partition(b"\0")
                _, _, value = rest.partition(b"\0")
                out[key.decode("latin-1")] = value.decode("utf-8")
    return out


def _decode_png(buf: bytes, path: str) -> np.ndarray:
    header, palette, idat = None, np.zeros((256, 3), np.uint8), []
    for tag, body in _png_chunks(buf, path):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            if len(body) % 3 or len(body) > 768:
                raise ValueError(f"{path}: PNG palette of {len(body)} bytes")
            palette[:len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, compression, filtering, interlace = header
    if compression or filtering or interlace > 1 or not w or not h:
        raise ValueError(f"{path}: PNG header {header} is not a standard PNG's")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data does not inflate ({e})") from e
    raw_arr = np.frombuffer(raw, np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    lib = library.load()
    _check(lib, lib.gl_png_unfilter(_ptr(raw_arr), raw_arr.size, w, h, depth, ctype, interlace,
                                    _ptr(palette), _ptr(out)), path)
    return out


def _decode_bmp(buf: bytes, path: str) -> np.ndarray:
    """Uncompressed 24- and 32-bit BMP, and 8-bit with a palette."""
    if len(buf) < 54:
        raise ValueError(f"{path}: truncated BMP")
    offset, header_size = struct.unpack("<I I", buf[10:18])
    if header_size < 40:
        raise ValueError(f"{path}: BMP with a {header_size}-byte (OS/2) header is not supported")
    w, h, _, bits, compression = struct.unpack("<i i H H I", buf[18:34])
    colors = struct.unpack("<I", buf[46:50])[0]
    if compression != 0 or bits not in (8, 24, 32):
        raise ValueError(f"{path}: BMP of {bits} bits with compression {compression} is not "
                         "supported (uncompressed 8-, 24- and 32-bit only)")
    rows = abs(h)
    stride = (w * bits + 31) // 32 * 4
    need = offset + stride * rows
    if w <= 0 or rows == 0 or len(buf) < need:
        raise ValueError(f"{path}: truncated BMP")
    px = np.frombuffer(buf, np.uint8, stride * rows, offset).reshape(rows, stride)
    if h > 0:
        px = px[::-1]  # bottom-up rows
    if bits == 8:
        n = colors or 256
        table = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(buf, np.uint8, 4 * n, 14 + header_size).reshape(n, 4)
        table[:n] = pal[:, 2::-1]
        return np.ascontiguousarray(table[px[:, :w]])
    step = bits // 8
    return np.ascontiguousarray(px[:, :w * step].reshape(rows, w, step)[:, :, 2::-1])


def decode_rgb(path: str) -> np.ndarray:
    """The file's pixels as uint8 ``[H, W, 3]``, the format told by its
    first bytes (as Pillow tells it)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"\xff\xd8":
        return _decode_jpeg(buf, path)
    if buf[:8] == PNG_SIGNATURE:
        return _decode_png(buf, path)
    if buf[:2] == b"BM":
        return _decode_bmp(buf, path)
    if _is_webp(buf):
        return np.ascontiguousarray(_decode_webp(buf, path)[:, :, :3])
    raise ValueError(f"{path}: not a JPEG, PNG, BMP or WebP file")


def crop(u8: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """Pillow's ``crop((left, top, right, bottom))`` of a box inside the image."""
    left, top, right, bottom = box
    if not (0 <= left <= right <= u8.shape[1] and 0 <= top <= bottom <= u8.shape[0]):
        raise ValueError(f"crop box {box} is not inside the {u8.shape[1]}x{u8.shape[0]} image")
    return u8[top:bottom, left:right]


def center_square(u8: np.ndarray) -> np.ndarray:
    """The reference loaders' center crop to the short side."""
    h, w = u8.shape[:2]
    s = min(w, h)
    return crop(u8, ((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))


def _bilinear(x: float) -> float:
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` of Resample.c, in
    the same double-precision steps: ``(first input index [out], int32
    weights [out, taps])``, read-only (the cache shares them)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int32)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bilinear((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        for x, v in enumerate(k):
            v = v / ww if ww != 0.0 else v
            weights[xx, x] = int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0 else \
                int(0.5 + v * (1 << PRECISION_BITS))
        first[xx] = xmin
    first.setflags(write=False)
    weights.setflags(write=False)
    return first, weights


def _resample(u8: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis``. The sums are exact in int32, as Pillow's
    are: the weights of an output add up to about 2^22, so a sum stays
    below 256 * 2^22 + 2^21."""
    in_size = u8.shape[axis]
    first, weights = _coefficients(in_size, out_size)
    acc = np.full(u8.shape[:axis] + (out_size,) + u8.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int32)
    shape = [1] * u8.ndim
    shape[axis] = out_size
    tap = np.empty_like(acc)
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, in_size - 1)
        np.multiply(np.take(u8, idx, axis=axis), weights[:, t].reshape(shape), out=tap)
        acc += tap
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(u8: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's ``resize((width, height), Image.BILINEAR)`` of a uint8
    ``[H, W, C]`` image."""
    out = np.ascontiguousarray(u8)
    if width != out.shape[1]:
        out = _resample(out, width, 1)
    if height != out.shape[0]:
        out = _resample(out, height, 0)
    return out if out is not u8 else out.copy()


def to_float_div(u8: np.ndarray) -> np.ndarray:
    """The reference folder loaders' ``float32(u8) / 127.5 - 1.0``."""
    return u8.astype(np.float32) / np.float32(127.5) - np.float32(1.0)


def load_square(path: str, size: int) -> np.ndarray:
    """Decode, center-crop to the short side and resize to ``size`` x
    ``size`` (the reference folder loaders' and prepack tool's uint8)."""
    sq = center_square(decode_rgb(path))
    if sq.shape[:2] != (size, size):
        sq = resize_bilinear(sq, size, size)
    return sq


def load_halves(path: str, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a combined A|B image, split it at ``w // 2`` and resize each
    half to ``size`` x ``size``: the uint8 (A, B) of the reference's paired
    loader and ``--paired`` prepack."""
    img = decode_rgb(path)
    w = img.shape[1] // 2
    return resize_bilinear(img[:, :w], size, size), resize_bilinear(img[:, w:], size, size)
