"""Write the WebP files under this directory and their manifest.

Run from the repository root, with Pillow built with libwebp (Pillow
12.1.0 and libwebp 1.6.0 wrote the committed ones):
    python tests/torch_fixtures/webp/make_fixtures.py

Most files are Pillow's ``save``: lossy at several ``quality``/``method``
settings, lossless with and without ``exact``, RGBA lossy with an alpha
quality, a flat image (skipped macroblocks), palette images of 2, 4, 16
and 200 colors (pixel bundling of 8, 4
and 2 pixels per byte, then none), a two-frame animation whose second
frame is smaller, and lossless textures and channels correlated with green
(the encoder then uses more predictor modes, and subtract-green). What
Pillow does not expose is encoded by calling
libwebp's ``WebPEncode`` (the library Pillow bundles) through ``ctypes``
with a ``WebPConfig``: the simple loop filter (``filter_type 0``), 2, 4 and
8 token partitions, one segment, a filter sharpness, each alpha filter and
uncompressed alpha. One file is corrupt: bit flips of a lossy one that
Pillow still decodes, to garbage. An animation whose first frame (ALPH and VP8) covers
part of the canvas is assembled by hand. Sizes include 1x1, 17x13 and
67x45, so partial macroblocks and odd chroma widths are decoded.

``manifest.json`` holds, for each file, the shape and the sha256 of
``np.asarray(Image.open(path).convert("RGB"))`` and of its ``"RGBA"``
conversion, and the parts of the format the port's decoder met in it
(``data/codec.py:webp_features``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth RGB scene with noise: every intra mode and token kind occurs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 7.0 + seed), 128 + 90 * np.cos(y / 5.0 - x / 11.0),
                    (x * y / 3.0 + 40 * seed) % 256], -1)
    return np.clip(img + rng.normal(0, 18, img.shape), 0, 255).astype(np.uint8)


def textures(h: int, w: int, seed: int) -> np.ndarray:
    """Products, sums and differences of the coordinates: the lossless
    encoder picks most of its predictor modes on these."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([(x * y * (1 + seed % 3)) % 256, (x * 3 + y * (7 + seed)) % 256,
                    np.abs(x - y) * (4 + seed) % 256], -1)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


def correlated(h: int, w: int, seed: int) -> np.ndarray:
    """Channels that follow green: the subtract-green transform pays."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    g = 128 + 60 * np.sin(x / 9) * np.cos(y / 13) + 30 * np.sin((x + y) / 5) + rng.normal(0, 6, (h, w))
    img = np.stack([g + 10 + rng.normal(0, 2, (h, w)), g, g - 15 + rng.normal(0, 2, (h, w))], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def alpha_plane(h: int, w: int, kind: str) -> np.ndarray:
    """An alpha plane on which libwebp's alpha encoder picks the filter
    named (none for "rings", horizontal for "steps")."""
    rng = np.random.default_rng(h * w)
    y, x = np.mgrid[0:h, 0:w]
    columns, rows = rng.integers(0, 120, w), rng.integers(0, 120, h)
    plane = {"vertical": np.tile(rng.integers(0, 256, w), (h, 1)) + rng.integers(0, 3, (h, w)),
             "gradient": columns[None, :] + rows[:, None],
             "rings": ((x - w / 2) ** 2 + (y - h / 2) ** 2) % 200,
             "steps": np.where(x < w // 2, 128, 255) - (y % 4) * 9}[kind]
    return np.asarray(plane).astype(np.uint8)


def riff_chunks(data: bytes) -> list:
    """``[(tag, payload)]`` of a WebP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + len(payload).to_bytes(4, "little") + payload + b"\0" * (len(payload) & 1)


def animation(canvas: tuple, frames: list) -> bytes:
    """An animated WebP of ``frames`` (``(x, y, width, height, chunks)``,
    x and y even) on a ``(width, height)`` canvas, assembled by hand: frame
    0 may leave part of the canvas uncovered, which Pillow's encoder never
    does."""
    w, h = canvas
    vp8x = bytes([0x02 | 0x10, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + \
        (h - 1).to_bytes(3, "little")
    body = chunk(b"VP8X", vp8x) + chunk(b"ANIM", bytes(4) + (0).to_bytes(2, "little"))
    for x, y, fw, fh, parts in frames:
        head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, fw - 1, fh - 1, 100))
        body += chunk(b"ANMF", head + b"\x02" + b"".join(chunk(t, p) for t, p in parts))
    return b"RIFF" + (len(body) + 4).to_bytes(4, "little") + b"WEBP" + body


class _Config(ctypes.Structure):  # encode.h WebPConfig (libwebp 1.6), padded
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR") else ctypes.c_int)
                for name in ("lossless", "quality", "method", "image_hint", "target_size",
                             "target_PSNR", "segments", "sns_strength", "filter_strength",
                             "filter_sharpness", "filter_type", "autofilter",
                             "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
                             "show_compressed", "preprocessing", "partitions",
                             "partition_limit", "emulate_jpeg_size", "thread_level",
                             "low_memory", "near_lossless", "exact", "use_delta_palette",
                             "use_sharp_yuv", "qmin", "qmax")] + [("pad", ctypes.c_uint32 * 16)]


class _Picture(ctypes.Structure):  # encode.h WebPPicture
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
                ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2)]


class _MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


def _libwebp():
    import PIL
    found = os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs")
    libs = glob.glob(os.path.join(found, "libwebp-*.so*"))
    if not libs:
        raise SystemExit("no libwebp bundled with Pillow")
    for dep in glob.glob(os.path.join(found, "libsharpyuv-*.so*")):  # its dependency
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(libs[0])


def encode(lib, pixels: np.ndarray, **options) -> bytes:
    """``WebPEncode`` of RGB or RGBA ``pixels`` (a simple file, or VP8X
    with ALPH) with ``WebPConfig`` fields set from ``options``."""
    config = _Config()
    abi = 0x0200  # WEBP_ENCODER_ABI_VERSION's major: only it is checked
    if not lib.WebPConfigInitInternal(ctypes.byref(config), 0, ctypes.c_float(75.0), abi):
        raise RuntimeError("WebPConfigInit")
    for name, value in options.items():
        setattr(config, name, value)
    if not lib.WebPValidateConfig(ctypes.byref(config)):
        raise RuntimeError(f"invalid WebPConfig {options}")
    pic = _Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), abi):
        raise RuntimeError("WebPPictureInit")
    assert pic.writer and not pic.custom_ptr and not pic.argb, "WebPPicture layout"
    h, w, c = pixels.shape
    pic.width, pic.height, pic.use_argb = w, h, int(bool(config.lossless))
    pixels = np.ascontiguousarray(pixels)
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    if not importer(ctypes.byref(pic), pixels.ctypes.data_as(ctypes.c_void_p), w * c):
        raise RuntimeError("WebPPictureImport")
    writer = _MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), ctypes.c_void_p).value
    try:
        if not lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed ({pic.error_code})")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


def flip_vp8_bits(data: bytes, flips) -> bytes:
    """``data`` with the bits ``mask`` of the bytes at ``offset`` (from the
    start of the VP8 chunk's payload) flipped, for each ``(offset, mask)``."""
    out = bytearray(data)
    start = data.index(b"VP8 ") + 8
    for offset, mask in flips:
        out[start + offset] ^= mask
    return bytes(out)


def fixtures() -> dict:
    """``{file name: bytes}``."""
    import io

    from PIL import Image

    def pillow(img, **kw) -> bytes:
        buf = io.BytesIO()
        img.save(buf, "WEBP", **kw)
        return buf.getvalue()

    lib = _libwebp()
    out = {}
    big = photo(256, 256, 1)
    out["lossy_256_q75.webp"] = pillow(Image.fromarray(big), quality=75)
    out["lossless_256.webp"] = pillow(Image.fromarray(correlated(256, 256, 3) // 4 * 4),
                                      lossless=True)
    for q, m in ((5, 0), (50, 4), (95, 6), (100, 2)):
        out[f"lossy_q{q}_m{m}_67x45.webp"] = pillow(Image.fromarray(photo(45, 67, q)),
                                                     quality=q, method=m)
    out["lossy_1x1.webp"] = pillow(Image.fromarray(photo(1, 1, 3)), quality=80)
    flat = np.full((48, 64, 3), 120, np.uint8)  # flat macroblocks: skipped (methods 0-2)
    flat[8:24, 16:40] = photo(16, 24, 24)
    out["lossy_flat_skips.webp"] = pillow(Image.fromarray(flat), quality=60, method=2)
    out["lossy_17x13.webp"] = pillow(Image.fromarray(photo(13, 17, 4)), quality=60)
    for exact in (False, True):
        rgba = np.dstack([photo(45, 67, 5), alpha_plane(45, 67, "steps")])
        rgba[:10, :10, 3] = 0  # RGB under alpha 0: kept only with exact
        out[f"lossless_rgba_exact{int(exact)}.webp"] = pillow(
            Image.fromarray(rgba, "RGBA"), lossless=True, exact=exact)
    out["lossless_m6_17x13.webp"] = pillow(Image.fromarray(photo(13, 17, 6)), lossless=True,
                                           method=6, quality=100)
    out["lossless_1x1.webp"] = pillow(Image.fromarray(photo(1, 1, 7)), lossless=True)
    out["lossy_alpha_q50.webp"] = pillow(Image.fromarray(
        np.dstack([photo(45, 67, 8), alpha_plane(45, 67, "rings")]), "RGBA"),
        quality=70, alpha_quality=50)
    for n in (2, 4, 16, 200):
        pal = Image.fromarray(photo(45, 67, 9)).quantize(n).convert("RGB")
        out[f"palette{n}.webp"] = pillow(pal, lossless=True)
    frames = [Image.fromarray(photo(45, 67, 10)),
              Image.fromarray(np.pad(photo(20, 30, 11), ((10, 15), (20, 17), (0, 0)), mode="edge"))]
    out["animation_2frames.webp"] = pillow(frames[0], save_all=True, append_images=frames[1:],
                                           duration=[50, 50], lossless=False, quality=80)
    alpha_frame = riff_chunks(encode(lib, np.dstack([photo(20, 30, 22),
                                                     alpha_plane(20, 30, "rings")]), quality=70.0))
    lossless_frame = riff_chunks(pillow(Image.fromarray(photo(45, 67, 23)), lossless=True))
    out["animation_offset_frame.webp"] = animation((67, 45), [
        (10, 6, 30, 20, [c for c in alpha_frame if c[0] in (b"ALPH", b"VP8 ")]),
        (0, 0, 67, 45, lossless_frame)])
    out["lossless_textures.webp"] = pillow(Image.fromarray(textures(96, 80, 2)), lossless=True,
                                           method=6, quality=100)
    out["lossless_correlated.webp"] = pillow(Image.fromarray(correlated(64, 64, 3)),
                                             lossless=True, method=6, quality=100)
    # WebPEncode options Pillow does not expose
    src = photo(45, 67, 12)
    out["lossy_simple_filter.webp"] = encode(lib, src, quality=60.0, filter_type=0,
                                             filter_strength=60)
    for parts in (1, 2, 3):  # the encoder honours partitions in its low-memory mode
        out[f"lossy_partitions{1 << parts}.webp"] = encode(
            lib, photo(70, 67, 13 + parts), quality=70.0, partitions=parts, low_memory=1)
    out["lossy_one_segment.webp"] = encode(lib, src, quality=40.0, segments=1)
    out["lossy_sharpness5.webp"] = encode(lib, src, quality=30.0, filter_sharpness=5,
                                          filter_strength=80)
    out["lossy_no_filter.webp"] = encode(lib, src, quality=50.0, filter_strength=0)
    # three bit flips in the frame header of the 2-partition file: its token
    # partition then reads as all ones, the Y2 DC of the first macroblock
    # overflows 16 bits (2114 * 38), and libwebp's sign read (VP8GetSigned)
    # parts from a plain boolean read; Pillow decodes the garbage
    out["corrupt_y2_overflow.webp"] = flip_vp8_bits(
        out["lossy_partitions2.webp"], ((22, 0x02), (23, 0x40), (36, 0x04)))
    for kind, filtering in (("steps", 2), ("vertical", 1), ("gradient", 1), ("rings", 0)):
        rgba = np.dstack([photo(45, 67, 20), alpha_plane(45, 67, kind)])
        out[f"alpha_{kind}.webp"] = encode(lib, rgba, quality=60.0, alpha_filtering=filtering)
    out["alpha_uncompressed.webp"] = encode(
        lib, np.dstack([photo(13, 17, 21), alpha_plane(13, 17, "gradient")]), quality=60.0,
        alpha_compression=0, alpha_filtering=0)
    return out


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def manifest(names) -> dict:
    from PIL import Image, features

    from gan_lib_tensorflow_tpu_torch.data import codec
    entries = {}
    for name in sorted(names):
        path = os.path.join(HERE, name)
        rgb = np.asarray(Image.open(path).convert("RGB"))
        rgba = np.asarray(Image.open(path).convert("RGBA"))
        entries[name] = {"shape": list(rgb.shape), "rgb_sha256": digest(rgb),
                         "rgba_sha256": digest(rgba), "features": codec.webp_features(path)}
    import PIL
    return {"pillow": PIL.__version__, "libwebp": features.version("webp"), "files": entries}


def main() -> None:
    for path in glob.glob(os.path.join(HERE, "*.webp")):
        os.remove(path)
    files = fixtures()
    for name, data in files.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest(files), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(files)} files, {sum(len(d) for d in files.values())} bytes")


if __name__ == "__main__":
    main()
