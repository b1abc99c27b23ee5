"""The port's image decoder and resize (``data/codec.py`` and its C++ library
``csrc/imgcodec.cpp``, built here with the host compiler) against Pillow, on
the CPU: bit-equal, with no tolerance.

- JPEG: baseline and progressive at quality 50 and 95; 4:4:4, 4:2:2, 4:2:0,
  grey, Adobe RGB, CMYK; restart intervals; sizes that are no multiple of 8
  or 16 (1x1, 17x9, 333x257); optimized Huffman tables. 4:4:0, 4:1:1, YCCK,
  un-inverted CMYK and RGB told by its component ids, which Pillow does not
  write, come from a minimal baseline encoder here (``encode_jpeg``).
- PNG: every colour type and bit depth (1/2/4/8-bit grey and palette, 16-bit
  grey, RGB, RGBA, grey+alpha in 8 and 16 bits), plain and Adam7, every row
  filter, written by the encoder here (``encode_png``: Pillow writes no
  interlaced PNG), and Pillow's own files.
- BMP: 24- and 32-bit, 8-bit palette and grey, Pillow's files.
- Refused, each with its path in the ``ValueError``: arithmetic coding,
  12-bit, lossless and hierarchical frames, a DNL height, a truncated JPEG, a
  progressive JPEG cut before its last refinements (libjpeg would smooth
  it), a truncated WebP (WebP itself: ``test_torch_webp.py``), compressed
  BMP, a PNG with a broken CRC or short data, an unknown format.
- ``resize_bilinear``: bit-equal to Pillow's ``BILINEAR`` over drawn sizes,
  down, up and unchanged on each axis; ``to_float_div`` equal to the
  reference's float32 expression for every byte, and different from
  ``normalize_u8`` for 205 of the 256.
"""

import io
import itertools
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from gan_lib_tensorflow_tpu_torch.data import codec, normalize_u8

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _scene(h, w, seed=0, channels=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = [128 + 90 * np.sin(x / 5.0 + seed), 128 + 90 * np.cos(y / 4.0), (x * 3 + y * 5) % 256,
            (x * y) % 256]
    img = np.stack(base[:channels], -1) + rng.normal(0, 18, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pillow(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _assert_decodes_as_pillow(path):
    got, want = codec.decode_rgb(str(path)), _pillow(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.count_nonzero(got != want) == 0, f"{path}: {np.count_nonzero(got != want)} bytes"


# ---------------------------------------------------------------- JPEG


SIZES = [(1, 1), (9, 17), (257, 333), (8, 8), (2, 3), (33, 1)]


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_sampling_and_progression_match_pillow(tmp_path, h, w, quality):
    img = Image.fromarray(_scene(h, w, h + w))
    for sampling, progressive in itertools.product(("4:4:4", "4:2:2", "4:2:0"),
                                                   (False, True)):
        p = tmp_path / f"{sampling.replace(':', '')}_{int(progressive)}.jpg"
        img.save(p, quality=quality, subsampling=sampling, progressive=progressive)
        _assert_decodes_as_pillow(p)


@pytest.mark.parametrize("h,w", SIZES)
def test_jpeg_grey_restart_rgb_cmyk_optimized_match_pillow(tmp_path, h, w):
    img = Image.fromarray(_scene(h, w, 3 * h + w))
    cases = {
        "grey": (img.convert("L"), dict(quality=75)),
        "grey_progressive": (img.convert("L"), dict(quality=50, progressive=True)),
        "restart_blocks": (img, dict(quality=90, restart_marker_blocks=3)),
        "restart_rows_progressive": (img, dict(quality=60, restart_marker_rows=1,
                                               progressive=True, subsampling="4:2:0")),
        "adobe_rgb": (img, dict(quality=85, keep_rgb=True)),
        "cmyk": (img.convert("CMYK"), dict(quality=80)),
        "cmyk_progressive": (img.convert("CMYK"), dict(quality=80, progressive=True)),
        "optimized": (img, dict(quality=70, optimize=True)),
    }
    for name, (im, kw) in cases.items():
        im.save(tmp_path / f"{name}.jpg", **kw)
        _assert_decodes_as_pillow(tmp_path / f"{name}.jpg")


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _magnitude(v):
    return (0, 0) if v == 0 else (int(abs(v)).bit_length(),
                                  v if v > 0 else v + (1 << int(abs(v)).bit_length()) - 1)


def encode_jpeg(planes, factors, ids=(1, 2, 3, 4), markers=b"", restart=0, quant=8):
    """A minimal baseline JPEG: full-resolution ``planes`` (uint8 [H, W]
    each) averaged down by each component's ``factors`` (h, v) against the
    largest, a flat quantizer, Huffman tables with a code of fixed length
    per symbol (4 bits for DC classes, 8 for AC run/size), one interleaved
    scan, ``markers`` (e.g. an APP14) after SOI."""
    h_img, w_img = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    n = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    comps = []
    for plane, (fh, fv) in zip(planes, factors):
        sh, sv = hmax // fh, vmax // fv
        full = np.pad(plane.astype(np.float64), ((0, mcuy * 8 * vmax - h_img),
                                                  (0, mcux * 8 * hmax - w_img)), mode="edge")
        comps.append(full.reshape(full.shape[0] // sv, sv, full.shape[1] // sh, sh).mean((1, 3)))
    ac_symbols = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    dc_code = {s: s for s in range(12)}
    ac_code = {s: i for i, s in enumerate(ac_symbols)}
    bits, preds = _Bits(), [0] * len(planes)
    for m in range(mcux * mcuy):
        if restart and m and m % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            preds = [0] * len(planes)
        my, mx = divmod(m, mcux)
        for c, (fh, fv) in enumerate(factors):
            for by in range(fv):
                for bx in range(fh):
                    y0, x0 = (my * fv + by) * 8, (mx * fh + bx) * 8
                    coef = dct @ (comps[c][y0:y0 + 8, x0:x0 + 8] - 128) @ dct.T
                    zz = np.rint(coef.reshape(-1)[NATURAL] / quant).astype(int)
                    diff, preds[c] = zz[0] - preds[c], zz[0]
                    size, value = _magnitude(diff)
                    bits.put(dc_code[size], 4)
                    bits.put(value, size)
                    run = 0
                    for k in range(1, 64):
                        if zz[k] == 0:
                            run += 1
                            continue
                        while run > 15:
                            bits.put(ac_code[0xF0], 8)
                            run -= 16
                        size, value = _magnitude(zz[k])
                        bits.put(ac_code[(run << 4) | size], 8)
                        bits.put(value, size)
                        run = 0
                    if run:
                        bits.put(ac_code[0x00], 8)
    bits.flush()

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    dqt = bytes([0]) + bytes([quant] * 64)
    sof = struct.pack(">BHHB", 8, h_img, w_img, len(planes)) + b"".join(
        bytes([ids[c], (f[0] << 4) | f[1], 0]) for c, f in enumerate(factors))
    dht = (bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12))
           + bytes([0x10]) + bytes([0] * 7 + [len(ac_symbols)] + [0] * 8) + bytes(ac_symbols))
    sos = bytes([len(planes)]) + b"".join(bytes([ids[c], 0]) for c in range(len(planes))) \
        + bytes([0, 63, 0])
    dri = seg(0xDD, struct.pack(">H", restart)) if restart else b""
    return (b"\xff\xd8" + markers + seg(0xDB, dqt) + seg(0xC0, sof) + seg(0xC4, dht) + dri
            + seg(0xDA, sos) + bytes(bits.out) + b"\xff\xd9")


def _adobe(transform):
    """An APP14 "Adobe" segment: version 100, no flags, the transform."""
    return b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                                                     transform])


@pytest.mark.parametrize("h,w", [(1, 1), (9, 17), (40, 37), (64, 48)])
@pytest.mark.parametrize("name,factors,ids,markers,restart", [
    ("440", [(1, 2), (1, 1), (1, 1)], (1, 2, 3), b"", 0),
    ("440_restart", [(1, 2), (1, 1), (1, 1)], (1, 2, 3), b"", 2),
    ("411", [(4, 1), (1, 1), (1, 1)], (1, 2, 3), b"", 0),
    ("420_by_ids", [(2, 2), (1, 1), (1, 1)], (1, 2, 3), b"", 1),
    ("rgb_by_ids", [(1, 1), (1, 1), (1, 1)], (82, 71, 66), b"", 0),
    ("ycck", [(2, 2), (1, 1), (1, 1), (2, 2)], (1, 2, 3, 4), "adobe2", 0),
    ("cmyk_adobe0", [(1, 1), (1, 1), (1, 1), (1, 1)], (1, 2, 3, 4), "adobe0", 0),
    ("cmyk_no_adobe", [(1, 1), (1, 1), (1, 1), (1, 1)], (1, 2, 3, 4), b"", 3),
])
def test_jpeg_modes_pillow_does_not_write_match_pillow(tmp_path, h, w, name, factors, ids,
                                                       markers, restart):
    planes = list(_scene(h, w, h * w, channels=len(factors)).transpose(2, 0, 1))
    if isinstance(markers, str):
        markers = _adobe(int(markers[-1]))
    path = tmp_path / f"{name}.jpg"
    path.write_bytes(encode_jpeg(planes, factors, ids, markers, restart))
    _assert_decodes_as_pillow(path)


def _frame(tmp_path, sof=None, precision=None, height=None, name="x.jpg"):
    b = io.BytesIO()
    Image.fromarray(_scene(16, 16)).save(b, "JPEG", quality=80)
    buf = bytearray(b.getvalue())
    at = buf.index(b"\xff\xc0")
    if sof is not None:
        buf[at + 1] = sof
    if precision is not None:
        buf[at + 4] = precision
    if height is not None:
        buf[at + 5:at + 7] = struct.pack(">H", height)
    path = tmp_path / name
    path.write_bytes(bytes(buf))
    return path


@pytest.mark.parametrize("kind,edit,reason", [
    ("arithmetic", dict(sof=0xC9), "arithmetic"),
    ("arithmetic_progressive", dict(sof=0xCA), "arithmetic"),
    ("twelve_bit", dict(sof=0xC1, precision=12), "precision"),
    ("lossless", dict(sof=0xC3), "lossless"),
    ("hierarchical", dict(sof=0xC5), "hierarchical"),
    ("dnl_height", dict(height=0), "DNL"),
])
def test_jpeg_kinds_without_support_raise_with_their_path(tmp_path, kind, edit, reason):
    path = _frame(tmp_path, name=f"{kind}.jpg", **edit)
    with pytest.raises(ValueError, match=reason) as e:
        codec.decode_rgb(str(path))
    assert str(path) in str(e.value)


@pytest.mark.parametrize("kind,counts", [
    ("overfull", [255] + [0] * 15),  # 255 one-bit codes: far past the lookahead tables
    ("all_ones", [2] + [0] * 15),    # codes 0 and 1: libjpeg refuses an all-ones code
    ("overfull_long", [0, 3, 4, 9] + [0] * 12),  # 4 two-bit codes can hold only 3
])
def test_jpeg_huffman_table_that_overfills_its_code_space_raises(tmp_path, kind, counts):
    b = io.BytesIO()
    Image.fromarray(_scene(16, 16)).save(b, "JPEG", quality=80)
    buf = b.getvalue()
    at = buf.index(b"\xff\xda")
    body = bytes([0x00]) + bytes(counts) + bytes(range(sum(counts)))  # DC table 0
    dht = b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(buf[:at] + dht + buf[at:])
    with pytest.raises(OSError):  # libjpeg refuses the table too
        _pillow(path)
    with pytest.raises(ValueError, match="Huffman") as e:
        codec.decode_rgb(str(path))
    assert str(path) in str(e.value)


def test_truncated_and_unrefined_jpegs_raise_with_their_path(tmp_path):
    b = io.BytesIO()
    Image.fromarray(_scene(64, 64)).save(b, "JPEG", quality=90, progressive=True)
    full = b.getvalue()
    for name, body in (("truncated.jpg", full[:len(full) // 2]),
                       ("no_eoi.jpg", full[:-2])):  # Pillow refuses both
        cut = tmp_path / name
        cut.write_bytes(body)
        with pytest.raises(ValueError, match="truncated") as e:
            codec.decode_rgb(str(cut))
        assert str(cut) in str(e.value)
    # libjpeg's simple progression: the 8th scan starts the last AC
    # refinements; without them libjpeg smooths the blocks
    sos = [i for i in range(len(full) - 1) if full[i:i + 2] == b"\xff\xda"]
    assert len(sos) == 10
    early = tmp_path / "unrefined.jpg"
    early.write_bytes(full[:sos[7]] + b"\xff\xd9")
    with pytest.raises(ValueError, match="unrefined") as e:
        codec.decode_rgb(str(early))
    assert str(early) in str(e.value)


def test_other_formats_raise_with_their_path(tmp_path):
    webp = io.BytesIO()
    Image.fromarray(_scene(8, 8)).save(webp, "WEBP", quality=80)
    cases = {"a.webp": webp.getvalue()[:-7],  # a WebP cut short
             "b.gif": b"GIF89a" + bytes(20),
             "c.png": b"\x89PNG\r\n\x1a\n" + bytes(20)}
    bmp = io.BytesIO()
    Image.fromarray(_scene(8, 8)).quantize(colors=16).save(bmp, "BMP")
    rle = bytearray(bmp.getvalue())
    rle[30:34] = struct.pack("<I", 1)  # BI_RLE8
    cases["d.bmp"] = bytes(rle)
    good = io.BytesIO()
    Image.fromarray(_scene(8, 8)).save(good, "PNG")
    crc = bytearray(good.getvalue())
    crc[30] ^= 1  # inside IHDR
    cases["e.png"] = bytes(crc)
    for name, body in cases.items():
        (tmp_path / name).write_bytes(body)
        with pytest.raises(ValueError) as e:
            codec.decode_rgb(str(tmp_path / name))
        assert str(tmp_path / name) in str(e.value)
    assert "truncated WebP" in str(pytest.raises(ValueError, codec.decode_rgb,
                                                 str(tmp_path / "a.webp")).value)


# ---------------------------------------------------------------- PNG

def encode_png(pixels, depth, ctype, interlace=0, palette=None, filters=(0, 1, 2, 3, 4)):
    """A PNG of ``pixels`` (uint [H, W, channels] of the colour type's
    samples at ``depth`` bits), rows filtered by the types of ``filters``
    in turn, Adam7 when ``interlace``."""
    h, w, _ = pixels.shape
    passes = ([(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
               (1, 0, 2, 2), (0, 1, 1, 2)] if interlace else [(0, 0, 1, 1)])
    bpp = max(1, pixels.shape[2] * depth // 8)
    raw, turn = bytearray(), itertools.cycle(filters)
    for x0, y0, dx, dy in passes:
        sub = pixels[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for row in sub:
            if depth == 16:
                line = row.astype(">u2").tobytes()
            elif depth == 8:
                line = row.astype(np.uint8).tobytes()
            else:
                line = np.packbits(np.unpackbits(row.astype(np.uint8).reshape(-1, 1), axis=1)
                                   [:, 8 - depth:].reshape(-1)).tobytes()
            cur = np.frombuffer(line, np.uint8).astype(int)
            up = np.zeros_like(cur) if prev is None else prev
            f = next(turn)
            out = cur.copy()
            for i in range(len(cur)):
                a = cur[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                p = a + up[i] - c
                pred = [0, a, up[i], (a + up[i]) // 2,
                        min((abs(p - a), 0, a), (abs(p - up[i]), 1, up[i]),
                            (abs(p - c), 2, c))[2]][f]
                out[i] = (cur[i] - pred) % 256
            raw += bytes([f]) + bytes(out.astype(np.uint8))
            prev = cur

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += chunk(b"PLTE", bytes(palette.astype(np.uint8).reshape(-1)))
    return (b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


PNG_KINDS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (1, 3), (2, 3), (4, 3), (8, 3),
             (8, 2), (16, 2), (8, 4), (16, 4), (8, 6), (16, 6)]


@pytest.mark.parametrize("depth,ctype", PNG_KINDS)
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_every_colour_type_and_depth_matches_pillow(tmp_path, depth, ctype, interlace):
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(depth * 10 + ctype)
    palette = None
    for h, w in [(1, 1), (5, 3), (9, 17), (13, 8)]:
        top = 2 ** depth
        if ctype == 3:
            n_pal = min(top, 200)
            palette = rng.integers(0, 256, (n_pal, 3))
            px = rng.integers(0, n_pal, (h, w, 1))
        else:
            px = rng.integers(0, top, (h, w, channels))
            if depth == 16 and ctype == 0:
                px[0, 0, 0] = 255  # Pillow clamps 16-bit grey at 255
        path = tmp_path / f"d{depth}c{ctype}i{interlace}_{h}x{w}.png"
        path.write_bytes(encode_png(px, depth, ctype, interlace, palette))
        _assert_decodes_as_pillow(path)


def test_pillow_written_pngs_and_bmps_match_pillow(tmp_path):
    a = _scene(23, 31, 5, channels=4)
    for mode in ("RGB", "RGBA", "L", "LA", "1", "I;16"):
        im = Image.fromarray(a).convert(mode) if mode != "I;16" else \
            Image.fromarray(a[..., 0].astype(np.uint16) * 3)
        im.save(tmp_path / f"{mode.replace(';', '')}.png")
        _assert_decodes_as_pillow(tmp_path / f"{mode.replace(';', '')}.png")
    for bits in (1, 2, 4, 8):
        Image.fromarray(a[..., :3]).quantize(colors=2 ** bits).save(tmp_path / f"p{bits}.png",
                                                                    bits=bits)
        _assert_decodes_as_pillow(tmp_path / f"p{bits}.png")
    bmps = {"rgb.bmp": Image.fromarray(a[..., :3]), "rgbx.bmp": Image.fromarray(a),
            "palette.bmp": Image.fromarray(a[..., :3]).quantize(colors=100),
            "grey.bmp": Image.fromarray(a[..., 0])}
    for name, im in bmps.items():
        im.save(tmp_path / name)
        _assert_decodes_as_pillow(tmp_path / name)


# ---------------------------------------------------------------- resize

@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 220), st.integers(1, 220), st.integers(1, 220), st.integers(1, 220),
       st.integers(0, 2**31 - 1))
def test_resize_bilinear_matches_pillow(h, w, oh, ow, seed):
    a = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    want = np.asarray(Image.fromarray(a).resize((ow, oh), Image.BILINEAR))
    got = codec.resize_bilinear(a, ow, oh)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("src,dst", [((375, 500), (128, 128)), ((256, 256), (286, 286)),
                                     ((300, 300), (128, 128)), ((1024, 1024), (1024, 1024)),
                                     ((257, 333), (64, 64)), ((40, 40), (40, 7)),
                                     ((9, 200), (30, 200))])
def test_resize_bilinear_matches_pillow_at_loader_sizes(src, dst):
    a = _scene(*src, seed=src[0])
    want = np.asarray(Image.fromarray(a).resize(dst[::-1], Image.BILINEAR))
    assert np.array_equal(codec.resize_bilinear(a, dst[1], dst[0]), want)


def test_crop_is_pillows_box():
    a = _scene(30, 41)
    for box in [(0, 0, 41, 30), (5, 2, 36, 29), (10, 0, 10, 30)]:
        assert np.array_equal(codec.crop(a, box), np.asarray(Image.fromarray(a).crop(box)))
    with pytest.raises(ValueError, match="not inside"):
        codec.crop(a, (0, 0, 42, 30))


def test_to_float_div_is_the_references_and_not_normalize_u8():
    u8 = np.arange(256, dtype=np.uint8)
    want = (np.asarray(u8, np.float32) / 127.5) - 1.0
    got = codec.to_float_div(u8)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    fma = normalize_u8(torch.from_numpy(u8)).numpy()
    assert np.count_nonzero(got != fma) == 205


def test_decoders_run_in_parallel_threads(tmp_path):
    """The library keeps no global state: four threads decoding different
    files give each file's own pixels."""
    from concurrent.futures import ThreadPoolExecutor
    paths = []
    for i in range(8):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray(_scene(40 + i, 50, i)).save(p, quality=80, progressive=bool(i % 2))
        paths.append(str(p))
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(codec.decode_rgb, paths * 4))
    for i, g in enumerate(got):
        assert np.array_equal(g, _pillow(paths[i % 8]))


def test_no_host_compiler_is_an_error_naming_the_source(tmp_path, monkeypatch):
    """A build without ``c++`` or ``g++`` raises, naming the file; nothing
    falls back."""
    from gan_lib_tensorflow_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    fresh = cuda_lib.KernelLibrary("imgcodec", lambda lib: None, suffix=".cpp")
    with pytest.raises(RuntimeError, match="imgcodec.cpp"):
        fresh.load()
    assert os.listdir(tmp_path) == []


def test_first_load_from_several_threads_builds_once(tmp_path, monkeypatch):
    """Loader threads that decode their first image together share one
    build of the library."""
    from concurrent.futures import ThreadPoolExecutor

    from gan_lib_tensorflow_tpu_torch.data import codec as codec_mod
    from gan_lib_tensorflow_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path))
    builds, run = [], cuda_lib.subprocess.run
    monkeypatch.setattr(cuda_lib.subprocess, "run",
                        lambda cmd, **kw: builds.append(cmd) or run(cmd, **kw))
    fresh = cuda_lib.KernelLibrary("imgcodec", codec_mod._declare, suffix=".cpp")
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda _: fresh.load(), range(4)))
    assert len(builds) == 1 and all(lib is libs[0] for lib in libs)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
