"""Sample-grid writer (port of ``gan_lib_tensorflow_tpu/utils/images.py``).

The reference writes the PNG through PIL; this one writes it with the
standard library alone (``zlib`` + ``struct``: IHDR, one IDAT, IEND, filter
byte 0 on every row), so nothing on the sampling path needs Pillow.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (grey, RGB, RGBA)


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(x, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _text_chunk(key: str, value: str) -> bytes:
    """``tEXt`` (Latin-1) when the value encodes so, else uncompressed ``iTXt`` (UTF-8)."""
    try:
        return _chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1"))
    except UnicodeEncodeError:
        return _chunk(b"iTXt", key.encode("latin-1") + b"\0\0\0\0\0" + value.encode("utf-8"))


def png_bytes(image: np.ndarray, text: Optional[Dict[str, str]] = None) -> bytes:
    """An 8-bit PNG of a uint8 ``[H, W, C]`` image, C in (1, 3, 4); ``text``
    (keyword -> value, e.g. ``Title``, ``Description``) adds one text chunk
    each before the image data."""
    h, w, c = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),  # filter type 0 (None)
                           np.ascontiguousarray(image).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    notes = b"".join(_text_chunk(k, v) for k, v in (text or {}).items())
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header) + notes
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, rows: Optional[int] = None) -> None:
    """Tile ``[N, H, W, C]`` (float in [-1, 1] or uint8) into a grid PNG."""
    images = np.asarray(images)
    if images.dtype != np.uint8:
        images = to_uint8(images)
    n, h, w, c = images.shape
    rows = rows or int(math.ceil(math.sqrt(n)))
    cols = int(math.ceil(n / rows))
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(n):
        r, cc = divmod(i, cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = images[i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(grid))
