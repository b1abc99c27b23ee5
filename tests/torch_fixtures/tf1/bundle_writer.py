"""Write a TensorFlow tensor bundle (V2 checkpoint) without TensorFlow:
test scaffolding for the reader ``gan_lib_tensorflow_tpu_torch/tools/
tf1_bundle.py`` on machines with no TensorFlow (``chip_smoke.py`` phase
19). Never imported by the package.

``write_bundle(prefix, tensors)`` writes ``<prefix>.index`` (a LevelDB-format
table: data blocks of prefix-compressed keys with restart points every
``RESTART_INTERVAL`` entries, split near ``block_size`` bytes, an index
block, an empty metaindex block, the footer) and the data files. Options:
``num_shards`` (entries dealt round-robin in key order), ``partitions``
(``{name: k}``: the variable saved as ``k`` slices along dimension 0, as
``tf.compat.v1.fixed_size_partitioner`` cuts it) and ``Bfloat16`` values.
``tests/test_torch_tf1_bundle.py`` holds every kind against
``tf.train.load_checkpoint``. ``tflib_variables`` names a port network's
leaves as a tflib-lineage checkpoint names them.

``write_v1(prefix, tensors, num_shards)`` writes the V1 format
(``SaverDef.V1``): one table file per shard (``<prefix>`` alone, or
``<prefix>-NNNNN-of-NNNNN``), whose empty key holds the
``SavedTensorSlices`` meta and each tensor's one full slice its values in
the ``TensorProto`` field of its dtype. It returns the path
``tf.train.load_checkpoint`` takes (the ``-?????-of-NNNNN`` pattern for
shards). ``digest`` is the manifest's hash of a tensor.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from gan_lib_tensorflow_tpu_torch.convert import flax_view
from gan_lib_tensorflow_tpu_torch.tools.import_tf1_checkpoint import _natkey
from gan_lib_tensorflow_tpu_torch.tools.tf1_bundle import (TABLE_MAGIC, crc32c, mask_crc,
                                                           slice_key)

RESTART_INTERVAL = 16
DT_STRING = 7
# DataType enum numbers of the numeric dtypes a bundle stores (V1 files
# keep to _V1_FIELDS')
_NUMBERS = {np.dtype(np.float32): 1, np.dtype(np.float64): 2, np.dtype(np.int32): 3,
            np.dtype(np.uint8): 4, np.dtype(np.int16): 5, np.dtype(np.int8): 6,
            np.dtype(np.complex64): 8, np.dtype(np.int64): 9, np.dtype(np.bool_): 10,
            np.dtype(np.uint16): 17, np.dtype(np.complex128): 18, np.dtype(np.float16): 19,
            np.dtype(np.uint32): 22, np.dtype(np.uint64): 23}
DT_BFLOAT16 = 14
# tflib's variable suffix of each role of the importer
TFLIB_SUFFIX = {"kernel": "W", "bias": "b", "scale": "gamma", "bn_bias": "beta",
                "mean": "moving_mean", "var": "moving_variance", "u": "u",
                "embedding": "embed"}


def tflib_variables(net, prefix: str, seed: int) -> List[Tuple[str, str, np.ndarray]]:
    """``(tf name, flax path, value)`` for every leaf of the port network
    ``net``: ``{prefix}.{i:02d}.{suffix}`` in natural flax-path order, unit
    normals from ``seed`` (BN variances their magnitudes plus 0.5)."""
    rng = np.random.default_rng(seed)
    leaves = sorted(flax_view(net), key=lambda t: _natkey(t[0]))
    out = []
    for i, (path, _, arr, role) in enumerate(leaves):
        val = rng.standard_normal(arr.shape, dtype=np.float32)
        out.append((f"{prefix}.{i:02d}.{TFLIB_SUFFIX[role]}", path,
                    np.abs(val) + np.float32(0.5) if role == "var" else val))
    return out


def digest(value: np.ndarray) -> str:
    """The manifest's sha256 of a tensor as ``tf.train.load_checkpoint``
    returns it: its bytes (bfloat16 widened to float32), or for strings
    each element's length as 8 little-endian bytes and then its bytes."""
    if value.dtype == object or value.dtype.kind == "S":
        raw = b"".join(len(b).to_bytes(8, "little") + b for b in value.ravel().tolist())
    else:
        raw = np.ascontiguousarray(value.astype(np.float32) if value.dtype.name == "bfloat16"
                                   else value).tobytes()
    return hashlib.sha256(raw).hexdigest()


class Bfloat16:
    """float32 values stored as bfloat16 (rounded to nearest even)."""

    def __init__(self, values):
        bits = np.ascontiguousarray(values, np.float32).view(np.uint32).astype(np.uint64)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
        self.bits = bits.astype(np.uint16)
        self.shape = self.bits.shape

    def widened(self) -> np.ndarray:
        return (self.bits.astype(np.uint32) << 16).view(np.float32)


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, value, wire: int = 0) -> bytes:
    tag = _varint(number << 3 | wire)
    if wire == 0:
        return tag + _varint(value)
    if wire == 2:
        return tag + _varint(len(value)) + value
    return tag + int(value).to_bytes(4, "little")  # wire 5, fixed32


def _shape_proto(shape) -> bytes:
    return b"".join(_field(2, _field(1, n) if n else b"", 2) for n in shape)


def _entry(dtype: int, shape, shard: int = 0, offset: int = 0, size: int = 0,
           crc: Optional[int] = None, slices: Optional[List[List[Tuple[int, int]]]] = None
           ) -> bytes:
    out = _field(1, dtype) + _field(2, _shape_proto(shape), 2)
    if shard:
        out += _field(3, shard)
    if offset:
        out += _field(4, offset)
    if size:
        out += _field(5, size)
    if crc is not None:
        out += _field(6, crc, 5)
    for extents in slices or ():
        ext = b""
        for start, length in extents:
            body = (_field(1, start) if start else b"") + (_field(2, length) if length >= 0 else b"")
            ext += _field(1, body, 2)
        out += _field(7, ext, 2)
    return out


def _block(entries: List[Tuple[bytes, bytes]], interval: int) -> bytes:
    out, restarts, last = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % interval:
            while shared < min(len(key), len(last)) and key[shared] == last[shared]:
                shared += 1
        else:
            restarts.append(len(out))
        out += _varint(shared) + _varint(len(key) - shared) + _varint(len(value))
        out += key[shared:] + value
        last = key
    for r in restarts or [0]:
        out += r.to_bytes(4, "little")
    out += len(restarts or [0]).to_bytes(4, "little")
    return bytes(out)


def _with_trailer(block: bytes) -> bytes:
    return block + b"\x00" + mask_crc(crc32c(block + b"\x00")).to_bytes(4, "little")


def _table(entries: List[Tuple[bytes, bytes]], block_size: int) -> bytes:
    blocks, current, size = [], [], 0
    for key, value in entries:
        current.append((key, value))
        size += len(key) + len(value) + 8
        if size >= block_size:
            blocks.append(current)
            current, size = [], 0
    if current:
        blocks.append(current)
    out, index = bytearray(), []
    for group in blocks:
        body = _block(group, RESTART_INTERVAL)
        index.append((group[-1][0], _varint(len(out)) + _varint(len(body))))
        out += _with_trailer(body)
    meta = _block([], 1)
    meta_handle = _varint(len(out)) + _varint(len(meta))
    out += _with_trailer(meta)
    top = _block(index, 1)
    top_handle = _varint(len(out)) + _varint(len(top))
    out += _with_trailer(top)
    footer = (meta_handle + top_handle).ljust(40, b"\x00")
    return bytes(out + footer + TABLE_MAGIC.to_bytes(8, "little"))


def _strings(arr: np.ndarray) -> Tuple[bytes, int]:
    """A string tensor's bytes in a bundle (a varint64 length per element,
    the masked CRC32C of the lengths, the strings) and its entry's CRC32C:
    both CRCs take each length as a little-endian uint32, the entry's then
    the masked length CRC and the strings."""
    items = [bytes(b) for b in arr.ravel().tolist()]
    lengths = b"".join(len(b).to_bytes(4, "little") for b in items)
    tail = mask_crc(crc32c(lengths)).to_bytes(4, "little") + b"".join(items)
    return b"".join(_varint(len(b)) for b in items) + tail, crc32c(lengths + tail)


def _stored(value) -> Tuple[int, tuple, bytes, Optional[int]]:
    """(DataType, shape, stored bytes, entry CRC32C where it is not the
    bytes' own)."""
    if isinstance(value, Bfloat16):
        return DT_BFLOAT16, value.shape, value.bits.astype("<u2").tobytes(), None
    arr = np.asarray(value)
    if arr.dtype == object or arr.dtype.kind == "S":
        return (DT_STRING, arr.shape) + _strings(arr)
    dt = _NUMBERS.get(arr.dtype)
    if dt is None:
        raise ValueError(f"no DataType for {arr.dtype}")
    return (dt, arr.shape,
            np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes(), None)


def _cuts(n: int, k: int) -> List[Tuple[int, int]]:
    """``fixed_size_partitioner``'s cut of ``n`` rows into ``k`` slices: the
    first ``n % k`` one row longer."""
    out, start = [], 0
    for i in range(k):
        length = n // k + (1 if i < n % k else 0)
        out.append((start, length))
        start += length
    return out


# V1: the TensorProto field of each dtype and whether its values are
# varints (else fixed-width little-endian)
_V1_FIELDS = {np.dtype(np.float32): (5, "<f4"), np.dtype(np.float64): (6, "<f8"),
              np.dtype(np.int32): (7, None), np.dtype(np.uint8): (7, None),
              np.dtype(np.int16): (7, None), np.dtype(np.int8): (7, None),
              np.dtype(np.int64): (10, None), np.dtype(np.bool_): (11, None)}


def _v1_values(arr: np.ndarray) -> Tuple[int, bytes]:
    """(DataType, the TensorProto holding ``arr``'s values)."""
    if arr.dtype == object or arr.dtype.kind == "S":
        return DT_STRING, b"".join(_field(8, bytes(b), 2) for b in arr.ravel().tolist())
    number, fixed = _V1_FIELDS[arr.dtype]
    if fixed:
        packed = np.ascontiguousarray(arr, fixed).tobytes()
    else:
        packed = b"".join(_varint(int(v)) for v in arr.ravel().tolist())
    return _NUMBERS[arr.dtype], _field(number, packed, 2) if arr.size else b""


def write_v1(prefix: str, tensors: Dict[str, object], num_shards: int = 1,
             block_size: int = 262144) -> str:
    """Write ``tensors`` (``{name: array}``, each saved whole) in the V1
    format, dealt round-robin in name order over ``num_shards`` files."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    names = sorted(tensors)
    for shard in range(num_shards):
        meta, entries = b"", []
        for name in names[shard::num_shards]:
            arr = np.asarray(tensors[name])
            dtype, proto = _v1_values(arr)
            full = b"".join(_field(1, b"", 2) for _ in arr.shape)  # full extents
            meta += _field(1, _field(1, name.encode(), 2) + _field(2, _shape_proto(arr.shape), 2)
                           + _field(3, dtype) + _field(4, full, 2), 2)
            saved = _field(1, name.encode(), 2) + _field(2, full, 2) + _field(3, proto, 2)
            extents = [(0, -1)] * arr.ndim
            entries.append((slice_key(name, extents), _field(2, saved, 2)))
        meta += _field(2, _field(1, 1), 2)  # versions { producer: 1 }
        path = prefix if num_shards == 1 else f"{prefix}-{shard:05d}-of-{num_shards:05d}"
        with open(path, "wb") as f:
            f.write(_table([(b"", _field(1, meta, 2))] + sorted(entries), block_size))
    return prefix if num_shards == 1 else f"{prefix}-?????-of-{num_shards:05d}"


def write_bundle(prefix: str, tensors: Dict[str, object], num_shards: int = 1,
                 partitions: Optional[Dict[str, int]] = None,
                 block_size: int = 262144) -> str:
    """Write ``tensors`` (``{name: array or Bfloat16}``) as a bundle at
    ``prefix``; returns ``prefix``."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    partitions = partitions or {}
    records: Dict[bytes, Tuple[int, tuple, bytes, Optional[list]]] = {}
    crcs: Dict[bytes, int] = {}
    for name, value in tensors.items():
        dt, shape, raw, crc = _stored(value)
        k = partitions.get(name, 1)
        if crc is not None:  # a string tensor: saved whole, with its own CRC
            records[name.encode()] = (dt, shape, raw, None)
            crcs[name.encode()] = crc
            continue
        if k == 1:
            records[name.encode()] = (dt, shape, raw, None)
            continue
        row = len(raw) // shape[0]
        all_slices = []
        for start, length in _cuts(shape[0], k):
            extents = [(start, length)] + [(0, -1)] * (len(shape) - 1)
            all_slices.append(extents)
            records[slice_key(name, extents)] = (dt, (length,) + tuple(shape[1:]),
                                                 raw[start * row:(start + length) * row], None)
        records[name.encode()] = (dt, shape, b"", all_slices)
    data = [bytearray() for _ in range(num_shards)]
    entries = [(b"", _field(1, num_shards) + _field(3, _field(1, 1), 2))]  # header: version 1
    stored_keys = [key for key in sorted(records) if records[key][3] is None]
    shard_of = {key: i % num_shards for i, key in enumerate(stored_keys)}
    for key in sorted(records):
        dt, shape, raw, slices = records[key]
        if slices is not None:
            entries.append((key, _entry(dt, shape, slices=slices)))
            continue
        shard = shard_of[key]
        offset = len(data[shard])
        data[shard] += raw
        crc = crcs[key] if key in crcs else crc32c(raw)
        entries.append((key, _entry(dt, shape, shard, offset, len(raw), mask_crc(crc))))
    with open(prefix + ".index", "wb") as f:
        f.write(_table(entries, block_size))
    for i, blob in enumerate(data):
        with open(f"{prefix}.data-{i:05d}-of-{num_shards:05d}", "wb") as f:
            f.write(bytes(blob))
    return prefix
