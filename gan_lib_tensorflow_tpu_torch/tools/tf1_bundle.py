"""Read a TensorFlow tensor bundle without TensorFlow: the V2 checkpoint
that ``tf.compat.v1.train.Saver`` (and ``tf.train.Checkpoint``) writes as
``<prefix>.index`` plus ``<prefix>.data-<shard>-of-<num_shards>``.

The index is a LevelDB-format table (TensorFlow's ``lib/io/table``): a
48-byte footer (the metaindex and index block handles as varints, zero
padding, the magic ``0xdb4775248b80fb57``), an index block whose values
are the handles of the data blocks, and blocks of prefix-compressed keys
with a restart array. Every block ends in a compression byte and the masked
CRC32C of its contents and that byte; only compression 0 (none), which
TensorFlow's bundle writer always uses, is read. The entry under the empty
key is a ``BundleHeaderProto``; every other entry is a
``BundleEntryProto`` (``tensorflow/core/protobuf/tensor_bundle.proto``),
decoded here from the protobuf wire format by hand. A tensor's bytes lie
at ``offset`` in its shard's data file, little-endian, and their masked
CRC32C is checked as TensorFlow checks it. A partitioned variable's entry
carries ``slices`` and no data: each slice is stored under the key
``EncodeTensorNameSlice(name, slice)`` (``core/util/saved_tensor_slice_
util.cc``: OrderedCode of 0, the name, the rank, then start and length per
dimension, -1 for a full extent), and ``read`` assembles the full tensor.
Slice entries are not listed, as ``get_variable_to_shape_map`` does not
list them.

CRC32C at full width in numpy: the bytes are cut into 16,384 equal lanes
that advance in lockstep, four bytes a step through two 65,536-entry
tables (one vectorised step per word position), and the lanes' CRCs are
joined pairwise by the GF(2) operator that appends a run of zero bytes
(zlib's ``crc32_combine``). Short inputs take the plain byte loop.

``read_tf_checkpoint`` applies the reference importer's ``DROP`` filter
(``tools/import_tf1_checkpoint.py:56-58``) before any tensor is decoded,
so a TF2 object graph (``_CHECKPOINTABLE_OBJECT_GRAPH``, a string) is
listed and dropped, never parsed. A V1 checkpoint (one table file with no
``.index``) is refused by name: only TensorFlow reads that format.
"""

from __future__ import annotations

import codecs
import functools
import os
import re
from typing import Dict, Iterator, List, Tuple

import numpy as np

# the reference importer's filter of optimizer slots and bookkeeping
DROP = re.compile(
    r"(Adam|RMSProp|Momentum|beta1_power|beta2_power|global_step|"
    r"ExponentialMovingAverage|save_counter|_CHECKPOINTABLE)", re.I)

TABLE_MAGIC = 0xdb4775248b80fb57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
MASK_DELTA = 0xa282ead8
BUNDLE_VERSION = 1  # tensor_bundle.h kTensorBundleVersion

# DataType enum numbers (tensorflow/core/framework/types.proto) -> name and
# the little-endian numpy dtype of the stored bytes
DTYPES = {1: ("float32", "<f4"), 2: ("float64", "<f8"), 3: ("int32", "<i4"),
          9: ("int64", "<i8"), 10: ("bool", "|b1"), 14: ("bfloat16", "<u2"),
          19: ("float16", "<f2")}
DT_STRING = 7


class BundleError(ValueError):
    """A bundle that is corrupt or that this reader does not decode."""


def dtype_name(dt: int) -> str:
    if dt in DTYPES:
        return DTYPES[dt][0]
    return "string" if dt == DT_STRING else f"DT_{dt}"


# --------------------------------------------------------------- CRC32C
_POLY = 0x82F63B78  # Castagnoli, reflected


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(np.uint32)
    return t


_TABLE = _byte_table()
_TABLE_LIST = [int(v) for v in _TABLE]
_SCALAR_BYTES = 4096  # below this the byte loop is as quick as numpy's set-up
_LANES = 1 << 14      # 180 MB/s on an 8-core x86 host (16k-256k lanes: 107-181)
_MIN_LANE_BYTES = 256  # a lane's least length: few steps for a small tensor
_TILE = 256           # words per transposed tile of the lanes


_BITS = (np.arange(256, dtype=np.uint32)[:, None] >> np.arange(8, dtype=np.uint32)) & 1


class _Gf2:
    """A GF(2)-linear map of 32-bit CRC registers, by its 32 columns
    (images of the unit vectors), applied through four byte tables."""

    def __init__(self, cols: np.ndarray):
        self.cols = cols.astype(np.uint32)
        self.tables = [np.bitwise_xor.reduce(_BITS * self.cols[8 * i:8 * i + 8], axis=1)
                       for i in range(4)]

    def __call__(self, x: np.ndarray) -> np.ndarray:
        t0, t1, t2, t3 = self.tables
        return t0[x & 0xFF] ^ t1[(x >> 8) & 0xFF] ^ t2[(x >> 16) & 0xFF] ^ t3[x >> 24]

    def then(self, other: "_Gf2") -> "_Gf2":
        """``other`` after ``self``."""
        return _Gf2(other(self.cols))


@functools.lru_cache(maxsize=64)
def _zeros_op(n: int) -> _Gf2:
    """The map reg -> the register after ``n`` zero bytes (tensors of one
    shape share it)."""
    if n == 0:
        unit = np.uint32(1) << np.arange(32, dtype=np.uint32)
        return _Gf2(unit)
    if n == 1:
        unit = np.uint32(1) << np.arange(32, dtype=np.uint32)
        return _Gf2(_TABLE[unit & 0xFF] ^ (unit >> 8))
    half = _zeros_op(n // 2)
    op = half.then(half)
    return op.then(_zeros_op(1)) if n % 2 else op


@functools.lru_cache(maxsize=1)
def _word_tables() -> Tuple[np.ndarray, np.ndarray]:
    """The register after 4 bytes, from each low and each high half-word
    (two 65,536-entry tables: a 4-byte step is two lookups)."""
    z4 = _zeros_op(4)
    half = np.arange(1 << 16, dtype=np.uint32)
    return z4(half), z4(half << 16)


def _register_scalar(reg: int, data) -> int:
    t = _TABLE_LIST
    for b in bytes(data):
        reg = t[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _register(data: np.ndarray) -> int:
    """The CRC register after ``data`` (uint8, 1-D), starting from 0."""
    n = data.size
    if n < _SCALAR_BYTES:
        return _register_scalar(0, data.tobytes())
    lanes = min(_LANES, 1 << int(np.log2(n // _MIN_LANE_BYTES)))
    width = (n // lanes) & ~3
    block = np.frombuffer(data[:lanes * width], "<u4").reshape(lanes, width // 4)
    low, high = _word_tables()
    reg, idx, tmp = (np.zeros(lanes, np.uint32) for _ in range(3))
    for j0 in range(0, width // 4, _TILE):
        for word in np.ascontiguousarray(block[:, j0:j0 + _TILE].T):
            np.bitwise_xor(reg, word, out=reg)
            np.bitwise_and(reg, 0xFFFF, out=idx)
            np.right_shift(reg, 16, out=reg)
            np.take(high, reg, out=tmp)
            np.take(low, idx, out=reg)
            np.bitwise_xor(reg, tmp, out=reg)
    span = width
    while reg.size > 1:  # neighbours: R(a || b) = Z_|b|(R(a)) ^ R(b)
        reg = _zeros_op(span)(reg[0::2]) ^ reg[1::2]
        span *= 2
    tail = data[lanes * width:]
    return int(_zeros_op(tail.size)(reg)[0]) ^ _register(tail) if tail.size else int(reg[0])


def crc32c(data) -> int:
    """CRC-32C of ``data`` (bytes-like or a uint8 array)."""
    arr = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.reshape(-1).view(np.uint8)
    if arr.size < _SCALAR_BYTES:
        return _register_scalar(0xFFFFFFFF, arr.tobytes()) ^ 0xFFFFFFFF
    shifted = int(_zeros_op(arr.size)(np.array([0xFFFFFFFF], np.uint32))[0])
    return shifted ^ _register(arr) ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# --------------------------------------------------------- wire decoding
def _varint(buf, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise BundleError("truncated or overlong varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def _signed(v: int) -> int:
    v &= 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message; varints as
    unsigned ints, fixed32/64 as ints, length-delimited as bytes."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = bytes(buf[pos:pos + n]), pos + n
        elif wire == 5:
            value, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        else:
            raise BundleError(f"unsupported protobuf wire type {wire} (field {field})")
        if pos > len(buf):
            raise BundleError(f"truncated protobuf field {field}")
        yield field, wire, value


def _shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, _, value in _fields(buf):
        if field == 2:  # Dim
            size = 0
            for f, _, v in _fields(value):
                if f == 1:
                    size = _signed(v)
            dims.append(size)
        elif field == 3 and value:
            raise BundleError("a tensor of unknown rank")
    return tuple(dims)


def _slice(buf: bytes) -> List[Tuple[int, int]]:
    """TensorSliceProto -> [(start, length)], length -1 for a full extent."""
    extents = []
    for field, _, value in _fields(buf):
        if field == 1:
            start, length = 0, -1
            for f, _, v in _fields(value):
                if f == 1:
                    start = _signed(v)
                elif f == 2:
                    length = _signed(v)
            extents.append((start, length))
    return extents


class Entry:
    """A decoded ``BundleEntryProto``."""

    __slots__ = ("dtype", "shape", "shard_id", "offset", "size", "crc32c", "slices")

    def __init__(self, buf: bytes):
        self.dtype, self.shape, self.shard_id = 0, (), 0
        self.offset = self.size = self.crc32c = 0
        self.slices: List[List[Tuple[int, int]]] = []
        for field, _, value in _fields(buf):
            if field == 1:
                self.dtype = value
            elif field == 2:
                self.shape = _shape(value)
            elif field == 3:
                self.shard_id = _signed(value)
            elif field == 4:
                self.offset = _signed(value)
            elif field == 5:
                self.size = _signed(value)
            elif field == 6:
                self.crc32c = value
            elif field == 7:
                self.slices.append(_slice(value))


# ------------------------------------------------------- OrderedCode keys
def _num_increasing(v: int) -> bytes:
    body = v.to_bytes((v.bit_length() + 7) // 8, "big") if v else b""
    return bytes([len(body)]) + body


_LENGTH_HEADER = [(0, 0), (0x80, 0), (0xC0, 0), (0xE0, 0), (0xF0, 0), (0xF8, 0),
                  (0xFC, 0), (0xFE, 0), (0xFF, 0), (0xFF, 0x80), (0xFF, 0xC0)]


def _signed_num_increasing(v: int) -> bytes:
    x = ~v if v < 0 else v
    if x < 64:
        return bytes([(0x80 ^ v) & 0xFF])
    n = 1  # bytes: each holds 7 value bits besides its header bit
    while x >= 1 << (7 * n - 1):
        n += 1
    buf = bytearray((v & ((1 << 80) - 1)).to_bytes(10, "big"))[10 - n:]
    buf[0] ^= _LENGTH_HEADER[n][0]
    buf[1] ^= _LENGTH_HEADER[n][1]
    return bytes(buf)


def slice_key(name: str, extents: List[Tuple[int, int]]) -> bytes:
    """``EncodeTensorNameSlice``: the key a partitioned variable's slice is
    stored under."""
    out = _num_increasing(0) + _escape(name.encode()) + b"\x00\x01" + _num_increasing(len(extents))
    for start, length in extents:
        out += _signed_num_increasing(start) + _signed_num_increasing(length)
    return out


def _escape(raw: bytes) -> bytes:
    """OrderedCode's string escapes: 0x00 -> 00 ff, 0xff -> ff 00."""
    out = bytearray()
    for b in raw:
        out += b"\x00\xff" if b == 0 else b"\xff\x00" if b == 0xFF else bytes([b])
    return bytes(out)


# ---------------------------------------------------------------- table
def _read_block(index: bytes, offset: int, size: int, what: str) -> bytes:
    end = offset + size + BLOCK_TRAILER_BYTES
    if offset < 0 or size < 0 or end > len(index):
        raise BundleError(f"{what}: block handle ({offset}, {size}) past the end of the index")
    kind = index[offset + size]
    stored = int.from_bytes(index[offset + size + 1:end], "little")
    if unmask_crc(stored) != crc32c(index[offset:offset + size + 1]):
        raise BundleError(f"{what}: block CRC32C mismatch at offset {offset} "
                          "(the index file is corrupt)")
    if kind != 0:
        raise BundleError(f"{what}: block compression type {kind} at offset {offset}; "
                          "only 0 (none), which TensorFlow's bundle writer uses, is read")
    return index[offset:offset + size]


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise BundleError("a block shorter than its restart count")
    n_restarts = int.from_bytes(block[-4:], "little")
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise BundleError("a block's restart array overruns it")
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        if shared > len(key) or pos + unshared + n_value > end:
            raise BundleError("a corrupt block entry")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + n_value]
        pos += n_value


def _table_entries(index: bytes, path: str) -> Iterator[Tuple[bytes, bytes]]:
    if len(index) < FOOTER_BYTES:
        raise BundleError(f"{path}: shorter than a table footer")
    footer = index[-FOOTER_BYTES:]
    magic = int.from_bytes(footer[40:], "little")
    if magic != TABLE_MAGIC:
        raise BundleError(f"{path}: bad table magic {magic:#018x} (want {TABLE_MAGIC:#018x}); "
                          "not a tensor bundle index")
    pos = 0
    for _ in range(2):  # metaindex handle, unused by bundles
        _, pos = _varint(footer, pos)
    idx_off, pos = _varint(footer, pos)
    idx_size, pos = _varint(footer, pos)
    top = _read_block(index, idx_off, idx_size, f"{path} index block")
    for _, handle in _block_entries(top):
        off, p = _varint(handle, 0)
        size, _ = _varint(handle, p)
        yield from _block_entries(_read_block(index, off, size, f"{path} data block"))


def resolve_prefix(path: str) -> str:
    """The bundle prefix of ``path``: a prefix as ``Saver.save`` returned
    it, or a directory whose ``checkpoint`` file names the newest one (as
    ``tf.train.load_checkpoint`` takes it). The ``checkpoint`` file is
    protobuf text format: its string holds UTF-8 bytes, raw or escaped as
    C escapes (``\\303\\251``), so it is unescaped to bytes and then decoded.
    A V1 checkpoint is refused."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if not os.path.exists(state):
            raise FileNotFoundError(f"{path}: a directory without a 'checkpoint' file")
        with open(state, "rb") as f:
            m = re.search(rb'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', f.read(), re.M)
        if not m:
            raise BundleError(f"{state}: no model_checkpoint_path")
        found = codecs.escape_decode(m.group(1))[0].decode("utf-8")
        path = found if os.path.isabs(found) else os.path.join(path, found)
    if os.path.exists(path + ".index"):
        return path
    if os.path.isfile(path) or re.search(r"-\d{5}-of-\d{5}$", path):
        raise BundleError(f"{path}: a V1 checkpoint (one table file, no .index); only "
                          "TensorFlow reads that format: re-save it as V2 "
                          "(tf.compat.v1.train.Saver's default) first")
    raise FileNotFoundError(f"{path}.index: no such tensor bundle")


class Bundle:
    """An open tensor bundle. ``variables`` maps each listed tensor to
    ``(dtype name, shape)`` in the bundle's key order (TensorFlow's
    reader iterates the same order; ``tf.train.load_checkpoint``'s Python
    dict comes from a hash map and is in another). ``read(name)`` returns a
    numpy array (bfloat16 widened exactly to float32)."""

    def __init__(self, prefix: str):
        self.prefix = resolve_prefix(prefix)
        with open(self.prefix + ".index", "rb") as f:
            index = f.read()
        raw: Dict[bytes, bytes] = {}
        header = None
        for key, value in _table_entries(index, self.prefix + ".index"):
            if key == b"":
                header = value
            else:
                raw[key] = value
        if header is None:
            raise BundleError(f"{self.prefix}.index: no bundle header entry")
        self.num_shards, endianness, min_consumer, bad = 1, 0, 0, []
        for field, _, value in _fields(header):
            if field == 1:
                self.num_shards = value
            elif field == 2:
                endianness = value
            elif field == 3:
                for f, wire, v in _fields(value):
                    if f == 2:
                        min_consumer = v
                    elif f == 3:
                        bad += [v] if wire == 0 else _packed(v)
        if endianness != 0:
            raise BundleError(f"{self.prefix}: a BIG-endian bundle; only LITTLE is read")
        if min_consumer > BUNDLE_VERSION or BUNDLE_VERSION in bad:
            raise BundleError(f"{self.prefix}: bundle version needs a consumer >= "
                              f"{min_consumer} (this reader is {BUNDLE_VERSION})")
        self._entries: Dict[str, Entry] = {}
        self._slice_entries: Dict[bytes, Entry] = {}
        hidden = set()
        for key, value in raw.items():
            entry = Entry(value)
            if entry.slices:
                name = key.decode()
                for extents in entry.slices:
                    hidden.add(slice_key(name, extents))
        for key, value in raw.items():
            if key in hidden:
                self._slice_entries[key] = Entry(value)
            else:
                self._entries[key.decode()] = Entry(value)
        self.variables = {name: (dtype_name(e.dtype), e.shape)
                          for name, e in self._entries.items()}
        self._shards: Dict[int, np.memmap] = {}

    def _shard(self, shard_id: int) -> np.ndarray:
        if shard_id not in self._shards:
            if not 0 <= shard_id < self.num_shards:
                raise BundleError(f"shard {shard_id} of {self.num_shards}")
            path = f"{self.prefix}.data-{shard_id:05d}-of-{self.num_shards:05d}"
            if os.path.getsize(path) == 0:
                self._shards[shard_id] = np.zeros(0, np.uint8)
            else:
                self._shards[shard_id] = np.memmap(path, np.uint8, mode="r")
        return self._shards[shard_id]

    def _decode(self, name: str, entry: Entry) -> np.ndarray:
        if entry.dtype not in DTYPES:
            raise BundleError(f"tensor {name!r} has dtype {dtype_name(entry.dtype)}, "
                              "which this reader does not decode")
        stored = np.dtype(DTYPES[entry.dtype][1])
        count = int(np.prod(entry.shape, dtype=np.int64))
        if entry.size != count * stored.itemsize:
            raise BundleError(f"tensor {name!r}: {entry.size} bytes for shape "
                              f"{entry.shape} of {dtype_name(entry.dtype)}")
        data = self._shard(entry.shard_id)
        if entry.offset < 0 or entry.offset + entry.size > data.size:
            raise BundleError(f"tensor {name!r}: bytes [{entry.offset}, "
                              f"{entry.offset + entry.size}) past the end of shard "
                              f"{entry.shard_id}")
        raw = data[entry.offset:entry.offset + entry.size]
        if crc32c(raw) != unmask_crc(entry.crc32c):
            raise BundleError(f"tensor {name!r}: data CRC32C mismatch in shard "
                              f"{entry.shard_id} (the data file is corrupt)")
        arr = np.array(raw).view(stored).reshape(entry.shape)
        if entry.dtype == 14:  # bfloat16: the top half of a float32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.astype(arr.dtype.newbyteorder("="), copy=False)

    def read(self, name: str) -> np.ndarray:
        entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"{name!r} is not in the bundle {self.prefix}")
        if not entry.slices:
            return self._decode(name, entry)
        if entry.dtype not in DTYPES:
            raise BundleError(f"tensor {name!r} has dtype {dtype_name(entry.dtype)}, "
                              "which this reader does not decode")
        out = None
        covered = 0
        for extents in entry.slices:
            key = slice_key(name, extents)
            part_entry = self._slice_entries.get(key)
            if part_entry is None:
                raise BundleError(f"tensor {name!r}: slice {extents} is missing")
            part = self._decode(f"{name} slice {extents}", part_entry)
            if out is None:
                out = np.zeros(entry.shape, part.dtype)
            index = tuple(slice(None) if n < 0 else slice(s, s + n) for s, n in extents)
            if out[index].shape != part.shape:
                raise BundleError(f"tensor {name!r}: slice {extents} holds {part.shape}")
            out[index] = part
            covered += part.size
        if covered != out.size:
            raise BundleError(f"tensor {name!r}: its slices cover {covered} of {out.size} values")
        return out

    def close(self) -> None:
        self._shards.clear()

    def __enter__(self) -> "Bundle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _packed(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _varint(buf, pos)
        out.append(v)
    return out


def open_bundle(prefix: str) -> Bundle:
    return Bundle(prefix)


def read_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """``{name: array}`` of every variable ``DROP`` does not match, in the
    bundle's order; the dropped ones are never decoded (the reference
    importer's ``read_tf_checkpoint``)."""
    with open_bundle(path) as bundle:
        out = {name: bundle.read(name) for name in bundle.variables if not DROP.search(name)}
    if not out:
        raise SystemExit(f"no model variables found in checkpoint {path!r}")
    return out


__all__ = ["Bundle", "BundleError", "DROP", "crc32c", "mask_crc", "open_bundle",
           "read_tf_checkpoint", "resolve_prefix", "slice_key", "unmask_crc"]
