"""Read a TensorFlow checkpoint without TensorFlow: the V2 tensor bundle
that ``tf.compat.v1.train.Saver`` (and ``tf.train.Checkpoint``) writes as
``<prefix>.index`` plus ``<prefix>.data-<shard>-of-<num_shards>``, and the
V1 table files of ``SaverDef.V1``.

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

Every dtype ``tf.train.load_checkpoint(...).get_tensor`` returns is read:
the numbers little-endian, a string tensor as an object array of ``bytes``
(a string scalar as numpy makes ``bytes``: an ``S`` array). A string
tensor's bytes are a varint64 length per element, the masked CRC32C of the
lengths, then the strings; both checksums are checked.

The V1 format (``SaverDef.V1``: one table file per shard, no ``.index``)
is read by ``TableCheckpoint`` from the same table code: its meta entry
names the tensors and their slices, and each slice's values sit in the
typed repeated fields of a ``TensorProto``. As TensorFlow's reader, it
returns float32, float64, int32, int64, uint8, int16, int8, bool and
string tensors saved whole, and refuses other dtypes and partitioned
variables by name. TensorFlow's V1 writer builds its tables uncompressed,
as its bundle writer does; a compressed block is refused by name.

``read_tf_checkpoint`` applies the reference importer's ``DROP`` filter
(``tools/import_tf1_checkpoint.py:56-58``) before any tensor is decoded,
so a TF2 object graph (``_CHECKPOINTABLE_OBJECT_GRAPH``, a string) is
listed and dropped, never parsed.

Listing order. ``variables`` is in the file's order (a bundle's key order;
a V1 checkpoint's files, then each meta's). ``listing`` is the order of
``tf.train.load_checkpoint(path).get_variable_to_shape_map()``, which the
reference importer reads: TensorFlow's ``CheckpointReader`` fills a
``std::unordered_map<std::string, TensorShape>`` and the Python dict
follows its iteration. ``hash_map_order`` computes that order from the
names alone, as libstdc++ (the C++ library of TensorFlow's Linux wheels)
lays the map out: ``std::hash<std::string>`` is ``_Hash_bytes`` (64-bit
MurmurHash2, seed ``0xc70f6907``), the bucket counts are those of
``_Prime_rehash_policy`` for a map grown one insert at a time, a key goes
to the front of its bucket or, in an empty bucket, to the front of the
list, and a rehash relinks the list in its order the same way. A V2 bundle
inserts its names in key order (``BuildV2VarMaps``); a V1 checkpoint
inserts them into ``TensorSliceReader``'s own hash map file by file, each
in its meta's order, then copies that map into a new one in its iteration
order (``GetVariableToShapeMap``). A V2 order is fixed by the names alone.
A V1 order of several files also depends on the order in which TensorFlow
met the files: ``GetMatchingPaths`` keeps their directory's listing order
(``readdir``'s, which the file system sets, and not sorted), so it is read
from ``os.listdir`` here; a copy of the files into another directory may
list them otherwise, and TensorFlow's order changes with it. A TensorFlow
built against another C++ library (libc++, MSVC's) hashes otherwise, and
there this order is not its.
"""

from __future__ import annotations

import codecs
import functools
import glob
import os
import re
from typing import Dict, Iterable, Iterator, List, Tuple

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
          4: ("uint8", "|u1"), 5: ("int16", "<i2"), 6: ("int8", "|i1"),
          8: ("complex64", "<c8"), 9: ("int64", "<i8"), 10: ("bool", "|b1"),
          14: ("bfloat16", "<u2"), 17: ("uint16", "<u2"), 18: ("complex128", "<c16"),
          19: ("float16", "<f2"), 22: ("uint32", "<u4"), 23: ("uint64", "<u8")}
DT_STRING = 7
DT_BFLOAT16 = 14


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


_M64 = (1 << 64) - 1
_MURMUR_MUL = (0xC6A4A793 << 32) + 0x5BD1E995
# (size at which a map grown one insert at a time rehashes, its new bucket
# count): libstdc++'s _Prime_rehash_policy at max_load_factor 1, from 1
# bucket (the first insert allocates 13) to past 2**31 names
_REHASHES = ((1, 13), (14, 29), (30, 59), (60, 127), (128, 257), (258, 541),
             (542, 1109), (1110, 2357), (2358, 5087), (5088, 10273), (10274, 20753),
             (20754, 42043), (42044, 85229), (85230, 172933), (172934, 351061),
             (351062, 712697), (712698, 1447153), (1447154, 2938679),
             (2938680, 5967347), (5967348, 12117689), (12117690, 24607243),
             (24607244, 49969847), (49969848, 101473717), (101473718, 206062531),
             (206062532, 418451333), (418451334, 849749479), (849749480, 1725587117),
             (1725587118, 3504151727))


def _shift_mix(v: int) -> int:
    return v ^ (v >> 47)


def _std_string_hash(data: bytes) -> int:
    """libstdc++'s ``std::hash<std::string>`` on a 64-bit host:
    ``_Hash_bytes(data, len, 0xc70f6907)``."""
    n = len(data)
    h = 0xC70F6907 ^ (n * _MURMUR_MUL & _M64)
    whole = n & ~7
    for i in range(0, whole, 8):
        word = int.from_bytes(data[i:i + 8], "little")
        h = (h ^ (_shift_mix(word * _MURMUR_MUL & _M64) * _MURMUR_MUL & _M64)) * _MURMUR_MUL & _M64
    if n & 7:
        h = (h ^ int.from_bytes(data[whole:], "little")) * _MURMUR_MUL & _M64
    return _shift_mix(_shift_mix(h) * _MURMUR_MUL & _M64)


def hash_map_order(names: Iterable[str]) -> List[str]:
    """The iteration order of a libstdc++ ``std::unordered_map<std::string,
    T>`` after ``names`` were inserted one at a time in this order (a
    repeated name is not inserted again)."""
    # a singly linked list: nxt[None] is its first node, "" never ends it
    # (an end is marked by END); before[b] is the node before bucket b's first
    end = object()
    nxt: Dict[object, object] = {None: end}
    before: Dict[int, object] = {}
    codes: Dict[str, int] = {}
    n_buckets = 1

    def link(node, b: int, first_bucket: int) -> int:
        """Put node at the front of bucket b (an empty one: of the list)."""
        if b in before:
            prev = before[b]
            nxt[node], nxt[prev] = nxt[prev], node
            return first_bucket
        nxt[node], nxt[None], before[b] = nxt[None], node, None
        if nxt[node] is not end:
            before[first_bucket] = node
        return b

    for name in names:
        if name in codes:
            continue
        grown = next(b for at, b in reversed(_REHASHES) if len(codes) + 1 >= at)
        if grown != n_buckets:  # rehash: relink the list in its order
            n_buckets, node, before = grown, nxt[None], {}
            nxt[None], first_bucket = end, 0
            while node is not end:
                after = nxt[node]
                first_bucket = link(node, codes[node] % n_buckets, first_bucket)
                node = after
        codes[name] = _std_string_hash(name.encode())
        first = nxt[None]
        link(name, codes[name] % n_buckets,
             codes[first] % n_buckets if first is not end else 0)
    out, node = [], nxt[None]
    while node is not end:
        out.append(node)
        node = nxt[node]
    return out


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
                          "only 0 (none), which TensorFlow's checkpoint writers use, is read")
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
    """The checkpoint ``path`` names, as ``tf.train.load_checkpoint`` takes
    it: a V2 prefix as ``Saver.save`` returned it, a V1 file pattern (one
    table file, or the ``-?????-of-NNNNN`` pattern of its shards), or a
    directory whose ``checkpoint`` file names the newest one. The
    ``checkpoint`` file is protobuf text format: its string holds UTF-8
    bytes, raw or escaped as C escapes (``\\303\\251``), so it is unescaped
    to bytes and then decoded."""
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
    if os.path.exists(path + ".index") or _v1_files(path):
        return path
    raise FileNotFoundError(f"{path}: no tensor bundle ({path}.index) and no V1 table file "
                            "matches it")


def _v1_files(pattern: str) -> List[str]:
    """The files a V1 pattern matches (TensorFlow's ``GetMatchingPaths``:
    ``*``, ``?`` and ``[...]``), sorted."""
    return sorted(p for p in glob.glob(pattern) if os.path.isfile(p))


def _strings(buf: bytes, count: int, name: str) -> Tuple[np.ndarray, bytes]:
    """A bundle's string tensor (``WriteStringTensor``: a varint64 length
    per element, the masked CRC32C of the lengths, then the bytes) -> (an
    object array of ``bytes``, the bytes its entry's CRC32C covers). Both
    CRCs take each length as a little-endian uint32 (a uint64 above
    ``UINT32_MAX``), and the entry's then the masked length CRC and the
    strings."""
    lengths, pos = [], 0
    for _ in range(count):
        n, pos = _varint(buf, pos)
        lengths.append(n)
    if pos + 4 + sum(lengths) != len(buf):
        raise BundleError(f"tensor {name!r}: {len(buf)} bytes for {count} strings of "
                          f"{sum(lengths)} bytes")
    as_ints = b"".join(n.to_bytes(4 if n <= 0xFFFFFFFF else 8, "little") for n in lengths)
    if unmask_crc(int.from_bytes(buf[pos:pos + 4], "little")) != crc32c(as_ints):
        raise BundleError(f"tensor {name!r}: string lengths CRC32C mismatch "
                          "(the data file is corrupt)")
    out = np.empty(count, object)
    start = pos + 4
    for i, n in enumerate(lengths):
        out[i] = buf[start:start + n]
        start += n
    return out, as_ints + buf[pos:]


def _native(arr: np.ndarray, dtype: int) -> np.ndarray:
    """Stored values -> native byte order (bfloat16 widened exactly to
    float32, the top half of its bits)."""
    if dtype == DT_BFLOAT16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.astype(arr.dtype.newbyteorder("="), copy=False)


def _as_tensorflow_returns(arr: np.ndarray) -> np.ndarray:
    """``np.asarray(reader.get_tensor(name))``: TensorFlow hands a string
    scalar back as ``bytes``, which numpy makes an ``S`` array; a string
    tensor of rank >= 1 stays an object array of ``bytes``."""
    if arr.dtype == object and arr.ndim == 0:
        return np.asarray(arr[()])
    return arr


def _assemble(name: str, shape: Tuple[int, ...],
              parts: List[Tuple[List[Tuple[int, int]], np.ndarray]]) -> np.ndarray:
    """A partitioned variable from its ``(extents, values)`` slices, which
    must cover it exactly once."""
    out, covered = None, 0
    for extents, part in parts:
        if out is None:
            out = np.empty(shape, part.dtype)
        index = tuple(slice(None) if n < 0 else slice(s, s + n) for s, n in extents)
        if out[index].shape != part.shape:
            raise BundleError(f"tensor {name!r}: slice {extents} holds {part.shape}")
        out[index] = part
        covered += part.size
    if out is None or covered != out.size:
        raise BundleError(f"tensor {name!r}: its slices cover {covered} of "
                          f"{int(np.prod(shape, dtype=np.int64))} values")
    return out


class Bundle:
    """An open tensor bundle. ``variables`` maps each listed tensor to
    ``(dtype name, shape)`` in the bundle's key order; ``listing`` is
    ``tf.train.load_checkpoint``'s order (the module's note).
    ``read(name)`` returns a numpy array (bfloat16 widened exactly to
    float32)."""

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
        self.listing = hash_map_order(self.variables)
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
        if entry.dtype != DT_STRING and entry.dtype not in DTYPES:
            raise BundleError(f"tensor {name!r} has dtype {dtype_name(entry.dtype)}, "
                              "which this reader does not decode")
        count = int(np.prod(entry.shape, dtype=np.int64))
        data = self._shard(entry.shard_id)
        if entry.offset < 0 or entry.offset + entry.size > data.size:
            raise BundleError(f"tensor {name!r}: bytes [{entry.offset}, "
                              f"{entry.offset + entry.size}) past the end of shard "
                              f"{entry.shard_id}")
        raw = data[entry.offset:entry.offset + entry.size]
        if entry.dtype == DT_STRING:
            arr, checked = _strings(raw.tobytes(), count, name)
        else:
            stored = np.dtype(DTYPES[entry.dtype][1])
            if entry.size != count * stored.itemsize:
                raise BundleError(f"tensor {name!r}: {entry.size} bytes for shape "
                                  f"{entry.shape} of {dtype_name(entry.dtype)}")
            arr, checked = np.array(raw).view(stored), raw
        if crc32c(checked) != unmask_crc(entry.crc32c):
            raise BundleError(f"tensor {name!r}: data CRC32C mismatch in shard "
                              f"{entry.shard_id} (the data file is corrupt)")
        return _native(arr.reshape(entry.shape), entry.dtype)

    def read(self, name: str) -> np.ndarray:
        entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"{name!r} is not in the bundle {self.prefix}")
        if not entry.slices:
            return _as_tensorflow_returns(self._decode(name, entry))
        parts = []
        for extents in entry.slices:
            part_entry = self._slice_entries.get(slice_key(name, extents))
            if part_entry is None:
                raise BundleError(f"tensor {name!r}: slice {extents} is missing")
            parts.append((extents, self._decode(f"{name} slice {extents}", part_entry)))
        return _as_tensorflow_returns(_assemble(name, entry.shape, parts))

    def close(self) -> None:
        self._shards.clear()

    def __enter__(self) -> "Bundle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# the TensorProto field of each dtype's values in a V1 SavedSlice
# (core/util/saved_tensor_slice_util.h: SaveTypeTraits), for the dtypes
# TensorFlow's V1 reader returns (TensorSliceReader::GetTensor; it answers
# "Data type not supported" for float16, uint16 and the complex types, and
# its writer saves no bfloat16, uint32 or uint64)
_PROTO_VALUES = {"float32": (5, "<f4"), "float64": (6, "<f8"), "int32": (7, "int"),
                 "uint8": (7, "int"), "int16": (7, "int"), "int8": (7, "int"),
                 "string": (8, "bytes"), "int64": (10, "int"), "bool": (11, "int")}


def _proto_values(buf: bytes, dtype: int, count: int, what: str) -> np.ndarray:
    """The ``count`` values of a ``TensorProto`` (``SavedSlice.data``) as
    the stored dtype: its typed repeated field, packed or not."""
    number, form = _PROTO_VALUES[dtype_name(dtype)]
    chunks, values = [], []
    for field, wire, value in _fields(buf):
        if field != number:
            continue
        if form == "bytes":
            values.append(value)
        elif form != "int":  # fixed32 / fixed64: packed, or one element
            chunks.append(np.frombuffer(value, form) if wire == 2 else
                          np.array([value], f"<u{4 if wire == 5 else 8}").view(form))
        else:
            values += _packed(value) if wire == 2 else [value]
    if form not in ("bytes", "int"):
        arr = np.concatenate(chunks) if chunks else np.zeros(0, form)
    elif form == "int":
        arr = np.array([_signed(v) for v in values], np.int64).astype(DTYPES[dtype][1])
    else:
        arr = np.empty(len(values), object)
        arr[:] = values
    if arr.size != count:
        raise BundleError(f"{what}: {arr.size} values for {count}")
    return arr


class TableCheckpoint:
    """An open V1 checkpoint (``SaverDef.V1``): one LevelDB-format table
    file per shard (``core/util/tensor_slice_writer.cc``), the files a
    pattern matches read together as ``TensorSliceReader`` reads them. The
    entry under the empty key is a ``SavedTensorSlices`` whose ``meta``
    lists each tensor's name, shape, dtype and saved slices; each slice is
    a ``SavedTensorSlices`` under ``EncodeTensorNameSlice(name, slice)``
    whose ``data`` holds its values in the ``TensorProto`` field of the
    dtype. ``variables``, ``listing`` and ``read`` are ``Bundle``'s; the
    order of ``variables`` is the files' and, within a file, the meta's."""

    def __init__(self, pattern: str):
        self.prefix = resolve_prefix(pattern)
        files = _v1_files(self.prefix)
        if not files:
            raise FileNotFoundError(f"{self.prefix}: no V1 table file matches it")
        self.num_shards = len(files)
        self._tensors: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        self._slices: Dict[str, List[Tuple[List[Tuple[int, int]], bytes]]] = {}
        metas: Dict[str, List[str]] = {}  # each file's tensors, in its meta's order
        for path in files:
            with open(path, "rb") as f:
                table = f.read()
            entries = dict(_table_entries(table, path))
            if b"" not in entries:
                raise BundleError(f"{path}: no SavedTensorSlices meta entry")
            for field, wire, meta in _fields(entries[b""]):
                if field != 1 or wire != 2:
                    raise BundleError(f"{path}: its empty key holds no SavedTensorSlices meta "
                                      "(not a V1 checkpoint)")
                for f, _, tensor in _fields(meta):
                    if f == 1:
                        metas.setdefault(path, []).append(self._add(tensor, entries, path))
        self.variables = {name: (dtype_name(dt), shape)
                          for name, (dt, shape) in self._tensors.items()}
        # TensorSliceReader registers the files in GetMatchingPaths' order,
        # which is their directory's listing order (readdir's), not sorted
        listed = {name: i for i, name in enumerate(os.listdir(os.path.dirname(self.prefix) or "."))}
        registered = sorted(files, key=lambda p: listed.get(os.path.basename(p), len(listed)))
        self.listing = hash_map_order(hash_map_order(
            name for path in registered for name in metas.get(path, [])))

    def _add(self, tensor: bytes, entries: Dict[bytes, bytes], path: str) -> str:
        name, shape, dtype, extents = "", (), 1, []
        for field, _, value in _fields(tensor):
            if field == 1:
                name = value.decode()
            elif field == 2:
                shape = _shape(value)
            elif field == 3:
                dtype = value
            elif field == 4:
                extents.append(_slice(value))
        first = self._tensors.setdefault(name, (dtype, shape))
        if first != (dtype, shape):
            raise BundleError(f"{path}: tensor {name!r} is {dtype_name(dtype)} {shape} here "
                              f"and {dtype_name(first[0])} {first[1]} in another file")
        for ext in extents:
            saved = entries.get(slice_key(name, ext))
            if saved is None:
                raise BundleError(f"{path}: tensor {name!r}: slice {ext} is missing")
            self._slices.setdefault(name, []).append((ext, saved))
        return name

    def read(self, name: str) -> np.ndarray:
        """The tensor as ``TensorSliceReader::GetTensor`` returns it, which
        refuses a dtype it does not read and a tensor saved as several
        slices (a partitioned variable): so does this."""
        if name not in self._tensors:
            raise KeyError(f"{name!r} is not in the checkpoint {self.prefix}")
        dtype, shape = self._tensors[name]
        if dtype_name(dtype) not in _PROTO_VALUES:
            raise BundleError(f"tensor {name!r} has dtype {dtype_name(dtype)}, which "
                              "TensorFlow's V1 reader does not read either (Data type not "
                              "supported)")
        slices = self._slices.get(name, [])
        if len(slices) != 1:
            raise BundleError(f"tensor {name!r} is saved as {len(slices)} slices; TensorFlow's "
                              "V1 reader does not read it either (Sliced checkpoints are not "
                              "supported)")
        extents, saved = slices[0]
        dims = tuple(n if n >= 0 else shape[i] for i, (_, n) in enumerate(extents))
        if dims != shape:
            raise BundleError(f"tensor {name!r}: its one slice {extents} is not all of {shape}")
        data = b""
        for field, _, value in _fields(saved):
            if field == 2:  # SavedSlice: name 1, slice 2, data 3
                data = next((v for f, _, v in _fields(value) if f == 3), b"")
        count = int(np.prod(shape, dtype=np.int64))
        values = _proto_values(data, dtype, count, f"tensor {name!r}")
        return _as_tensorflow_returns(_native(values.reshape(shape), dtype))

    def close(self) -> None:
        self._slices.clear()

    def __enter__(self) -> "TableCheckpoint":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _packed(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _varint(buf, pos)
        out.append(v)
    return out


def open_bundle(path: str):
    """A ``Bundle`` (V2) or a ``TableCheckpoint`` (V1), whichever ``path``
    names: V2 where ``<prefix>.index`` exists, as TensorFlow's
    ``CheckpointReader`` tells them."""
    prefix = resolve_prefix(path)
    return Bundle(prefix) if os.path.exists(prefix + ".index") else TableCheckpoint(prefix)


def read_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """``{name: array}`` of every variable ``DROP`` does not match, in
    ``tf.train.load_checkpoint``'s order (``listing``); the dropped ones are
    never decoded (the reference importer's ``read_tf_checkpoint``)."""
    with open_bundle(path) as bundle:
        out = {name: bundle.read(name) for name in bundle.listing if not DROP.search(name)}
    if not out:
        raise SystemExit(f"no model variables found in checkpoint {path!r}")
    return out


__all__ = ["Bundle", "BundleError", "DROP", "TableCheckpoint", "crc32c", "hash_map_order",
           "mask_crc", "open_bundle", "read_tf_checkpoint", "resolve_prefix", "slice_key",
           "unmask_crc"]
