"""The port's tensor-bundle reader (``gan_lib_tensorflow_tpu_torch/tools/
tf1_bundle.py``) against TensorFlow's own reader.

Every tensor is held bit-equal (no tolerance) to
``np.asarray(tf.train.load_checkpoint(prefix).get_tensor(name))``,
bfloat16 widened to float32 on both sides, strings element for element,
on the TensorFlow-written fixtures under ``tests/torch_fixtures/tf1/``
(every dtype, scalars, ``fixed_size_partitioner`` variables, a two-shard
``Saver(sharded=True)`` bundle, a TF2 ``tf.train.Checkpoint``, and the V1
format: one file, two shards through their pattern, and the tensors
TensorFlow's V1 reader refuses, which the reader refuses too) and on the
checkpoints of the test scaffolding writer (``bundle_writer.py``: many
blocks, prefix-compressed keys, slices and shards, V1 files). Corrupt and
unsupported inputs are refused by name. The CRC32C is held to the plain
byte loop at sizes either side of its lanes.

``listing`` is held equal, as a list, to the order of
``get_variable_to_shape_map()`` (a libstdc++ hash map's, which the
reference importer reads) on every committed fixture and on writer
checkpoints of names that tie in the importer's natural-sort key (``a01``
and ``a1``, ``w_1`` and ``w_01``), V2 and V1 (one and three files), with
enough names to rehash the map several times; ``hash_map_order`` is held
to the order TensorFlow gives for names inserted in key order.
"""

import hashlib
import importlib
import json
import os
import shutil
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from gan_lib_tensorflow_tpu_torch.tools import tf1_bundle  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "tf1")
sys.path.insert(0, FIXTURES)
import bundle_writer  # noqa: E402

MANIFEST = json.load(open(os.path.join(FIXTURES, "manifest.json")))
V2 = sorted(MANIFEST["bundles"])


def _prefix(key: str) -> str:
    return os.path.join(FIXTURES, MANIFEST["bundles"][key]["prefix"])


def _tf_value(reader, name: str) -> np.ndarray:
    value = np.asarray(reader.get_tensor(name))
    return value.astype(np.float32) if value.dtype.name == "bfloat16" else value


def _assert_bit_equal(got: np.ndarray, want: np.ndarray, name: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, want.dtype)
    if got.dtype == object:
        assert all(type(g) is bytes for g in got.ravel()), name
        assert got.ravel().tolist() == want.ravel().tolist(), name
    else:
        assert np.ascontiguousarray(got).tobytes() == np.ascontiguousarray(want).tobytes(), name


def _copy(key: str, dest) -> str:
    src = os.path.dirname(_prefix(key))
    shutil.copytree(src, dest / key)
    return str(dest / key / os.path.basename(_prefix(key)))


@pytest.mark.parametrize("key", V2)
def test_reader_equals_tensorflow(key):
    reader = tf.train.load_checkpoint(_prefix(key))
    shapes, dtypes = reader.get_variable_to_shape_map(), reader.get_variable_to_dtype_map()
    with tf1_bundle.open_bundle(_prefix(key)) as bundle:
        assert type(bundle).__name__ == ("Bundle" if MANIFEST["bundles"][key]["format"] == "V2"
                                         else "TableCheckpoint")
        assert set(bundle.variables) == set(shapes)
        if isinstance(bundle, tf1_bundle.Bundle):
            assert list(bundle.variables) == sorted(bundle.variables)  # the bundle's key order
        for name, (dtype, shape) in bundle.variables.items():
            assert dtype == dtypes[name].name and list(shape) == list(shapes[name]), name
            try:
                want = _tf_value(reader, name)
            except tf.errors.UnimplementedError as e:  # TensorFlow's V1 reader refuses it
                with pytest.raises(tf1_bundle.BundleError, match=f"'{name}'.*{e.message}"):
                    bundle.read(name)
                continue
            _assert_bit_equal(bundle.read(name), want, name)


@pytest.mark.parametrize("key", V2)
def test_listing_is_tensorflows(key):
    reader = tf.train.load_checkpoint(_prefix(key))
    with tf1_bundle.open_bundle(_prefix(key)) as bundle:
        assert bundle.listing == list(reader.get_variable_to_shape_map())


# names that tie in the importer's natural-sort key, and fillers that take
# the map through its rehashes at 14, 30, 60 and 128 names
TIED = ["a01", "a1", "w_1", "w_01", "dis/conv01/W", "dis/conv1/W", "gen/b_002", "gen/b_2",
        "Discriminator.01.W", "Discriminator.1.W"]


@pytest.mark.parametrize("fmt", ["v2", "v1", "v1_3_files"])
def test_listing_is_tensorflows_on_tied_names(fmt, tmp_path):
    rng = np.random.default_rng(7)
    names = TIED + [f"dis/block{i}/{leaf}" for i in range(30) for leaf in ("W", "b", "u", "g")]
    tensors = {name: rng.standard_normal(2).astype(np.float32) for name in names}
    if fmt == "v2":
        path = bundle_writer.write_bundle(str(tmp_path / "model.ckpt"), tensors)
    else:
        path = bundle_writer.write_v1(str(tmp_path / "model.ckpt"), tensors,
                                      num_shards=3 if fmt == "v1_3_files" else 1)
    want = list(tf.train.load_checkpoint(path).get_variable_to_shape_map())
    with tf1_bundle.open_bundle(path) as bundle:
        assert bundle.listing == want and want != sorted(want)
    assert list(tf1_bundle.read_tf_checkpoint(path)) == [n for n in want
                                                         if not tf1_bundle.DROP.search(n)]
    if fmt == "v2":
        assert tf1_bundle.hash_map_order(sorted(names)) == want


def test_committed_fixtures_equal_their_manifest():
    n = refused = 0
    for key, entry in MANIFEST["bundles"].items():
        with tf1_bundle.open_bundle(_prefix(key)) as bundle:
            assert set(bundle.variables) == set(entry["tensors"]), key
            for name, want in entry["tensors"].items():
                dtype, shape = bundle.variables[name]
                assert (dtype, list(shape)) == (want["dtype"], want["shape"]), name
                if "sha256" in want:
                    assert bundle_writer.digest(bundle.read(name)) == want["sha256"], name
                    n += 1
                else:
                    with pytest.raises(tf1_bundle.BundleError, match=want["refused"]):
                        bundle.read(name)
                    refused += 1
    assert (n, refused) == (58, 4)


def test_every_dtype_and_the_partitioned_variables():
    with tf1_bundle.open_bundle(_prefix("dtypes")) as bundle:
        kinds = {dtype for dtype, _ in bundle.variables.values()}
        assert kinds == {"float32", "float64", "int32", "int64", "bool", "bfloat16", "float16"}
        assert any(shape == () for _, shape in bundle.variables.values())
        # two variables saved as 2 and 3 slices: the five slice entries are
        # in the index and never listed, the full tensors are
        assert len(bundle._slice_entries) == 5
        assert {"gen/part", "dis/part3"} <= set(bundle.variables)
        assert not any(name.startswith("\x00") for name in bundle.variables)
        assert bundle.variables["dis/part3"] == ("float32", (7, 2))
        reader = tf.train.load_checkpoint(_prefix("dtypes"))
        for name in ("gen/part", "dis/part3"):
            _assert_bit_equal(bundle.read(name), _tf_value(reader, name), name)


def test_two_shard_bundle():
    with tf1_bundle.open_bundle(_prefix("sharded")) as bundle:
        assert bundle.num_shards == 2
        assert {e.shard_id for e in bundle._entries.values()} == {0, 1}


def test_tf2_object_graph_is_listed_and_dropped_undecoded(monkeypatch):
    with tf1_bundle.open_bundle(_prefix("tf2")) as bundle:
        assert bundle.variables["_CHECKPOINTABLE_OBJECT_GRAPH"] == ("string", ())
    read = []
    original = tf1_bundle.Bundle.read
    monkeypatch.setattr(tf1_bundle.Bundle, "read",
                        lambda self, name: read.append(name) or original(self, name))
    got = tf1_bundle.read_tf_checkpoint(os.path.dirname(_prefix("tf2")))  # a directory
    assert sorted(got) == ["model/dis_bias/.ATTRIBUTES/VARIABLE_VALUE",
                           "model/gen_kernel/.ATTRIBUTES/VARIABLE_VALUE"]
    assert read == list(got)  # save_counter and the object graph never decoded


@pytest.mark.parametrize("escaped", [False, True], ids=["utf8", "octal"])
def test_directory_with_a_non_ascii_name(escaped, tmp_path):
    """A checkpoint directory named outside ASCII. TensorFlow's Saver writes
    the path's UTF-8 bytes into ``checkpoint`` as they are; protobuf's text
    format without ``as_utf8`` escapes each of them as octal. Both resolve
    to the prefix TensorFlow reads."""
    from google.protobuf import text_format
    directory = tmp_path / 'run_\u00e9_\u65e5\u672c "q"'
    directory.mkdir()
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    tf.compat.v1.train.Saver(var_list={"gen/W": tf.Variable(value)}).save(
        None, str(directory / "model.ckpt"), write_meta_graph=False)
    if escaped:
        state = tf.train.get_checkpoint_state(str(directory))
        (directory / "checkpoint").write_text(text_format.MessageToString(state, as_utf8=False))
        assert "\\303\\251" in (directory / "checkpoint").read_text()
    reader = tf.train.load_checkpoint(str(directory))
    got = tf1_bundle.read_tf_checkpoint(str(directory))
    assert list(got) == ["gen/W"]
    _assert_bit_equal(got["gen/W"], _tf_value(reader, "gen/W"), "gen/W")
    _assert_bit_equal(got["gen/W"], value, "gen/W")


def _flip(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


@pytest.mark.parametrize("fault", ["data byte", "index byte", "magic", "compression", "v1",
                                   "string", "big endian"])
def test_refusals(fault, tmp_path):
    if fault == "big endian":  # a header saying BIG (field 2 = 1), no tensors
        header = bundle_writer._field(1, 1) + bundle_writer._field(2, 1)
        prefix = str(tmp_path / "big.ckpt")
        open(prefix + ".index", "wb").write(bundle_writer._table([(b"", header)], 4096))
        open(prefix + ".data-00000-of-00001", "wb").close()
        with pytest.raises(tf1_bundle.BundleError, match="BIG-endian"):
            tf1_bundle.open_bundle(prefix)
        return
    if fault == "v1":  # read since V1 tables are: a pattern or a directory, as TensorFlow
        reader = tf.train.load_checkpoint(os.path.join(FIXTURES, "v1"))
        for path in (os.path.join(FIXTURES, "v1", "model.ckpt"), os.path.join(FIXTURES, "v1")):
            got = tf1_bundle.read_tf_checkpoint(path)
            assert sorted(got) == ["gen/note", "gen/w"]
            for name in got:
                _assert_bit_equal(got[name], _tf_value(reader, name), name)
        assert got["gen/note"].dtype == np.dtype("S17") and got["gen/note"][()] == \
            b"a string variable"
        return
    if fault == "string":  # decoded as TensorFlow returns it: a string scalar is bytes
        got = tf1_bundle.read_tf_checkpoint(_prefix("string"))
        want = np.asarray(tf.train.load_checkpoint(_prefix("string")).get_tensor("gen/note"))
        _assert_bit_equal(got["gen/note"], want, "gen/note")
        assert got["gen/note"][()] == b"a string variable"
        return
    prefix = _copy("dtypes", tmp_path)
    index = prefix + ".index"
    if fault == "data byte":
        with tf1_bundle.open_bundle(prefix) as bundle:
            entry = bundle._entries["gen/dense/W"]
        _flip(prefix + ".data-00000-of-00001", entry.offset + 5)
        with pytest.raises(tf1_bundle.BundleError, match="'gen/dense/W': data CRC32C mismatch"):
            tf1_bundle.read_tf_checkpoint(prefix)
        with pytest.raises(Exception, match="(?i)checksum"):  # TensorFlow refuses it too
            tf.train.load_checkpoint(prefix).get_tensor("gen/dense/W")
        return
    if fault == "index byte":
        _flip(index, 10)  # inside the first data block
        with pytest.raises(tf1_bundle.BundleError, match="block CRC32C mismatch"):
            tf1_bundle.open_bundle(prefix)
        return
    if fault == "magic":
        _flip(index, os.path.getsize(index) - 1)
        with pytest.raises(tf1_bundle.BundleError, match="bad table magic"):
            tf1_bundle.open_bundle(prefix)
        return
    # a block whose compression byte says snappy, its CRC made right again
    data = bytearray(open(index, "rb").read())
    footer = data[-tf1_bundle.FOOTER_BYTES:]
    pos = 0
    for _ in range(2):
        _, pos = tf1_bundle._varint(footer, pos)
    off, pos = tf1_bundle._varint(footer, pos)
    size, _ = tf1_bundle._varint(footer, pos)
    data[off + size] = 1
    crc = tf1_bundle.mask_crc(tf1_bundle.crc32c(bytes(data[off:off + size + 1])))
    data[off + size + 1:off + size + 5] = crc.to_bytes(4, "little")
    open(index, "wb").write(bytes(data))
    with pytest.raises(tf1_bundle.BundleError, match="compression type 1"):
        tf1_bundle.open_bundle(prefix)


def test_writer_bundles_read_back_through_tensorflow(tmp_path):
    rng = np.random.default_rng(5)
    tensors = {
        "gen/W": rng.standard_normal((5, 7)).astype(np.float32),
        "gen/scalar": np.float32(1.5), "dis/f64": rng.standard_normal(4),
        "dis/i32": rng.integers(-9, 9, (2, 3)).astype(np.int32), "dis/i64": np.int64(-3),
        "dis/mask": rng.integers(0, 2, 6).astype(bool),
        "gen/half": rng.standard_normal(5).astype(np.float16),
        "gen/bf": bundle_writer.Bfloat16(rng.standard_normal((3, 2))),
        "gen/part": rng.standard_normal((9, 4)).astype(np.float32),
        "dis/big": rng.standard_normal((64, 64)).astype(np.float32),
        "dis/u8": np.array([0, 255], np.uint8), "dis/i16": np.array([-32768, 7], np.int16),
        "dis/i8": np.int8(-5), "dis/u16": np.array([65535], np.uint16),
        "dis/u32": np.array([1, 4294967295], np.uint32), "dis/u64": np.uint64(2 ** 64 - 1),
        "gen/c64": np.array([1 - 2j], np.complex64), "gen/c128": np.complex128(3 + 4j),
        "gen/note": np.array(b"kept"), "gen/words": np.array([[b"a", b""], [b"\xff", b"bc"]], object),
    }
    for i in range(40):  # enough keys for several blocks and restart points
        tensors[f"gen/block{i}/conv/b"] = rng.standard_normal(3).astype(np.float32)
    prefix = bundle_writer.write_bundle(str(tmp_path / "model.ckpt"), tensors, num_shards=3,
                                        partitions={"gen/part": 4}, block_size=256)
    reader = tf.train.load_checkpoint(prefix)
    with tf1_bundle.open_bundle(prefix) as bundle:
        assert bundle.num_shards == 3 and len(bundle._slice_entries) == 4
        assert set(bundle.variables) == set(reader.get_variable_to_shape_map()) == set(tensors)
        for name, value in tensors.items():
            want = value.widened() if isinstance(value, bundle_writer.Bfloat16) else np.asarray(value)
            _assert_bit_equal(_tf_value(reader, name), want, name)
            _assert_bit_equal(bundle.read(name), want, name)


@pytest.mark.parametrize("num_shards", [1, 3])
def test_v1_writer_reads_back_through_tensorflow(num_shards, tmp_path):
    rng = np.random.default_rng(6)
    tensors = {
        "gen/W": rng.standard_normal((5, 7)).astype(np.float32), "gen/scalar": np.float32(1.5),
        "dis/f64": rng.standard_normal(4), "dis/i32": np.array([-5, 0, 2 ** 31 - 1], np.int32),
        "dis/i64": np.int64(-3), "dis/u8": np.array([0, 255], np.uint8),
        "dis/i16": np.array([-32768, 1], np.int16), "dis/i8": np.array([-128, 127], np.int8),
        "dis/mask": np.array([True, False]), "gen/note": np.array(b"xy"),
        "gen/words": np.array([b"a", b"", b"\x00\xff"], object),
        "gen/empty": np.zeros((0, 3), np.float32),
    }
    for i in range(30):  # several blocks
        tensors[f"gen/block{i}/b"] = rng.standard_normal(3).astype(np.float32)
    path = bundle_writer.write_v1(str(tmp_path / "model.ckpt"), tensors, num_shards=num_shards,
                                  block_size=256)
    reader = tf.train.load_checkpoint(path)
    with tf1_bundle.open_bundle(path) as ckpt:
        assert isinstance(ckpt, tf1_bundle.TableCheckpoint) and ckpt.num_shards == num_shards
        assert set(ckpt.variables) == set(reader.get_variable_to_shape_map()) == set(tensors)
        for name, value in tensors.items():
            want = _tf_value(reader, name)
            _assert_bit_equal(ckpt.read(name), want, name)
            assert bundle_writer.digest(want) == bundle_writer.digest(np.asarray(value)), name


@pytest.mark.parametrize("where", ["length", "string byte"])
def test_corrupt_string_tensor_refused(where, tmp_path):
    prefix = _copy("mixed", tmp_path)
    with tf1_bundle.open_bundle(prefix) as bundle:
        entry = bundle._entries["gen/words"]
    # the lengths are 3 varints (2, 0, 3), then their masked CRC, then "ab" "" "x\0\xff"
    _flip(prefix + ".data-00000-of-00001", entry.offset + (0 if where == "length" else 8))
    want = "string lengths CRC32C" if where == "length" else "data CRC32C mismatch"
    with pytest.raises(tf1_bundle.BundleError, match=f"'gen/words'.*({want}|bytes for 3)"):
        tf1_bundle.open_bundle(prefix).read("gen/words")
    with pytest.raises(Exception):  # TensorFlow refuses it too
        tf.train.load_checkpoint(prefix).get_tensor("gen/words")


def test_no_checkpoint_at_the_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="no V1 table file matches"):
        tf1_bundle.read_tf_checkpoint(str(tmp_path / "model.ckpt-?????-of-00002"))


@pytest.mark.parametrize("n", [0, 1, 9, 4095, 4096, 4099, 70_001, 1 << 20])
def test_crc32c_equals_the_byte_loop(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    want = tf1_bundle._register_scalar(0xFFFFFFFF, data.tobytes()) ^ 0xFFFFFFFF
    assert tf1_bundle.crc32c(data) == want
    assert tf1_bundle.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert tf1_bundle.unmask_crc(tf1_bundle.mask_crc(want)) == want


BLOCKED = ("tensorflow", "google", "jax", "jaxlib", "flax", "optax", "orbax", "PIL",
           "gan_lib_tensorflow_tpu")
FRESH = ("gan_lib_tensorflow_tpu_torch", "bundle_writer")


def test_reader_and_tool_import_without_tensorflow_protobuf_or_jax(tmp_path):
    """The reader, the import tool, the bundle writer and the image decoder,
    imported afresh with TensorFlow, protobuf, JAX, Pillow and the JAX
    package blocked: each of their modules, loaded or not, reads ``None`` in
    ``sys.modules``, so any import of one raises. A V1 checkpoint is read
    and WebP fixtures decode to their manifest's hashes. The port's modules
    are put back as they were."""
    before = dict(sys.modules)
    try:
        for name in before:
            top = name.split(".")[0]
            if top in FRESH:
                del sys.modules[name]
            elif top in BLOCKED:
                sys.modules[name] = None
        for name in BLOCKED + ("google.protobuf",):
            sys.modules[name] = None
        tool = importlib.import_module("gan_lib_tensorflow_tpu_torch.tools.import_tf1_checkpoint")
        reader = importlib.import_module("gan_lib_tensorflow_tpu_torch.tools.tf1_bundle")
        writer = importlib.import_module("bundle_writer")
        assert reader is not tf1_bundle and tool.read_tf_checkpoint is reader.read_tf_checkpoint
        got = reader.read_tf_checkpoint(_prefix("dtypes"))
        assert len(got) == 12, sorted(got)
        g = {"Generator.%02d.W" % i: np.ones((3, 3, 8, 8), np.float32) for i in range(2)}
        d = {"Discriminator.00.W": np.ones((3, 3, 3, 8), np.float32)}
        prefix = writer.write_bundle(str(tmp_path / "m.ckpt"), {**g, **d})
        assert tool.main(["--ckpt", prefix, "--model", "pggan", "--resolution", "8",
                          "--width-mul", "0.015625", "--out-dir", str(tmp_path),
                          "--report-only", "--device", "cpu"]) == 0
        v1 = reader.read_tf_checkpoint(_prefix("v1_dtypes"))
        assert writer.digest(v1["gen/words"]) == \
            MANIFEST["bundles"]["v1_dtypes"]["tensors"]["gen/words"]["sha256"]
        codec = importlib.import_module("gan_lib_tensorflow_tpu_torch.data.codec")
        webp = os.path.join(REPO, "tests", "torch_fixtures", "webp")
        files = json.load(open(os.path.join(webp, "manifest.json")))["files"]
        for name in ("lossy_alpha_q50.webp", "lossless_256.webp", "animation_offset_frame.webp"):
            rgb = codec.decode_rgb(os.path.join(webp, name))
            assert hashlib.sha256(rgb.tobytes()).hexdigest() == files[name]["rgb_sha256"], name
        assert all(sys.modules[name] is None for name in BLOCKED)
    finally:
        for name in list(sys.modules):
            if name.split(".")[0] in FRESH + BLOCKED and name not in before:
                del sys.modules[name]
        sys.modules.update(before)
    assert os.path.exists(tmp_path / "import_report.json")
