"""Write the TensorFlow bundles under this directory and their manifest.

Run from the repository root, with TensorFlow installed (2.21.0 wrote the
committed ones):  python tests/torch_fixtures/tf1/make_fixtures.py

Bundles (each a directory holding its ``checkpoint`` state file and the
prefix's ``.index`` and ``.data-*`` files; no ``.meta`` graph is
written):
- ``dtypes/model.ckpt``: ``tf.compat.v1.train.Saver``, one shard: float32,
  float64, int32, int64, bool, bfloat16 and float16 tensors and scalars, a
  ``fixed_size_partitioner(2)`` variable ``[8, 3]`` and a
  ``fixed_size_partitioner(3)`` one ``[7, 2]``, optimizer-slot and
  ``global_step`` names that the importer drops;
- ``sharded/model.ckpt``: ``Saver(sharded=True)`` with variables on two
  CPU devices: two data files;
- ``tf2/ckpt-1``: ``tf.train.Checkpoint``, whose object graph is a string
  entry;
- ``string/model.ckpt``: a kept ``tf.string`` variable;
- ``mixed/model.ckpt``: uint8, int8, int16, uint16, uint32, uint64,
  complex64, complex128 and string tensors (a scalar, a vector with an
  empty string and 0x00/0xff bytes, a matrix), a partitioned int16;
- ``v1/model.ckpt``: ``SaverDef.V1``, one table file and no ``.index``;
- ``v1_dtypes/model.ckpt``: V1, every dtype TensorFlow's V1 reader
  returns (float32, float64, int32, int64, uint8, int16, int8, bool,
  string), scalars, a random and a zero 64x64 float32 tensor (its table
  block stays uncompressed: TensorFlow's V1 writer does not compress),
  dropped slot names;
- ``v1_sharded/model.ckpt-?????-of-00002``: V1 ``Saver(sharded=True)`` on
  two CPU devices, two table files read through the pattern;
- ``v1_refused/model.ckpt``: V1 tensors TensorFlow lists and will not read
  (float16, uint16, complex64, a ``fixed_size_partitioner(3)`` variable).

``manifest.json`` lists, for every checkpoint, its format and each tensor
``tf.train.load_checkpoint`` lists: its dtype, shape and the sha256 of
``np.asarray(reader.get_tensor(name))`` (``bundle_writer.digest``:
bfloat16 widened to float32 first; strings as each one's 8-byte length
and bytes), or, where TensorFlow refuses to read it, its error message.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(os.path.dirname(HERE)))]
CHECKPOINTS = {"dtypes": "dtypes/model.ckpt", "sharded": "sharded/model.ckpt",
               "tf2": "tf2/ckpt-1", "string": "string/model.ckpt", "mixed": "mixed/model.ckpt",
               "v1": "v1/model.ckpt", "v1_dtypes": "v1_dtypes/model.ckpt",
               "v1_sharded": "v1_sharded/model.ckpt-?????-of-00002",
               "v1_refused": "v1_refused/model.ckpt"}


def _saver_bundle(tf, name: str, build, sharded: bool = False, devices: int = 1,
                  version=None) -> None:
    tf1 = tf.compat.v1
    os.makedirs(os.path.join(HERE, name), exist_ok=True)
    graph = tf.Graph()
    with graph.as_default():
        build(tf1)
        kwargs = {"save_relative_paths": True, "sharded": sharded}
        if version is not None:
            kwargs["write_version"] = version
        saver = tf1.train.Saver(**kwargs)
        config = tf1.ConfigProto(device_count={"CPU": devices})
        with tf1.Session(graph=graph, config=config) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, os.path.join(HERE, name, "model.ckpt"), write_meta_graph=False)


def _dtypes(tf1):
    import tensorflow as tf
    rng = np.random.default_rng(0)
    const = lambda v, dt=None: tf.constant(v, dtype=dt)
    tf1.get_variable("gen/dense/W", initializer=const(rng.standard_normal((2, 3)).astype(np.float32)))
    tf1.get_variable("gen/dense/b", initializer=const(np.float32(0.25)))
    tf1.get_variable("dis/f64", initializer=const(rng.standard_normal((2, 2))))
    tf1.get_variable("dis/f64_scalar", initializer=const(np.float64(-1.5)))
    tf1.get_variable("dis/i32", initializer=const(np.arange(-2, 3, dtype=np.int32)))
    tf1.get_variable("dis/i64", initializer=const(np.int64(-(1 << 40))))
    tf1.get_variable("dis/flags", initializer=const(np.array([True, False, True])))
    tf1.get_variable("gen/bf16", initializer=const(rng.standard_normal((2, 2)).astype(np.float32),
                                                  tf.bfloat16))
    tf1.get_variable("gen/bf16_scalar", initializer=const(3.140625, tf.bfloat16))
    tf1.get_variable("gen/f16", initializer=const(rng.standard_normal(3).astype(np.float16)))
    tf1.get_variable("gen/part", initializer=const(rng.standard_normal((8, 3)).astype(np.float32)),
                     partitioner=tf1.fixed_size_partitioner(2))
    tf1.get_variable("dis/part3", initializer=const(rng.standard_normal((7, 2)).astype(np.float32)),
                     partitioner=tf1.fixed_size_partitioner(3))
    tf1.get_variable("gen/dense/W/Adam", initializer=const(np.zeros((2, 3), np.float32)))
    tf1.get_variable("beta1_power", initializer=const(np.float32(0.9)))
    tf1.get_variable("global_step", initializer=const(np.int64(100000)))


def _sharded(tf1):
    import tensorflow as tf
    rng = np.random.default_rng(1)
    for i, dev in enumerate(("/cpu:0", "/cpu:1")):
        with tf.device(dev):
            tf1.get_variable(f"gen/w{i}", initializer=tf.constant(
                rng.standard_normal((3, 2)).astype(np.float32)))
            tf1.get_variable(f"dis/w{i}", initializer=tf.constant(
                rng.standard_normal(4).astype(np.float32)))


def _string(tf1):
    import tensorflow as tf
    tf1.get_variable("gen/w", initializer=tf.constant(np.ones((2, 2), np.float32)))
    tf1.get_variable("gen/note", initializer=tf.constant("a string variable"))


def _mixed(tf1):
    import tensorflow as tf
    rng = np.random.default_rng(3)
    const = lambda v, dt=None: tf.constant(v, dtype=dt)
    tf1.get_variable("gen/mask", initializer=const(rng.integers(0, 256, (2, 3)).astype(np.uint8)))
    tf1.get_variable("gen/i8", initializer=const(np.array([-128, -1, 0, 127], np.int8)))
    tf1.get_variable("dis/counts", initializer=const(np.array([-32768, -7, 32767], np.int16)))
    tf1.get_variable("dis/u16", initializer=const(np.array([0, 1, 65535], np.uint16)))
    tf1.get_variable("dis/u32", initializer=const(np.array([0, 4294967295], np.uint32)))
    tf1.get_variable("dis/u64", initializer=const(np.array([18446744073709551615, 5], np.uint64)))
    tf1.get_variable("dis/phase", initializer=const(
        (rng.standard_normal(3) + 1j * rng.standard_normal(3)).astype(np.complex64)))
    tf1.get_variable("gen/c128", initializer=const(rng.standard_normal(2) + 1j))
    tf1.get_variable("gen/note", initializer=const("a kept string"))
    tf1.get_variable("gen/words", initializer=const(np.array([b"ab", b"", b"x\x00\xff"], object)))
    tf1.get_variable("dis/table", initializer=const(np.array([[b"a", b"bc"], [b"def", b"g"]],
                                                             object)))
    tf1.get_variable("dis/part16", initializer=const(np.arange(-6, 6, dtype=np.int16).reshape(4, 3)),
                     partitioner=tf1.fixed_size_partitioner(2))


def _v1_dtypes(tf1):
    import tensorflow as tf
    rng = np.random.default_rng(4)
    const = lambda v: tf.constant(v)
    tf1.get_variable("gen/dense/W", initializer=const(rng.standard_normal((2, 3)).astype(np.float32)))
    tf1.get_variable("gen/big", initializer=const(rng.standard_normal((64, 64)).astype(np.float32)))
    tf1.get_variable("gen/zeros", initializer=const(np.zeros((64, 64), np.float32)))
    tf1.get_variable("dis/f64", initializer=const(np.float64(-1.5)))
    tf1.get_variable("dis/i32", initializer=const(np.arange(-2, 3, dtype=np.int32)))
    tf1.get_variable("dis/i64", initializer=const(np.array([-(1 << 40), 7])))
    tf1.get_variable("gen/mask", initializer=const(np.array([0, 200, 255], np.uint8)))
    tf1.get_variable("dis/counts", initializer=const(np.array([-32768, 5, 32767], np.int16)))
    tf1.get_variable("dis/i8", initializer=const(np.array([-128, 127], np.int8)))
    tf1.get_variable("dis/flags", initializer=const(np.array([True, False, True])))
    tf1.get_variable("gen/note", initializer=const("a V1 string"))
    tf1.get_variable("gen/words", initializer=const(np.array([b"ab", b"", b"x\x00\xff"], object)))
    tf1.get_variable("gen/dense/W/Adam", initializer=const(np.zeros((2, 3), np.float32)))
    tf1.get_variable("global_step", initializer=const(np.int64(100000)))


def _v1_refused(tf1):
    import tensorflow as tf
    rng = np.random.default_rng(5)
    tf1.get_variable("gen/w", initializer=tf.constant(np.ones(3, np.float32)))
    tf1.get_variable("gen/f16", initializer=tf.constant(np.array([0.5, -2.0], np.float16)))
    tf1.get_variable("dis/u16", initializer=tf.constant(np.array([1, 65535], np.uint16)))
    tf1.get_variable("dis/phase", initializer=tf.constant(np.array([1 + 2j], np.complex64)))
    tf1.get_variable("gen/part", initializer=tf.constant(
        rng.standard_normal((7, 2)).astype(np.float32)), partitioner=tf1.fixed_size_partitioner(3))


def _tf2(tf) -> None:
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(HERE, "tf2"), exist_ok=True)
    module = tf.Module()
    module.gen_kernel = tf.Variable(rng.standard_normal((2, 3)).astype(np.float32))
    module.dis_bias = tf.Variable(rng.standard_normal(3).astype(np.float32))
    tf.train.Checkpoint(model=module).save(os.path.join(HERE, "tf2", "ckpt"))


def manifest(tf) -> dict:
    from bundle_writer import digest
    out = {}
    for key, prefix in CHECKPOINTS.items():
        path = os.path.join(HERE, prefix)
        reader = tf.train.load_checkpoint(path)
        dtypes = reader.get_variable_to_dtype_map()
        tensors = {}
        for name, shape in sorted(reader.get_variable_to_shape_map().items()):
            entry = {"dtype": dtypes[name].name, "shape": list(shape)}
            try:
                entry["sha256"] = digest(np.asarray(reader.get_tensor(name)))
            except tf.errors.OpError as e:
                entry["refused"] = e.message
            tensors[name] = entry
        fmt = "V2" if os.path.exists(path + ".index") else "V1"
        out[key] = {"prefix": prefix, "format": fmt, "tensors": tensors}
    return out


def main() -> None:
    import tensorflow as tf
    for path in glob.glob(os.path.join(HERE, "*", "*")):
        os.remove(path)
    _saver_bundle(tf, "dtypes", _dtypes)
    _saver_bundle(tf, "sharded", _sharded, sharded=True, devices=2)
    _saver_bundle(tf, "string", _string)
    _saver_bundle(tf, "mixed", _mixed)
    v1 = tf.compat.v1.train.SaverDef.V1
    _saver_bundle(tf, "v1", _string, version=v1)
    _saver_bundle(tf, "v1_dtypes", _v1_dtypes, version=v1)
    _saver_bundle(tf, "v1_sharded", _sharded, sharded=True, devices=2, version=v1)
    _saver_bundle(tf, "v1_refused", _v1_refused, version=v1)
    _tf2(tf)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"tensorflow": tf.__version__, "bundles": manifest(tf)}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
