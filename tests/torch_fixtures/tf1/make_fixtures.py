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
- ``v1/model.ckpt``: ``SaverDef.V1``, one table file and no ``.index``.

``manifest.json`` lists, for every V2 bundle, each tensor
``tf.train.load_checkpoint`` lists: its dtype, shape and the sha256 of
``np.asarray(reader.get_tensor(name))``'s bytes (bfloat16 widened to
float32 first; strings not hashed).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
V2_BUNDLES = {"dtypes": "dtypes/model.ckpt", "sharded": "sharded/model.ckpt",
              "tf2": "tf2/ckpt-1", "string": "string/model.ckpt"}


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


def _tf2(tf) -> None:
    rng = np.random.default_rng(2)
    os.makedirs(os.path.join(HERE, "tf2"), exist_ok=True)
    module = tf.Module()
    module.gen_kernel = tf.Variable(rng.standard_normal((2, 3)).astype(np.float32))
    module.dis_bias = tf.Variable(rng.standard_normal(3).astype(np.float32))
    tf.train.Checkpoint(model=module).save(os.path.join(HERE, "tf2", "ckpt"))


def _digest(value: np.ndarray) -> str:
    if value.dtype.name == "bfloat16":
        value = value.astype(np.float32)
    return hashlib.sha256(np.ascontiguousarray(value).tobytes()).hexdigest()


def manifest(tf) -> dict:
    out = {}
    for key, prefix in V2_BUNDLES.items():
        reader = tf.train.load_checkpoint(os.path.join(HERE, prefix))
        dtypes = reader.get_variable_to_dtype_map()
        tensors = {}
        for name, shape in sorted(reader.get_variable_to_shape_map().items()):
            entry = {"dtype": dtypes[name].name, "shape": list(shape)}
            if dtypes[name] != tf.string:
                entry["sha256"] = _digest(np.asarray(reader.get_tensor(name)))
            tensors[name] = entry
        out[key] = {"prefix": prefix, "tensors": tensors}
    return out


def main() -> None:
    import tensorflow as tf
    for path in glob.glob(os.path.join(HERE, "*", "*")):
        os.remove(path)
    _saver_bundle(tf, "dtypes", _dtypes)
    _saver_bundle(tf, "sharded", _sharded, sharded=True, devices=2)
    _saver_bundle(tf, "string", _string)
    _saver_bundle(tf, "v1", _string, version=tf.compat.v1.train.SaverDef.V1)
    _tf2(tf)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump({"tensorflow": tf.__version__, "bundles": manifest(tf)}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
