"""The reference's random init, drawn in numpy: what
``g.init(jax.random.PRNGKey(0), ...)`` and ``d.init(jax.random.PRNGKey(1),
...)`` give each leaf of a network (``tools/import_tf1_checkpoint.py:368-369``),
without JAX.

The port's models keep their own torch init everywhere (``ops/
initializers.py``). Only the TF1 importer needs the reference's values: under
``--allow-partial`` a leaf that no checkpoint variable matches keeps the
init the reference tool gives it, so that both tools write the same
checkpoint.

What is reproduced, as JAX 0.9 and flax 0.12 compute it:
- Threefry-2x32 (20 rounds) and the key functions of the partitionable
  threefry (``jax_threefry_partitionable``, on by default): ``fold_in(k, d)``
  is ``threefry(k, (0, d))``, and the bits of element ``i`` of a draw are
  ``x0 ^ x1`` of ``threefry(k, (i >> 32, i & 0xffffffff))``.
- flax's key of a variable: the scope's ``LazyRng`` folds, with one
  ``fold_in``, the first four bytes (big-endian) of the SHA-1 of the module
  path's names and the scope's count of ``make_rng('params')`` calls (one
  per ``param``, zeros and ones included, and one per spectral-norm ``u``;
  none for ``batch_stats``).
- ``jax.random.uniform`` (the top 23 bits as the mantissa of [1, 2), less
  one, scaled and clipped below), ``normal`` (``sqrt(2) * erf_inv(u)``, u
  uniform on (-1, 1)) and ``truncated_normal`` on (-2, 2), with XLA's
  float32 ``erf_inv`` (Giles' polynomials on ``w = -log1p(-x * x)``).
- The reference's initializers: He-normal kernels (``variance_scaling(2,
  fan_in, truncated_normal)``), unit-normal equalized-LR kernels (PGGAN),
  Glorot-uniform label embeddings, ``N(0, 1)`` spectral-norm ``u``, ones
  and zeros for scales, biases and the class-conditional BN's tables, and
  the batch statistics' zeros and ones.

Every step is float32 arithmetic in numpy, with a multiply and an add
fused where XLA's CPU code fuses them (the uniform's scale and shift, the
``erf_inv`` polynomial), except ``log1p``, which numpy takes from the C
library while XLA uses its own: the two part in the last bit of ``w`` in
about one value in six, and so ``erf_inv`` may differ from XLA's by up to
2 ulp and the normal and truncated-normal draws by up to 3
(``tests/test_torch_flax_init.py`` measures both). The uniform draws, and
so the Glorot embeddings, are bit-equal.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf(-2 / sqrt(2)) and erf(2 / sqrt(2)) in float32, as XLA's erf gives them
# (truncated_normal's bounds of the uniform draw)
_ERF_LO = np.array(0xBF745A18, np.uint32).view(np.float32)
_ERF_HI = np.array(0x3F745A18, np.uint32).view(np.float32)
_SQRT2 = np.float32(np.sqrt(2.0))
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# the order in which a module of the reference creates its rng-drawing
# variables (ops/layers.py, ops/norms.py, ops/sn.py): kernel or table, the
# weight-norm scale, the spectral-norm u, then scale and bias
_DRAW_ORDER = {"kernel": 0, "embedding": 0, "wn_g": 1, "u": 2, "scale": 3, "bias": 4}


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of ``key`` on the counter pairs
    ``(x0, x1)`` (uint32 arrays), as ``jax.random``'s ``threefry2x32_p``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & _M32], np.uint32))
    return int(a[0]), int(b[0])


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``."""
    return (seed >> 32) & _M32, seed & _M32


def random_bits(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                        (i & np.uint64(_M32)).astype(np.uint32))
    return (a ^ b).reshape(tuple(shape))


def _fma(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as XLA's CPU code contracts it:
    the float32 product is exact in float64, and the float64 sum rounds to
    the float32 one except on a float32 tie (odds about 2^-29)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key, shape, minval, maxval) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` (``log1p`` from numpy)."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(small, np.float32(_ERFINV_SMALL[0]), np.float32(_ERFINV_LARGE[0]))
        for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            p = _fma(p, w, np.where(small, np.float32(cs), np.float32(cl)))
        out = p * x
    return np.where(np.abs(x) == np.float32(1.0), x * np.finfo(np.float32).max, out)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _SQRT2 * erf_inv(uniform(key, shape, lo, 1.0))


def truncated_normal(key, shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape, float32)``."""
    out = _SQRT2 * erf_inv(uniform(key, shape, _ERF_LO, _ERF_HI))
    return np.clip(out, np.nextafter(np.float32(-2.0), np.float32(np.inf)),
                   np.nextafter(np.float32(2.0), np.float32(-np.inf)))


def _fans(shape: Sequence[int]) -> Tuple[float, float]:
    receptive = int(np.prod(shape[:-2], dtype=np.int64)) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def he_normal(key, shape) -> np.ndarray:
    """``variance_scaling(2.0, "fan_in", "truncated_normal")``."""
    variance = np.float32(2.0 / _fans(shape)[0])
    stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
    return truncated_normal(key, shape) * stddev


def glorot_uniform(key, shape) -> np.ndarray:
    """``variance_scaling(1.0, "fan_avg", "uniform")``."""
    fan_in, fan_out = _fans(shape)
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    return uniform(key, shape, -1.0, 1.0) * np.sqrt(np.float32(3) * variance)


def variable_key(root: Tuple[int, int], scope: Sequence[str], count: int) -> Tuple[int, int]:
    """flax's key of the ``count``-th ``make_rng('params')`` of the module
    at path ``scope`` under the root key ``root``."""
    m = hashlib.sha1()
    for name in scope:
        m.update(name.encode("utf-8"))
    m.update(count.to_bytes((count.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def _draw_counts(keys: Iterable[Tuple[str, ...]]) -> Dict[Tuple[str, ...], int]:
    """Each rng-drawing leaf's count of ``make_rng`` calls in its scope."""
    scopes: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = {}
    for k in keys:
        if k[0] != "batch_stats":
            scopes.setdefault(k[1:-1], []).append(k)
    counts = {}
    for members in scopes.values():
        for i, k in enumerate(sorted(members, key=lambda k: _DRAW_ORDER[k[-1]])):
            counts[k] = i + 1
    return counts


def reference_init(leaves: Sequence[Tuple[str, ...]], shapes: Dict[Tuple[str, ...], tuple],
                   seed: int, equalized: bool, only: Iterable[Tuple[str, ...]] = None
                   ) -> Dict[Tuple[str, ...], np.ndarray]:
    """``{flax keys: float32 array}``: the reference's init with
    ``PRNGKey(seed)`` of the leaves ``only`` (default: all) of a network
    whose leaves are ``leaves`` (``convert.flax_view``'s keys, each
    ``(collection, *module path, name)``) of ``shapes``. ``equalized``:
    kernels are PGGAN's unit-normal equalized-LR ones, else He-normal."""
    root = prng_key(seed)
    counts = _draw_counts(leaves)
    out = {}
    for k in (leaves if only is None else only):
        shape, name, parent = tuple(shapes[k]), k[-1], k[-2] if len(k) > 2 else ""
        if k[0] == "batch_stats":
            out[k] = np.full(shape, 1.0 if name == "var" else 0.0, np.float32)
            continue
        if name in ("bias", "scale") or (name == "embedding" and parent in ("gamma", "beta")):
            # every param draws a key, the constant ones too (counted above)
            one = name == "scale" or (name == "embedding" and parent == "gamma")
            out[k] = np.full(shape, 1.0 if one else 0.0, np.float32)
            continue
        key = variable_key(root, k[1:-1], counts[k])
        if name == "u":
            out[k] = normal(key, shape)
        elif name == "embedding":
            out[k] = glorot_uniform(key, shape)
        elif name == "kernel":
            out[k] = normal(key, shape) if equalized else he_normal(key, shape)
        else:
            raise ValueError(f"no reference init for the leaf {'/'.join(k)}")
    return out


__all__ = ["erf_inv", "fold_in", "glorot_uniform", "he_normal", "normal", "prng_key",
           "random_bits", "reference_init", "threefry2x32", "truncated_normal", "uniform",
           "variable_key"]
