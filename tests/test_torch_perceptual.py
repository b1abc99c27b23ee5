"""The port's SWD and MS-SSIM (``eval/perceptual.py``) against the JAX
package's on the CPU, float32 on both sides, inputs from numpy seeds.

- ``laplacian_pyramid``, ``_ssim_cs`` and ``ms_ssim`` (at 64^2 and 16^2 the
  scales truncated to what an 11 px window allows, at 8^2 and 4^2 the single
  scale with the window shrunk to the image): rtol 1e-5 (convolution sum
  order only), atol 1e-6 where a value is a difference near 0.
- ``_patch_descriptors`` with the reference's own ``randint`` origins
  injected: bit-equal (a gather and a cast).
- ``_normalize_descriptors``: within 1 float16 ulp of the reference (float32
  statistics summed in another order).
- ``sliced_wasserstein`` with the reference's direction draws injected: rtol
  1e-5.
- ``swd_pyramid`` with the reference's key schedule replayed through
  ``SWDDraws`` (``perceptual.py:164-172, 195-197``), at 32^2 with 3 levels:
  every ``swd_{res}`` within rtol 1e-3 (float16 descriptors normalized from
  slightly different float32 statistics can round one ulp apart).
- ``ms_ssim_diversity`` on a fixed image batch: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu.eval import perceptual as jp
from gan_lib_tensorflow_tpu_torch.eval import perceptual as tp


def _imgs(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_laplacian_pyramid_matches():
    x = _imgs((2, 32, 32, 3), 0)
    want = jp.laplacian_pyramid(jnp.asarray(x), 3)
    got = tp.laplacian_pyramid(_t(x), 3)
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (2, 32, 32, 3), (2, 16, 16, 3), (2, 8, 8, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size,win", [(32, 11), (7, 7)])
def test_ssim_cs_matches(size, win):
    a = (_imgs((3, size, size, 3), 1) + 1) / 2
    b = (_imgs((3, size, size, 3), 2) + 1) / 2
    lj, csj = jp._ssim_cs(jnp.asarray(a), jnp.asarray(b), win=win)
    lt, cst = tp._ssim_cs(_t(a), _t(b), win=win)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    np.testing.assert_allclose(cst.numpy(), np.asarray(csj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size", [64, 16, 8, 4])
def test_ms_ssim_matches(size):
    """64^2: three scales of the five (an 11 px window each), 16^2: one;
    8^2 and 4^2: one scale with the window shrunk to the image. Pairs of
    correlated images, so the values are far from 0."""
    a = _imgs((4, size, size, 3), 3)
    b = np.clip(a + 0.3 * _imgs((4, size, size, 3), 4), -1, 1)
    want = np.asarray(jp.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = tp.ms_ssim(_t(a), _t(b)).numpy()
    assert got.shape == (4,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _origins(key, b, h, w, n_patches, patch):
    """The reference's ``_patch_descriptors`` draws (``perceptual.py:80-82``)."""
    ky, kx = jax.random.split(key)
    y0 = jax.random.randint(ky, (b, n_patches), 0, h - patch + 1)
    x0 = jax.random.randint(kx, (b, n_patches), 0, w - patch + 1)
    return _t(np.asarray(y0)).long(), _t(np.asarray(x0)).long()


def test_patch_descriptors_bit_equal():
    x = _imgs((3, 20, 24, 3), 5)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jp._patch_descriptors(jnp.asarray(x), key, 16, 7))
    y0, x0 = _origins(key, 3, 20, 24, 16, 7)
    got = tp._patch_descriptors(_t(x), y0, x0, 7)
    assert got.dtype == torch.float16 and got.shape == (48, 147)
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want.view(np.uint16))


def test_normalize_descriptors_within_one_ulp():
    d = (_imgs((4096, 147), 6) * 3 + 0.5).astype(np.float16)
    want = np.asarray(jp._normalize_descriptors(jnp.asarray(d), 7, 3)).astype(np.float32)
    got = tp._normalize_descriptors(_t(d), 7, 3)
    assert got.dtype == torch.float16
    got = got.numpy().astype(np.float32)
    ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    assert np.all(np.abs(got - want) <= ulp)


def test_sliced_wasserstein_with_the_references_directions():
    a = _t((_imgs((2048, 147), 8) * 2).astype(np.float16))
    b = _t((_imgs((2048, 147), 9) * 1.5 + 0.1).astype(np.float16))
    key = jax.random.PRNGKey(11)
    want = float(jp.sliced_wasserstein(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), key))
    normals = _t(np.asarray(jax.random.normal(key, (147, 512))))
    got = float(tp.sliced_wasserstein(a, b, normals))
    np.testing.assert_allclose(got, want, rtol=1e-5)


class JaxKeyDraws(tp.SWDDraws):
    """The reference's key schedule: one split per batch into real and fake
    keys, ``fold_in`` by level, then one split per (level, repeat) for the
    directions."""

    def __init__(self, seed):
        self.rng = jax.random.PRNGKey(seed)

    def start_batch(self):
        self.rng, self.kr, self.kf = jax.random.split(self.rng, 3)

    def patch_origins(self, side, level, b, h, w, n_patches, patch):
        key = jax.random.fold_in(self.kr if side == "real" else self.kf, level)
        return _origins(key, b, h, w, n_patches, patch)

    def directions(self, dim, n):
        self.rng, k = jax.random.split(self.rng)
        return _t(np.asarray(jax.random.normal(k, (dim, n))))


def test_swd_pyramid_replays_the_reference():
    real = [_imgs((4, 32, 32, 3), 20 + i) for i in range(2)]
    fake = [np.clip(r * 0.7 + 0.2 * _imgs(r.shape, 30 + i), -1, 1)
            for i, r in enumerate(real)]
    kw = dict(resolution=32, min_res=8, n_patches=16, seed=3, repeats=2)
    want = jp.swd_pyramid(iter(real), iter(fake), **kw)
    got = tp.swd_pyramid((_t(x) for x in real), (_t(x) for x in fake),
                         draws=JaxKeyDraws(3), **kw)
    assert list(got) == list(want) == ["swd_32", "swd_16", "swd_8", "swd_avg",
                                       "swd_desc_dtype"]
    assert got["swd_desc_dtype"] == want["swd_desc_dtype"] == "float16"
    for k in ("swd_32", "swd_16", "swd_8", "swd_avg"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3)


def test_swd_pyramid_default_draws_repeat():
    """The default draws come from a generator seeded with ``seed``: the
    same call gives the same record; another seed another one."""
    real = [_imgs((2, 16, 16, 3), 40)]
    fake = [_imgs((2, 16, 16, 3), 41)]
    run = lambda seed: tp.swd_pyramid((_t(x) for x in real), (_t(x) for x in fake),
                                      resolution=16, n_patches=8, seed=seed, repeats=1)
    first = run(0)
    assert first == run(0) and first != run(1)
    assert list(first) == ["swd_16", "swd_avg", "swd_desc_dtype"]


@pytest.mark.parametrize("n_pairs", [4, 12])
def test_ms_ssim_diversity_on_fixed_batches(n_pairs):
    """One fixed batch of 4 pairs from every draw (the reference's jitted
    ``pair_scores`` traces its ``sample_fn`` once): mean and std over
    ``n_pairs // 4`` draws."""
    x = _imgs((4, 16, 16, 3), 50)
    batch = np.concatenate([x, np.clip(x + 0.5 * _imgs(x.shape, 60), -1, 1)])
    want = jp.ms_ssim_diversity(lambda r: jnp.asarray(batch), jax.random.PRNGKey(0),
                                n_pairs=n_pairs, batch_size=4)
    got = tp.ms_ssim_diversity(lambda: _t(batch), n_pairs=n_pairs, batch_size=4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
