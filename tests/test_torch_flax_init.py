"""The reference's random init drawn without JAX (``gan_lib_tensorflow_tpu_
torch/tools/flax_init.py``) against JAX 0.9 and flax 0.12 themselves.

- Threefry-2x32, ``fold_in`` and the bits of a draw are bit-equal to
  ``jax.random``'s; ``uniform`` is bit-equal; ``normal``,
  ``truncated_normal`` and XLA's float32 ``erf_inv`` are bit-equal in most
  values and at most 2 ulp (``erf_inv``) or 3 ulp (the draws) from JAX's,
  where numpy's ``log1p`` and XLA's part in the last bit.
- For each of the five families at a small width (SNGAN CIFAR-10,
  ACGAN, SNGAN-projection ImageNet-128 at width 1/64, pix2pix at ngf/ndf 4,
  PGGAN at 16x16 and width 1/32), what the port's TF1 importer gives a leaf
  no checkpoint variable matches (``unmatched_init``, taken here for every
  leaf) equals the reference tool's ``g_init(PRNGKey(0))`` and
  ``d_init(PRNGKey(1))`` (``tools/import_tf1_checkpoint.py:368-369``) in
  every leaf of every collection: within rtol 1e-6 / atol 1e-7 and 4 ulp
  (a truncated-normal draw's 3, scaled by its float32 standard deviation),
  bit-equal in the Glorot-uniform embeddings and the constant leaves, and
  bit-equal in nine values of ten or more overall.
"""

import os
import sys

import numpy as np
import pytest

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.lax import special as lax_special  # noqa: E402

from gan_lib_tensorflow_tpu_torch.tools import flax_init  # noqa: E402
from gan_lib_tensorflow_tpu_torch.tools import import_tf1_checkpoint as port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import import_tf1_checkpoint as ref  # noqa: E402

FAMILIES = {
    "sngan": ("sngan", []),
    "acgan": ("acgan", []),
    "imagenet": ("imagenet", ["--num-classes", "5", "--width-mul", "0.015625"]),
    "pix2pix": ("pix2pix", ["--ngf", "4", "--ndf", "4", "--image-size", "32"]),
    "pggan": ("pggan", ["--resolution", "16", "--width-mul", "0.03125"]),
}


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_threefry_keys_and_draws_are_jaxs():
    key = jax.random.fold_in(jax.random.PRNGKey(1), 123456789)
    mine = flax_init.fold_in(flax_init.prng_key(1), 123456789)
    assert tuple(int(v) for v in jax.random.key_data(key)) == mine
    np.testing.assert_array_equal(np.asarray(jax.random.bits(key, (7, 5))),
                                  flax_init.random_bits(mine, (7, 5)))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(key, (4099,), jnp.float32, -1, 1)),
                                  flax_init.uniform(mine, (4099,), -1, 1))
    x = np.linspace(-0.99999994, 0.99999994, 100001, dtype=np.float32)
    gap = _ulps(np.asarray(jax.jit(lax_special.erf_inv)(x)), flax_init.erf_inv(x))
    assert gap.max() <= 2 and (gap == 0).mean() > 0.95
    for draw, mine_draw in ((lambda: jax.random.normal(key, (65536,)), flax_init.normal),
                            (lambda: jax.random.truncated_normal(key, -2, 2, (65536,)),
                             flax_init.truncated_normal)):
        gap = _ulps(np.asarray(draw()), mine_draw(mine, (65536,)))
        assert gap.max() <= 3 and (gap == 0).mean() > 0.95


def _ref_inits(args):
    """The reference tool's ``g_init(PRNGKey(0))`` and ``d_init(PRNGKey(1))``
    (its pix2pix D initialized on both images, which its own call omits)."""
    if args.model == "pix2pix":
        from gan_lib_tensorflow_tpu.models import pix2pix
        g = pix2pix.UNetGenerator(base_ch=args.ngf)
        d = pix2pix.PatchGANDiscriminator(base_ch=args.ndf)
        xx = jnp.zeros((1, args.image_size, args.image_size, 3))
        g_init = lambda r: g.init(r, xx, train=False)
        d_init = lambda r: d.init(r, xx, xx, train=False)
    else:
        _, _, g_init, d_init = ref.build_models(args)
    return g_init(jax.random.PRNGKey(0)), d_init(jax.random.PRNGKey(1))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_unmatched_leaves_take_the_references_init(family):
    model, flags = FAMILIES[family]
    args = port.parse_args(["--ckpt", "-", "--model", model] + flags)
    equal = total = 0
    for module, variables, seed in zip(port.build_models(args), _ref_inits(args), (0, 1)):
        want = {keys: val for _, keys, val, _ in ref.flatten_variables(variables)}
        got = port.unmatched_init(module, {}, seed=seed, equalized=model == "pggan")
        assert set(got) == set(want)
        for keys, val in want.items():
            assert got[keys].dtype == np.float32 and got[keys].shape == val.shape, keys
            np.testing.assert_allclose(got[keys], val, rtol=1e-6, atol=1e-7, err_msg=str(keys))
            gap = _ulps(got[keys], val)
            assert gap.max(initial=0) <= 4, keys
            if keys[-1] not in ("kernel", "u"):  # uniform draws and constants
                np.testing.assert_array_equal(got[keys], val, err_msg=str(keys))
            equal += int((gap == 0).sum())
            total += val.size
    assert equal >= 0.9 * total
