"""The port's InceptionV3 against the JAX package's (mirrors
tests/test_inception.py): the keras parameter count, the npz contract
(``param_paths`` names and shapes, ``load_params_npz`` refusing a missing key
or a wrong shape), the bilinear resize to 299x299, and features and logits
of one batch at 32x32 and at 128x128 in random-init mode (batch statistics)
through one shared npz.

The npz is drawn here with numpy at the JAX package's ``param_paths()``
(shapes from ``jax.eval_shape``, no forward pass), and loaded by both
packages' ``load_params_npz``. Tolerances: the resize rtol 0 / atol 1e-6;
features and logits rtol 1e-3 / atol 3e-4 (float32 through 94 conv+BN
layers in both packages; measured differences are about 6e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gan_lib_tensorflow_tpu.eval import inception_v3 as jinc
from gan_lib_tensorflow_tpu_torch.eval import inception_v3 as tinc


@pytest.fixture(scope="module")
def shapes():
    v = jax.eval_shape(jinc.InceptionV3().init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 299, 299, 3)))
    return jax.tree_util.tree_map(lambda s: s.shape, v["params"])


@pytest.fixture(scope="module")
def npz(shapes, tmp_path_factory):
    """Random weights in the reference's layout: lecun-normal kernels,
    non-zero betas and biases, positive variances."""
    rng = np.random.default_rng(0)
    arrays = {}
    for key, shape in jinc.param_paths(shapes):
        if key.endswith("kernel"):
            fan_in = int(np.prod(shape[:-1]))
            a = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif key.endswith("moving_variance"):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        arrays[key] = a.astype(np.float32)
    path = tmp_path_factory.mktemp("inception") / "inception_v3.npz"
    np.savez(path, **arrays)
    return str(path)


def test_topology_matches_keras():
    with torch.device("meta"):
        m = tinc.InceptionV3()
    # keras InceptionV3(weights=None).count_params() == 23,851,784
    assert sum(t.numel() for t in m.state_dict().values()) == 23_851_784
    x = torch.zeros(2, 3, 299, 299, device="meta")
    feats, logits = m(x)
    assert feats.shape == (2, 2048) and logits.shape == (2, 1000)


def test_param_paths_match_jax(shapes):
    assert tinc.param_paths() == jinc.param_paths(shapes)


@pytest.mark.parametrize("size", [32, 128])
def test_resize_to_299_matches_jax(size):
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(299, 299),
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [32, 128])
def test_features_match_jax_random_init_mode(npz, shapes, size):
    params = jinc.load_params_npz(npz, shapes)
    model = jinc.InceptionV3(use_actual_stats=True)

    @jax.jit
    def jax_features(x):
        x = jax.image.resize(x, (x.shape[0], 299, 299, 3), "bilinear")
        return model.apply({"params": params}, x)

    net = tinc.InceptionV3Features(device="cpu")  # random-init mode: batch statistics
    tinc.load_params_npz(npz, net.model)
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = [np.asarray(t) for t in jax_features(jnp.asarray(x))]
    got = [t.numpy() for t in net(torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and g.std() > 1e-3
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=3e-4)


def test_load_params_npz_refuses_missing_and_misshapen(npz, tmp_path):
    with torch.device("meta"):
        model = tinc.InceptionV3()
    arrays = dict(np.load(npz))
    missing = dict(arrays)
    del missing["mixed5/b7x7dbl_3/conv/kernel"]
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(KeyError, match="mixed5/b7x7dbl_3/conv/kernel"):
        tinc.load_params_npz(str(tmp_path / "missing.npz"), model)
    wrong = dict(arrays)
    wrong["fc/kernel"] = wrong["fc/kernel"].T  # [out, in]: the port's layout, not flax's
    np.savez(tmp_path / "wrong.npz", **wrong)
    with pytest.raises(ValueError, match="shape mismatch fc/kernel"):
        tinc.load_params_npz(str(tmp_path / "wrong.npz"), model)


def test_random_init_extractor_is_seeded_and_refuses_a_downscale():
    a, b = (tinc.InceptionV3Features(seed=3, device="cpu") for _ in range(2))
    for (name, ta), tb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(ta, tb), name
    with pytest.raises(ValueError, match="up to 299x299"):
        a(torch.zeros(1, 300, 300, 3))
