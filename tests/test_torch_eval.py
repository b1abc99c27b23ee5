"""The port's IS/FID machinery against the JAX package (mirrors
tests/test_eval.py): the host oracles on identical numpy inputs, the device
accumulator against the oracles, and ``FixedFeatureNet``,
``compute_statistics`` and ``evaluate_generator`` against the JAX package's
with the same weights (carried across by ``convert.to_torch_names``) and
identical image batches.

Tolerances: the float64 host functions are the same code on the same
inputs, so they agree to rounding (rtol 1e-12). The feature net and the
device sums run in float32 in both packages: features rtol 1e-5 / atol 1e-5,
moments rtol 1e-4 / atol 1e-5, IS rtol 1e-5 and FID rtol 1e-4 / atol 1e-4
(a difference of moments, so an absolute floor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu import eval as jev
from gan_lib_tensorflow_tpu.eval.features import FixedFeatureNet as JaxFixedFeatureNet
from gan_lib_tensorflow_tpu_torch import eval as tev
from gan_lib_tensorflow_tpu_torch.convert import to_torch_names
from gan_lib_tensorflow_tpu_torch.eval.features import FixedFeatureNet


def _nets(image_size=16, feature_dim=32):
    """The JAX net and a port net holding the same weights."""
    jnet = JaxFixedFeatureNet(image_size=image_size, feature_dim=feature_dim)
    tnet = FixedFeatureNet(image_size=image_size, feature_dim=feature_dim, device="cpu")
    tnet.load_state_dict({k: torch.as_tensor(v) for k, v in
                          to_torch_names(jax.device_get(jnet.variables["params"])).items()})
    return jnet, tnet


def test_moment_accumulator_matches_jax():
    x = np.random.default_rng(0).standard_normal((500, 8))
    accs = [tev.MomentAccumulator(8), jev.MomentAccumulator(8)]
    for chunk in np.array_split(x, 7):
        for acc in accs:
            acc.update(chunk)
    (mu_t, cov_t), (mu_j, cov_j) = (a.finalize() for a in accs)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-12)
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-12)
    np.testing.assert_allclose(cov_t, np.cov(x, rowvar=False), rtol=1e-8)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)

    def stats(x):
        return x.mean(0), np.cov(x, rowvar=False)

    a = stats(rng.standard_normal((2000, 16)))
    for b in (a, stats(rng.standard_normal((2000, 16))),
              stats(rng.standard_normal((2000, 16)) + 2.0)):
        np.testing.assert_allclose(tev.frechet_distance(*a, *b),
                                   jev.frechet_distance(*a, *b), rtol=1e-12, atol=1e-9)
    assert 50 < tev.frechet_distance(*a, *stats(rng.standard_normal((2000, 16)) + 2.0)) < 90


def test_inception_score_from_probs_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((1003, 10)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (1, 10):
        np.testing.assert_allclose(tev.inception_score_from_probs(probs, splits),
                                   jev.inception_score_from_probs(probs, splits),
                                   rtol=1e-12)
    uniform = np.full((100, 10), 0.1)
    np.testing.assert_allclose(tev.inception_score_from_probs(uniform)[0], 1.0, rtol=1e-5)


@pytest.mark.parametrize("image_size", [16, 15])  # even and odd: both TF-SAME paddings
def test_fixed_feature_net_matches_jax(image_size):
    jnet, tnet = _nets(image_size)
    imgs = np.random.default_rng(2).uniform(-1, 1, (6, image_size, image_size, 3)
                                            ).astype(np.float32)
    jf, jl = (np.asarray(t) for t in jnet(jnp.asarray(imgs)))
    tf, tl = tnet(torch.from_numpy(imgs))
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5)


def test_device_accumulator_matches_host_oracles():
    """Moments and split IS of ``DeviceEvalAccumulator`` against the float64
    host oracles on the same features; batches straddle split boundaries
    and the last 8 samples fall past the 10 splits (FID only)."""
    _, net = _nets()
    rng = np.random.default_rng(1)
    n, bs, splits, split_size = 600, 48, 10, 59
    imgs = torch.from_numpy(rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32))
    dev = tev.DeviceEvalAccumulator(net, 32, splits=splits, split_size=split_size)
    host = tev.MomentAccumulator(32)
    probs = []
    for chunk in imgs.split(bs):
        dev.add_images(chunk)
        feats, logits = net(chunk)
        host.update(feats.numpy())
        probs.append(torch.softmax(logits, -1).numpy())
    assert dev.count == n
    mu_d, cov_d = dev.moments()
    mu_h, cov_h = host.finalize()
    np.testing.assert_allclose(mu_d, mu_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cov_d, cov_h, rtol=1e-4, atol=1e-6)
    is_d, std_d = dev.inception_score()
    is_h, std_h = tev.inception_score_from_probs(
        np.concatenate(probs)[: splits * split_size], splits)
    np.testing.assert_allclose(is_d, is_h, rtol=1e-5)
    np.testing.assert_allclose(std_d, std_h, rtol=1e-4, atol=1e-6)


def test_compute_statistics_matches_jax():
    jnet, tnet = _nets()
    real = np.random.default_rng(3).uniform(-1, 1, (200, 16, 16, 3)).astype(np.float32)
    mu_j, cov_j = jev.compute_statistics(jnet, iter(np.split(real, 4)), 32)
    mu_t, cov_t = tev.compute_statistics(
        tnet, (torch.from_numpy(b) for b in np.split(real, 4)), 32)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-4, atol=1e-5)


def test_evaluate_generator_matches_jax():
    """Both packages' evaluate_generator over the same sampled batches: the
    JAX sampler draws from its split key chain, and the port's sampler
    hands out those same batches in order."""
    jnet, tnet = _nets()
    bs, n_samples, splits = 50, 420, 4  # 8 batches; 20 samples dropped

    def jax_sample(rng):
        return jax.random.uniform(rng, (bs, 16, 16, 3), minval=-1, maxval=1)

    rng, batches = jax.random.PRNGKey(7), []
    for _ in range(n_samples // bs):  # evaluate_generator's own key chain
        rng, sub = jax.random.split(rng)
        batches.append(torch.from_numpy(np.array(jax_sample(sub))))
    real = np.random.default_rng(3).uniform(-1, 1, (400, 16, 16, 3)).astype(np.float32)
    stats_j = jev.compute_statistics(jnet, iter(np.split(real, 8)), 32)
    stats_t = tev.compute_statistics(tnet, (torch.from_numpy(b) for b in np.split(real, 8)), 32)

    want = jev.evaluate_generator(jax_sample, jnet, 32, n_samples=n_samples,
                                  batch_size=bs, rng=jax.random.PRNGKey(7),
                                  real_stats=stats_j, splits=splits)
    it = iter(batches)
    got = tev.evaluate_generator(lambda gen: next(it), tnet, 32, n_samples=n_samples,
                                 batch_size=bs, real_stats=stats_t, splits=splits)
    assert next(it, None) is None  # every batch used, no probe batch drawn
    assert got["samples_evaluated"] == want["samples_evaluated"] == 400
    assert got["samples_dropped"] == want["samples_dropped"] == 20
    np.testing.assert_allclose(got["inception_score"], want["inception_score"], rtol=1e-5)
    np.testing.assert_allclose(got["inception_score_std"], want["inception_score_std"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=1e-4, atol=1e-4)
    assert got["fid"] < 5.0  # the same distribution as the reals


def test_fixed_feature_net_separates_distributions():
    _, net = _nets()
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(-1, 1, (256, 16, 16, 3)).astype(np.float32))
    b = a * 0.2 - 0.5
    mu_a, cov_a = tev.compute_statistics(net, a.split(64), 32)
    mu_b, cov_b = tev.compute_statistics(net, b.split(64), 32)
    assert tev.frechet_distance(mu_a, cov_a, mu_a, cov_a) < 1e-6
    assert tev.frechet_distance(mu_a, cov_a, mu_b, cov_b) > 0.05


def test_inception_score_needs_every_split_filled():
    _, net = _nets()
    acc = tev.DeviceEvalAccumulator(net, 32, splits=4, split_size=10)
    acc.add_images(torch.zeros(30, 16, 16, 3))
    with pytest.raises(ValueError, match="IS needs >= 40 samples"):
        acc.inception_score()
