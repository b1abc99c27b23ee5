"""The yardstick's counts: model FLOPs against a hand count at tiny widths,
and the kernels' bytes against the program's own arithmetic in
``chip_smoke.py`` (158,004,588 B for the ImageNet-128 D's 19 weights; 12 B
per fade-in element)."""

from gan_bench import run
from gan_bench.counts import pggan_celebahq1024 as pg
from gan_bench.counts import sngan_proj_imagenet128 as sn


def _cfg(name):
    return run.load_json("configs", name)


def test_power_iteration_bytes_are_chip_smokes():
    cfg = _cfg("sngan_proj_imagenet128")
    assert sn.power_iteration_bytes(cfg) == 158_004_588
    assert len(sn._d_weights(cfg)) == 19
    assert sum(o * f for o, f in sn._d_weights(cfg)) == 39_435_136


def test_fadein_bytes_are_twelve_per_element():
    cfg = _cfg("pggan_celebahq1024")
    c = pg.counts(cfg, {"resolution": 1024, "batch": 4, "phase": "transition"})
    assert c["fadein_bytes_per_step"] == 12 * (2 * 4 * 3 * 1024 * 1024 + 4 * 4 * 32 * 512 * 512)
    assert "fadein_bytes_per_step" not in pg.counts(cfg, {"resolution": 1024, "batch": 4,
                                                          "phase": "stabilize"})


def test_sngan_flops_by_hand_at_tiny_width():
    cfg = {"g_channels": [2, 1], "d_channels": [1, 2], "d_downsample": [True, False],
           "z_dim": 3, "image_size": 8, "num_classes": 5, "n_critic": 2}
    # G at batch n: dense 3 -> 4x4x2; block0 2->2 at 8x8; block1 2->1 at 16x16; conv_out 1->3
    g = lambda n: 2 * n * (3 * 32 + 64 * 2 * (18 + 18 + 2) + 256 * 1 * (18 + 9 + 2)
                           + 256 * 3 * 9)
    # D at batch n: block0 3->1 at 8x8 (27 + 9 taps), skip 3->1 at 4x4; block1 1->2 at 4x4
    # (9 + 18 taps, a 1x1 skip as the channels change); dense and projection on 2 features
    d = lambda n: 2 * n * (64 * 1 * (27 + 9) + 16 * 3 + 16 * 2 * (9 + 18 + 1) + 2 * 2)
    pi = 4 * (1 * 27 + 1 * 9 + 1 * 3 + 2 * 9 + 2 * 18 + 2 * 1 + 1 * 2 + 2 * 5)
    want = g(2 * 4) + 2 * 3 * d(8) + 3 * g(4) + 2 * d(4) + 3 * pi
    assert sn.counts(cfg, {"batch": 4})["flops_per_step"] == want


def test_pggan_flops_by_hand_at_tiny_width():
    cfg = {"fmap_base": 16, "fmap_decay": 1.0, "fmap_max": 4, "latent_size": 2}
    # nf(4) = 4, nf(8) = 4: G dense 2 -> 4x4x4, conv_4 4->4, block_8 (4->4, 4->4),
    # torgb_8 4->3, fade torgb_4 4->3 at 4x4
    g = 2 * (2 * 64 + 16 * 16 * 9 + 64 * 4 * 9 * 8 + 64 * 3 * 4 + 16 * 3 * 4)
    # D fromrgb_8 3->4, block_8 (4->4, 4->4) at 8x8, fade fromrgb_4 at 4x4,
    # conv_4 5->4, dense_4 64->4, dense_out 4->1
    d = 2 * (64 * 4 * 3 + 64 * 4 * 9 * 8 + 16 * 4 * 3 + 16 * 4 * 5 * 9 + 64 * 4 + 4)
    c = pg.counts(cfg, {"resolution": 8, "batch": 1, "phase": "transition"})
    assert c["flops_per_step"] == 4 * g + 14 * d
