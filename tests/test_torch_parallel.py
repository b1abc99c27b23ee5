"""The port's mesh and sharding rules (``parallel/mesh.py``,
``parallel/sharding.py``, ``cli/common.py:maybe_mesh``) against the JAX
package's.

The sharded leaves: the port's ``tensor_parallel_spec`` must name exactly
the leaves that the JAX package's ``tensor_parallel_spec`` puts on the
'model' axis, mapped to port names through ``convert.py``, for the SNGAN
CIFAR-10 and SNGAN-projection ImageNet-128 networks at full width and the
default threshold (256). The port's networks are built on the ``meta``
device and the JAX side is taken from shapes alone (``jax.eval_shape``),
so nothing is initialized.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from gan_lib_tensorflow_tpu.models import sngan as jsngan
from gan_lib_tensorflow_tpu.parallel import create_mesh as jax_mesh
from gan_lib_tensorflow_tpu.parallel import shard_batch as jax_shard_batch
from gan_lib_tensorflow_tpu.parallel import tensor_parallel_spec as jax_spec
from gan_lib_tensorflow_tpu_torch import convert
from gan_lib_tensorflow_tpu_torch.cli import common
from gan_lib_tensorflow_tpu_torch.models import sngan
from gan_lib_tensorflow_tpu_torch.parallel import (data_rows, mesh as pmesh, shard_batch,
                                                   tensor_parallel_spec,
                                                   train_state_shardings)


def _jax_sharded(module, *init_args, t=2):
    shapes = jax.eval_shape(lambda r: module.init(r, *init_args), jax.random.PRNGKey(0))
    mesh = jax_mesh((8 // t, t), ("data", "model"), devices=jax.devices()[:8])
    spec = jax_spec(shapes["params"], mesh)
    flags = jax.tree_util.tree_map(lambda s: np.float32("model" in tuple(s.spec)), spec,
                                   is_leaf=lambda x: isinstance(x, NamedSharding))
    return {k for k, v in convert.to_torch_names(flags).items() if v}


z2 = lambda z: jnp.zeros((2, z))
lab2 = jnp.zeros((2,), jnp.int32)

NETS = {
    "cifar_g": (lambda: sngan.cifar_generator(),
                lambda: (jsngan.ResNetGenerator(), z2(128))),
    "cifar_d": (lambda: sngan.cifar_discriminator(),
                lambda: (jsngan.ResNetDiscriminator(), jnp.zeros((2, 32, 32, 3)))),
    "imagenet_g": (lambda: sngan.imagenet128_generator(),
                   lambda: (jsngan.imagenet128_generator(), z2(128), lab2)),
    "imagenet_d": (lambda: sngan.imagenet128_discriminator(),
                   lambda: (jsngan.imagenet128_discriminator(),
                            jnp.zeros((2, 128, 128, 3)), lab2)),
}


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("net", sorted(NETS))
def test_sharded_leaves_are_the_jax_packages(net, t):
    port, ref = NETS[net]
    with torch.device("meta"):
        module = port()
    jmodule, *args = ref()
    want = _jax_sharded(jmodule, *args, t=t)
    got = tensor_parallel_spec(module, t)
    assert set(got) == want
    assert len(got) == len(set(got))
    # ImageNet-128's wide blocks and its conditional BN / projection tables
    # are what TP is for; the CIFAR D (128 wide) has none at the default
    if net == "imagenet_d":
        assert "proj_embed.weight" in got and len(got) == 12
    if net == "imagenet_g":
        assert "block0.bn1.gamma.weight" in got
    if net == "cifar_d":
        assert got == []


def test_train_state_shardings_names_both_networks_and_nothing_without_model_axis():
    with torch.device("meta"):
        g, d = sngan.imagenet128_generator(), sngan.imagenet128_discriminator()
    model2 = SimpleNamespace(size=lambda axis: 2 if axis == "model" else 1)
    names = train_state_shardings(g, d, model2)
    assert names == {"g": tensor_parallel_spec(g, 2), "d": tensor_parallel_spec(d, 2)}
    assert train_state_shardings(g, d, None) == {"g": [], "d": []}
    # biases, BN scales and the SN u buffers are never named
    assert not any(n.endswith("bias") for n in names["g"] + names["d"])


@pytest.mark.parametrize("d,n", [(2, 8), (4, 8), (8, 8)])
def test_shard_batch_rows_are_the_jax_packages(d, n):
    """Rank i of 'data' d holds the rows the JAX package puts on device i,
    and the leading microbatch stack stays whole."""
    x = np.arange(2 * n * 3, dtype=np.float32).reshape(2, n, 3)
    jmesh = jax_mesh((d,), ("data",), devices=jax.devices()[:d])
    jx = jax_shard_batch({"x": x}, jmesh, leading_stack_dims=1)["x"]
    shards = sorted(jx.addressable_shards, key=lambda s: s.device.id)
    for i in range(d):
        mesh = SimpleNamespace(size=lambda axis: d if axis == "data" else 1,
                               coord=lambda axis, i=i: i if axis == "data" else 0)
        got = shard_batch({"x": torch.from_numpy(x)}, mesh, leading_stack_dims=1)["x"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(shards[i].data))
        assert data_rows(n, mesh) == slice(i * n // d, (i + 1) * n // d)


def test_a_global_batch_must_divide_over_data():
    mesh = SimpleNamespace(size=lambda axis: 4 if axis == "data" else 1, coord=lambda a: 0)
    with pytest.raises(ValueError, match="not divisible by data-mesh size 4"):
        data_rows(6, mesh)


@pytest.mark.parametrize("shape", [(8,), (4, 2), (2, 4), (2, 2, 2)])
def test_mesh_layout_is_row_major(shape):
    """Ranks lay out row-major, as the JAX package reshapes its devices."""
    coords = [pmesh._unravel(r, shape) for r in range(int(np.prod(shape)))]
    assert coords == [tuple(c) for c in np.ndindex(*shape)]
    assert [pmesh._ravel(c, shape) for c in coords] == list(range(len(coords)))


def test_backend_follows_the_devices(monkeypatch):
    assert pmesh.choose_backend(torch.device("cpu"), 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pmesh.choose_backend(torch.device("cuda", 0), 1) == "nccl"
    assert pmesh.choose_backend(torch.device("cuda", 0), 2) == "gloo"  # one card shared
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pmesh.choose_backend(torch.device("cuda", 0), 4) == "nccl"


def _args(*argv):
    return common.base_parser("t").parse_args(["--device", "cpu", *argv])


def test_no_mesh_with_tp_shards_is_refused():
    with pytest.raises(SystemExit, match="conflict"):
        common.maybe_mesh(_args("--no-mesh", "--tp-shards", "2"))


def test_no_mesh_under_several_ranks_exits_2(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        common.maybe_mesh(_args("--no-mesh"))
    assert e.value.code == 2
    assert "2 ranks were started" in capsys.readouterr().err


def test_tp_shards_must_divide_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="--tp-shards 3 does not divide the world size 4"):
        common.maybe_mesh(_args("--tp-shards", "3"))
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        common.maybe_mesh(_args("--tp-shards", "2"))


def test_one_process_without_a_launcher_has_no_mesh(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert common.maybe_mesh(_args()) is None
    assert common.maybe_mesh(_args("--no-mesh")) is None


def test_pggan_refuses_tp_and_sp_shards(monkeypatch, capsys):
    """PGGAN refuses --tp-shards (as the reference); --sp-shards runs when
    its shards of every sharded level hold an even number of rows, 4 or
    more (a power of two; a ladder that ends below 4 * sp shards no level),
    and must divide the world size."""
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan
    with pytest.raises(SystemExit, match="--tp-shards is not supported"):
        train_pggan.parse_args(["--device", "cpu", "--tp-shards", "2"])
    for bad in (["--sp-shards", "3"], ["--sp-shards", "0"], ["--sp-shards", "6"]):
        with pytest.raises(SystemExit) as e:
            train_pggan.parse_args(["--device", "cpu", *bad])
        assert e.value.code == 2
        assert f"--sp-shards {bad[1]}" in capsys.readouterr().err
    assert train_pggan.parse_args(["--device", "cpu", "--sp-shards", "1"]).sp_shards == 1
    assert train_pggan.parse_args(["--device", "cpu", "--sp-shards", "4",
                                   "--final-resolution", "8"]).sp_shards == 4
    args = train_pggan.parse_args(["--device", "cpu", "--sp-shards", "2",
                                   "--final-resolution", "8"])
    assert args.sp_shards == 2
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="--sp-shards 2 must divide the world size 3"):
        common.maybe_mesh(args)
    with pytest.raises(SystemExit, match="conflict"):
        common.maybe_mesh(train_pggan.parse_args(["--device", "cpu", "--sp-shards", "2",
                                                  "--no-mesh"]))


def test_pggan_s2d_from_defaults_to_the_references_512():
    from gan_lib_tensorflow_tpu_torch.cli import train_pggan
    args = train_pggan.parse_args(["--device", "cpu"])
    assert args.s2d_from == 512
    assert train_pggan.ladder_config(args).s2d_from_resolution == 512
    assert train_pggan.parse_args(["--device", "cpu", "--s2d-from", "0"]).s2d_from == 0


@pytest.mark.parametrize("cli", ["train_sngan", "train_sngan_imagenet", "train_acgan",
                                 "train_pix2pix", "train_pggan"])
def test_every_training_cli_takes_the_flags(cli):
    import importlib
    mod = importlib.import_module(f"gan_lib_tensorflow_tpu_torch.cli.{cli}")
    args = mod.parse_args(["--device", "cpu", "--trace-steps", "3", "--debug-nans",
                           "--no-mesh"])
    assert args.trace_steps == 3 and args.debug_nans and args.no_mesh
    assert args.tp_shards == 1
