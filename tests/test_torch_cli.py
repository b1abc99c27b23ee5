"""The port's SNGAN CLI, device policy, data source and import hygiene.

The CLI test runs one full-width step (G (256, 256, 256), D (128,) * 4) on
the CPU at batch 4 with one critic substep.
"""

import ast
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from gan_lib_tensorflow_tpu_torch.cli import train_sngan
from gan_lib_tensorflow_tpu_torch.data import DeviceFakeImages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gan_lib_tensorflow_tpu_torch")
CPU_ARGS = ["--device", "cpu", "--data", "fake", "--steps", "1",
            "--n-critic", "1", "--batch-size", "4"]


def test_main_one_full_width_step_on_cpu(tmp_path):
    state = train_sngan.main(CPU_ARGS + ["--out-dir", str(tmp_path)])
    assert state.step == 1
    assert sum(p.numel() for p in state.d.parameters()) > 1_000_000
    assert len(state.d.sn_layers) == 11
    with open(tmp_path / "log.jsonl") as f:
        (metrics,) = [json.loads(line) for line in f]
    assert metrics["step"] == 1
    assert set(metrics) == {"step", "d_loss", "d_real", "d_fake", "g_loss"}
    assert all(math.isfinite(v) for v in metrics.values())


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the test checks the CUDA-less policy")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_sngan.main(["--data", "fake", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFakeImages(batch_size=2)


def test_lr_schedule_counts_each_optimizers_own_updates():
    """The reference's optax schedule counts updates per optimizer: with
    --steps 10 and n_critic 5, D's lr is 0 after 2 G steps, G's after 10."""
    args = train_sngan.parse_args(CPU_ARGS[:4] + ["--steps", "10", "--n-critic", "5"])
    _, _, _, state = train_sngan.build(args)
    lrs = []
    for _ in range(3):
        for _ in range(5):
            state.d_opt.step()
            state.d_sched.step()
        state.g_opt.step()
        state.g_sched.step()
        lrs.append((state.d_opt.param_groups[0]["lr"], state.g_opt.param_groups[0]["lr"]))
    assert lrs[0] == pytest.approx((1e-4, 1.8e-4))
    assert lrs[1] == pytest.approx((0.0, 1.6e-4))
    assert lrs[2] == pytest.approx((0.0, 1.4e-4))


def test_device_fake_images():
    a = next(iter(DeviceFakeImages(batch_size=3, n_micro=2, seed=4, device="cpu")))
    b = next(iter(DeviceFakeImages(batch_size=3, n_micro=2, seed=4, device="cpu")))
    assert a["image"].shape == (2, 3, 32, 32, 3) and a["label"].shape == (2, 3)
    assert a["image"].dtype == torch.float32 and a["label"].dtype == torch.int32
    assert float(a["image"].abs().max()) <= 1.0
    assert torch.equal(a["image"], b["image"])  # seeded


def test_import_leaves_jax_out():
    """Importing the port, and what chip_smoke.py imports, loads neither JAX
    nor the JAX package, nor orbax, Pillow, matplotlib or tensorboard (the
    card has none of them)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import chip_smoke, profile_torch_step\n"
        "import gan_lib_tensorflow_tpu_torch.cli.evaluate\n"
        "import gan_lib_tensorflow_tpu_torch.cli.north_star\n"
        "import gan_lib_tensorflow_tpu_torch.cli.sample\n"
        "import gan_lib_tensorflow_tpu_torch.cli.train_acgan\n"
        "import gan_lib_tensorflow_tpu_torch.cli.train_pggan\n"
        "import gan_lib_tensorflow_tpu_torch.cli.train_pix2pix\n"
        "import gan_lib_tensorflow_tpu_torch.cli.train_sngan\n"
        "import gan_lib_tensorflow_tpu_torch.cli.train_sngan_imagenet\n"
        "import gan_lib_tensorflow_tpu_torch.convert\n"
        "import gan_lib_tensorflow_tpu_torch.data.cifar10\n"
        "import gan_lib_tensorflow_tpu_torch.data.device_cache\n"
        "import gan_lib_tensorflow_tpu_torch.data.fake\n"
        "import gan_lib_tensorflow_tpu_torch.data.imagenet\n"
        "import gan_lib_tensorflow_tpu_torch.data.multires\n"
        "import gan_lib_tensorflow_tpu_torch.data.packed\n"
        "import gan_lib_tensorflow_tpu_torch.data.pipeline\n"
        "import gan_lib_tensorflow_tpu_torch.eval.features\n"
        "import gan_lib_tensorflow_tpu_torch.eval.inception_v3\n"
        "import gan_lib_tensorflow_tpu_torch.eval.metrics\n"
        "import gan_lib_tensorflow_tpu_torch.eval.perceptual\n"
        "import gan_lib_tensorflow_tpu_torch.models.acgan\n"
        "import gan_lib_tensorflow_tpu_torch.models.pix2pix\n"
        "import gan_lib_tensorflow_tpu_torch.models.sngan\n"
        "import gan_lib_tensorflow_tpu_torch.ops.fadein\n"
        "import gan_lib_tensorflow_tpu_torch.ops.power_iteration\n"
        "import gan_lib_tensorflow_tpu_torch.parallel.prefetch\n"
        "import gan_lib_tensorflow_tpu_torch.train.checkpoint\n"
        "import gan_lib_tensorflow_tpu_torch.train.export\n"
        "import gan_lib_tensorflow_tpu_torch.utils\n"
        "import gan_lib_tensorflow_tpu_torch.utils.html\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gan_lib_tensorflow_tpu', "
        "'PIL', 'matplotlib', 'tensorboard')]\n"
        "assert not bad, bad\n" % REPO)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env,
                   timeout=120)


def _port_files():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "profile_torch_step.py")


@pytest.mark.parametrize("path", sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports_in_source(path):
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "gan_lib_tensorflow_tpu",
              "PIL", "matplotlib", "tensorboard")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in banned, f"{path} imports {n}"
