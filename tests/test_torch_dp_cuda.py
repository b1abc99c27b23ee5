"""Multi-rank training on the card: two ranks sharing one card through gloo
(CUDA tensors staged through the host), and a one-rank NCCL group. Every
test is marked ``cuda`` and skips without a card. This file imports no JAX,
so on the machine with the card it runs without the JAX package's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_dp_cuda.py

float32 with TF32 off and deterministic cuDNN. The two-rank step against the
one-rank step uses SGD, which is linear in the gradient (as
``tests/test_tensor_parallel.py:27-31`` chooses it): Adam would turn the
summation-order noise of a gradient element near 0 into a difference of 2 *
lr. Metrics rtol 1e-4 / atol 1e-5, parameters rtol 1e-4 / atol 1e-6.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gan_lib_tensorflow_tpu_torch.dryrun import launch

pytestmark = pytest.mark.cuda

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
LR = 0.01


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _step(mesh=None):
    """One fused SNGAN step (G (32, 32), D (32, 32, 32), global batch 4,
    n_critic 2) on the card; metrics, parameters and kernel launches."""
    from gan_lib_tensorflow_tpu_torch.models import sngan
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.parallel import shard_batch
    from gan_lib_tensorflow_tpu_torch.train import create_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    g = sngan.ResNetGenerator(channels=(32, 32), bottom_ch=32, z_dim=16)
    d = sngan.ResNetDiscriminator(channels=(32, 32, 32), downsample=(True, True, False))
    state = create_state(g, d, device="cuda", mesh=mesh)
    state.g_opt = torch.optim.SGD(g.parameters(), lr=LR)
    state.d_opt = torch.optim.SGD(d.parameters(), lr=LR)
    images = torch.from_numpy(np.tanh(np.random.default_rng(0).standard_normal(
        (2, 4, 16, 16, 3))).astype(np.float32)).cuda()
    pi.launches = 0
    metrics = make_train_step(sngan.make_sngan_spec(g, d, n_critic=2))(
        state, shard_batch({"image": images}, mesh, 1))
    out = {f"m/{k}": float(v) for k, v in metrics.items()}
    for net in ("g", "d"):
        out.update({f"{net}/{k}": v.detach().cpu().numpy()
                    for k, v in getattr(state, net).named_parameters()})
    out["launches"] = pi.launches
    return out


def _gloo_rank(workdir):
    from gan_lib_tensorflow_tpu_torch.parallel import create_mesh
    mesh = create_mesh(device="cuda")
    assert mesh.backend == "gloo" and mesh.device == torch.device("cuda", 0)
    np.savez(os.path.join(workdir, f"out{mesh.rank}.npz"), **_step(mesh))


def test_gloo_two_ranks_on_one_card_equal_one_rank(card, tmp_path):
    launch("test_torch_dp_cuda:_gloo_rank", 2, str(tmp_path), {"workdir": str(tmp_path)},
           timeout=300, pythonpath=TESTS)
    ref = _step()
    assert ref["launches"] == 3  # 2 critic D forwards + 1 in the G loss
    for rank in range(2):
        got = dict(np.load(tmp_path / f"out{rank}.npz"))
        assert int(got["launches"]) == 3
        for k, v in ref.items():
            if k != "launches":
                np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                           atol=1e-5 if k.startswith("m/") else 1e-6, err_msg=k)


def test_nccl_one_rank_group(card, tmp_path):
    """``torchrun --nproc_per_node 1``: the same code path on a one-rank
    group, NCCL (the rank has a card of its own)."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "1", "-m", "gan_lib_tensorflow_tpu_torch.cli.train_sngan", "--data", "device-fake",
         "--steps", "2", "--batch-size", "8", "--n-critic", "1", "--log-every", "1",
         "--out-dir", str(tmp_path / "run")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "backend nccl" in proc.stdout, proc.stdout[-3000:]
    assert "step 2 " in proc.stdout
