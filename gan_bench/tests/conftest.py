"""Small cells for the CPU: the benchmark's two configurations at 1/64 of
their widths (the program's ``--width-mul`` floor), a 32x32 PGGAN rung with
its top two levels on the space-to-depth grid, batch 4, tiny stores. The
program computes in float32 here unless a test asks for bf16."""

import pytest

SNGAN = "sngan_proj_imagenet128.cached"
PGGAN = "pggan_celebahq1024.r1024_fade"


def small(cell: str, dtype: str = "fp32") -> dict:
    if cell == SNGAN:
        return {"config": {"g_channels": [16, 8, 8, 8, 8], "d_channels": [8, 8, 8, 8, 16, 16],
                           "num_classes": 10, "n_gen_samples": 4, "compute_dtype": dtype},
                "traffic": {"store_images": 40, "num_classes": 10, "batch": 4}}
    return {"config": {"fmap_base": 128, "fmap_max": 8, "latent_size": 16,
                       "fused_scale_from": 16, "s2d_from": 16, "images_per_phase": 600,
                       "minibatch_by_resolution": {"32": 4}, "compute_dtype": dtype},
            "traffic": {"store_images": 16, "resolution": 32, "batch": 4, "start_step": 75}}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
