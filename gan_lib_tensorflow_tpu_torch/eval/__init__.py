"""Evaluation (port of ``gan_lib_tensorflow_tpu/eval``): IS/FID, and PGGAN's
SWD and MS-SSIM (``perceptual``). The feature extractor of every IS/FID CLI
is ``inception_v3.InceptionV3Features``; ``features.FixedFeatureNet`` is
test-only and deliberately not exported here."""

from .metrics import (DeviceEvalAccumulator, MomentAccumulator,
                      compute_statistics, evaluate_generator, frechet_distance,
                      inception_score_from_probs)
from .perceptual import (SWDDraws, laplacian_pyramid, ms_ssim, ms_ssim_diversity,
                         sliced_wasserstein, swd_pyramid)

__all__ = [
    "DeviceEvalAccumulator", "MomentAccumulator", "SWDDraws", "compute_statistics",
    "evaluate_generator", "frechet_distance", "inception_score_from_probs",
    "laplacian_pyramid", "ms_ssim", "ms_ssim_diversity", "sliced_wasserstein",
    "swd_pyramid",
]
