"""Evaluation: IS/FID (port of ``gan_lib_tensorflow_tpu/eval``, without its
SWD and MS-SSIM). The feature extractor of every CLI is
``inception_v3.InceptionV3Features``; ``features.FixedFeatureNet`` is
test-only and deliberately not exported here."""

from .metrics import (DeviceEvalAccumulator, MomentAccumulator,
                      compute_statistics, evaluate_generator, frechet_distance,
                      inception_score_from_probs)

__all__ = [
    "DeviceEvalAccumulator", "MomentAccumulator", "compute_statistics",
    "evaluate_generator", "frechet_distance", "inception_score_from_probs",
]
