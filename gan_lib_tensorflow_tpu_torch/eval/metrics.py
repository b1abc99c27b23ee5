"""Inception Score and FID (port of ``gan_lib_tensorflow_tpu/eval/metrics.py``).

``MomentAccumulator``, ``frechet_distance`` and ``inception_score_from_probs``
are copies of the reference's host functions (float64 numpy, scipy's
``sqrtm``): the oracles the device path is tested against.

``DeviceEvalAccumulator`` keeps features, softmax and the FID and IS sums on
the device; they reach the host once, in ``moments()`` and
``inception_score()``. Two differences from the reference, same results:
the class count is read off the feature net (``feature_fn.num_classes``)
instead of a probe forward that paid for the first batch twice; and the IS
split sums are taken per split over the batch's contiguous rows (a batch
covers consecutive sample positions), not with ``index_add_`` /
``scatter_add_``, which use atomics on CUDA and are not deterministic. The
sample and split counts are host integers: they follow from the batch sizes.

With a ``mesh`` (reference ``metrics.py:95-130``) each rank featurizes its
rows of every global batch and adds them at their global positions; the
sums are all-reduced over 'data' once, when the moments or IS are read, so
every rank gets the one-rank statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharding import data_rows, shard_batch


@dataclasses.dataclass
class MomentAccumulator:
    """Streaming mean/covariance of feature vectors (float64 on host); the
    parity oracle of ``DeviceEvalAccumulator``."""

    dim: int

    def __post_init__(self):
        self.n = 0
        self.s1 = np.zeros((self.dim,), np.float64)
        self.s2 = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.s1 += f.sum(0)
        self.s2 += f.T @ f

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu = self.s1 / self.n
        cov = (self.s2 - self.n * np.outer(mu, mu)) / max(self.n - 1, 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (Heusel et al. 2017)."""
    import scipy.linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(covmean))


def inception_score_from_probs(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E KL(p(y|x) || p(y))), mean and std over ``splits`` chunks
    (the reference's formula; host oracle of the device split sums)."""
    scores = []
    n = probs.shape[0]
    for part in np.array_split(probs[: (n // splits) * splits], splits):
        py = part.mean(0, keepdims=True)
        kl = (part * (np.log(part + 1e-16) - np.log(py + 1e-16))).sum(1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


class DeviceEvalAccumulator:
    """Streaming IS/FID statistics on the images' device.

    ``feature_fn(images NHWC in [-1, 1]) -> (features [B, dim], logits [B,
    C])``, with a ``num_classes`` attribute (C). Per batch it adds the FID
    sums ``s1`` and ``s2`` (an fp32 ``matmul``) and, for each IS split the
    batch's positions fall in, ``plogp`` (sum of sum_y p log p) and ``py``
    (sum of p). Positions past ``splits * split_size`` count for FID only:
    the reference truncates IS to a multiple of the split count. On a
    ``mesh`` ``add_images`` takes the rank's rows of a global batch.
    """

    def __init__(self, feature_fn: Callable, dim: int, *, splits: int = 0,
                 split_size: int = 0, mesh=None):
        self.feature_fn = feature_fn
        self.mesh = mesh
        self._reduced = False
        self.dim = dim
        self.num_classes = feature_fn.num_classes
        self.splits = splits
        self.split_size = max(int(split_size), 1)
        self._acc = None  # allocated on the first batch's device
        self._count = 0
        self._split_n = np.zeros(max(splits, 1), np.int64)

    def _init_acc(self, device: torch.device) -> dict:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
        acc = {"s1": z(self.dim), "s2": z(self.dim, self.dim)}
        if self.splits:
            acc.update(plogp=z(self.splits), py=z(self.splits, self.num_classes))
        return acc

    @torch.no_grad()
    def add_images(self, images: torch.Tensor) -> None:
        if self._acc is None:
            self._acc = self._init_acc(images.device)
        feats, logits = self.feature_fn(images)
        f = feats.float()
        acc = self._acc
        acc["s1"] += f.sum(0)
        acc["s2"] += torch.matmul(f.T, f)
        b = f.shape[0]
        d = 1 if self.mesh is None else self.mesh.size("data")
        self._split_counts(self._count, b * d)
        start = self._count + data_rows(b * d, self.mesh).start
        if self.splits:
            p = torch.softmax(logits.float(), -1)
            plogp = (p * torch.log(p + 1e-16)).sum(-1)
            first = start // self.split_size
            last = min((start + b - 1) // self.split_size, self.splits - 1)
            for s in range(first, last + 1):
                lo = max(s * self.split_size - start, 0)
                hi = min((s + 1) * self.split_size - start, b)
                acc["plogp"][s] += plogp[lo:hi].sum()
                acc["py"][s] += p[lo:hi].sum(0)
        self._count += b * d

    def _split_counts(self, start: int, b: int) -> None:
        """Count the global positions ``[start, start + b)`` into the IS
        splits they fall in."""
        for s in range(start // self.split_size,
                       min((start + b - 1) // self.split_size, self.splits - 1) + 1):
            lo, hi = max(s * self.split_size, start), min((s + 1) * self.split_size, start + b)
            self._split_n[s] += max(hi - lo, 0)

    def _sums(self) -> dict:
        """The sums, all-reduced over 'data' the first time on a mesh."""
        if self.mesh is not None and self.mesh.size("data") > 1 and not self._reduced:
            for t in self._acc.values():
                dist.all_reduce(t, group=self.mesh.group("data"))
            self._reduced = True
        return self._acc

    @property
    def count(self) -> int:
        return self._count

    def moments(self) -> Tuple[np.ndarray, np.ndarray]:
        """The one host transfer of the FID sums: mu ``(D,)``, cov ``(D, D)``
        in float64."""
        n = float(self._count)
        acc = self._sums()
        mu = acc["s1"].cpu().numpy().astype(np.float64) / n
        s2 = acc["s2"].cpu().numpy().astype(np.float64)
        return mu, (s2 - n * np.outer(mu, mu)) / max(n - 1, 1)

    def inception_score(self) -> Tuple[float, float]:
        """The reference's split IS from the device split sums."""
        ns = self._split_n[: self.splits].astype(np.float64)
        if not self.splits or not (ns > 0).all():
            raise ValueError(f"IS needs >= {self.splits * self.split_size} "
                             f"samples in {self.splits} splits; split counts {ns}")
        acc = self._sums()
        plogp = acc["plogp"].cpu().numpy().astype(np.float64) / ns
        py = acc["py"].cpu().numpy().astype(np.float64) / ns[:, None]
        scores = np.exp(plogp - (py * np.log(py + 1e-16)).sum(-1))
        return float(scores.mean()), float(scores.std())


def compute_statistics(feature_fn: Callable, batches: Iterable[torch.Tensor],
                       dim: int, mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, cov) of ``feature_fn``'s features over image batches ([-1, 1]
    NHWC tensors), accumulated on their device; on a ``mesh`` each rank
    featurizes its rows of every batch."""
    acc = DeviceEvalAccumulator(feature_fn, dim, mesh=mesh)
    for imgs in batches:
        acc.add_images(shard_batch(imgs, mesh))
    return acc.moments()


def evaluate_generator(sample_batch_fn: Callable[[torch.Generator], torch.Tensor],
                       feature_fn: Callable, dim: int, n_samples: int = 50_000,
                       batch_size: int = 100,
                       generator: Optional[torch.Generator] = None,
                       real_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                       splits: int = 10, mesh=None) -> dict:
    """The reference's eval: ``n_samples`` rounded down to whole batches of
    ``sample_batch_fn(generator)`` (each call draws its noise from
    ``generator``), IS over ``splits`` splits and, given real moments, FID.
    ``samples_evaluated`` / ``samples_dropped`` report the rounding. On a
    ``mesh`` ``sample_batch_fn`` returns the rank's rows of each global
    batch of ``batch_size`` (``parallel.shard_batch`` of its noise)."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    n_batches = max(n_samples // batch_size, 1)
    total = n_batches * batch_size
    is_n = (total // splits) * splits
    acc = DeviceEvalAccumulator(feature_fn, dim, splits=splits,
                                split_size=max(is_n // splits, 1), mesh=mesh)
    for _ in range(n_batches):
        acc.add_images(sample_batch_fn(generator))
    is_mean, is_std = acc.inception_score()
    out = {"inception_score": is_mean, "inception_score_std": is_std,
           "samples_evaluated": total,
           "samples_dropped": max(n_samples - total, 0)}
    if real_stats is not None:
        mu, cov = acc.moments()
        out["fid"] = frechet_distance(mu, cov, *real_stats)
    return out
