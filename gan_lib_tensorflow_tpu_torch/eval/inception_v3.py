"""InceptionV3, the IS/FID feature network (port of
``gan_lib_tensorflow_tpu/eval/inception_v3.py``).

The keras/TF-slim topology: every conv is bias-free and followed by a
BatchNorm without gamma (eps 1e-3, biased variance) and a ReLU; mixed0 ...
mixed10; 2048-d pool3 features (global mean) and 1000-way logits. Module
names are the reference's flax names (``stem1`` ... ``stem5``, ``mixed0`` ...
``mixed10``, ``b1x1``, ``b5x5_1``, ..., ``fc``), so ``param_paths()`` lists
the reference's npz keys and ``load_params_npz`` reads the same npz: keys
are '/'-joined flax paths, conv kernels HWIO (turned to OIHW here), the
Dense kernel ``[in, out]``; a missing key or a wrong shape raises.

Convs are TF "SAME" at stride 1 (symmetric ``(kh // 2, kw // 2)`` padding,
every kernel here is odd) and "VALID" otherwise; the SAME average pool
excludes padding from its count; the max pools are VALID.

Without weights (``params_npz=None``) the net is a seed-fixed random init
that normalizes with each batch's own statistics, as the reference's
random-init mode does: with untrained weights the stored (0, 1) statistics
let 48 conv layers saturate. Its features then depend on the batch's
composition, and its IS/FID are not comparable to published Inception
numbers.

``InceptionV3Features`` takes NHWC images in [-1, 1] up to 299x299, resizes
them to 299x299 bilinearly (half-pixel centres, edge-clamped: the
reference's ``jax.image.resize(..., "bilinear")`` for an upscale), and runs
in float32 with TF32 off, on the CPU or the card alike.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops import initializers

SIZE = 299


class BasicConv(nn.Module):
    """Conv (no bias) + BN(no gamma, eps 1e-3) + ReLU, keras BasicConv2d."""

    def __init__(self, in_ch: int, features: int, kernel_size=(3, 3),
                 stride: int = 1, padding: str = "SAME",
                 use_actual_stats: bool = False):
        super().__init__()
        kh, kw = kernel_size
        pad = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)
        self.conv = nn.Conv2d(in_ch, features, (kh, kw), stride, pad, bias=False)
        self.beta = nn.Parameter(torch.zeros(features))
        self.register_buffer("moving_mean", torch.zeros(features))
        self.register_buffer("moving_variance", torch.ones(features))
        self.use_actual_stats = use_actual_stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.use_actual_stats:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = self.moving_mean, self.moving_variance
        scale = torch.rsqrt(var + 1e-3)
        x = (x - mean[:, None, None]) * scale[:, None, None] + self.beta[:, None, None]
        return F.relu(x)


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool_valid(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """A mixed block: named branches, each a chain of ``BasicConv``s."""

    def conv(self, name: str, in_ch: int, features: int, kernel_size=(1, 1),
             stride: int = 1, padding: str = "SAME") -> int:
        self.add_module(name, BasicConv(in_ch, features, kernel_size, stride,
                                        padding, self.use_actual_stats))
        return features


class InceptionA(_Block):  # mixed 0-2, 35x35
    def __init__(self, in_ch: int, pool_features: int, use_actual_stats: bool):
        super().__init__()
        self.use_actual_stats = use_actual_stats
        self.conv("b1x1", in_ch, 64)
        self.conv("b5x5_1", in_ch, 48)
        self.conv("b5x5_2", 48, 64, (5, 5))
        self.conv("b3x3dbl_1", in_ch, 64)
        self.conv("b3x3dbl_2", 64, 96, (3, 3))
        self.conv("b3x3dbl_3", 96, 96, (3, 3))
        self.conv("bpool", in_ch, pool_features)
        self.out_ch = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b5 = self.b5x5_2(self.b5x5_1(x))
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([self.b1x1(x), b5, b3, self.bpool(_avg_pool_same(x))], 1)


class InceptionB(_Block):  # mixed 3, 35 -> 17
    def __init__(self, in_ch: int, use_actual_stats: bool):
        super().__init__()
        self.use_actual_stats = use_actual_stats
        self.conv("b3x3", in_ch, 384, (3, 3), 2, "VALID")
        self.conv("b3x3dbl_1", in_ch, 64)
        self.conv("b3x3dbl_2", 64, 96, (3, 3))
        self.conv("b3x3dbl_3", 96, 96, (3, 3), 2, "VALID")
        self.out_ch = 384 + 96 + in_ch

    def forward(self, x):
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([self.b3x3(x), bd, _max_pool_valid(x)], 1)


class InceptionC(_Block):  # mixed 4-7, 17x17
    def __init__(self, in_ch: int, c7: int, use_actual_stats: bool):
        super().__init__()
        self.use_actual_stats = use_actual_stats
        self.conv("b1x1", in_ch, 192)
        self.conv("b7x7_1", in_ch, c7)
        self.conv("b7x7_2", c7, c7, (1, 7))
        self.conv("b7x7_3", c7, 192, (7, 1))
        self.conv("b7x7dbl_1", in_ch, c7)
        self.conv("b7x7dbl_2", c7, c7, (7, 1))
        self.conv("b7x7dbl_3", c7, c7, (1, 7))
        self.conv("b7x7dbl_4", c7, c7, (7, 1))
        self.conv("b7x7dbl_5", c7, 192, (1, 7))
        self.conv("bpool", in_ch, 192)
        self.out_ch = 4 * 192

    def forward(self, x):
        b7 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        bd = self.b7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"b7x7dbl_{i}")(bd)
        return torch.cat([self.b1x1(x), b7, bd, self.bpool(_avg_pool_same(x))], 1)


class InceptionD(_Block):  # mixed 8, 17 -> 8
    def __init__(self, in_ch: int, use_actual_stats: bool):
        super().__init__()
        self.use_actual_stats = use_actual_stats
        self.conv("b3x3_1", in_ch, 192)
        self.conv("b3x3_2", 192, 320, (3, 3), 2, "VALID")
        self.conv("b7x7x3_1", in_ch, 192)
        self.conv("b7x7x3_2", 192, 192, (1, 7))
        self.conv("b7x7x3_3", 192, 192, (7, 1))
        self.conv("b7x7x3_4", 192, 192, (3, 3), 2, "VALID")
        self.out_ch = 320 + 192 + in_ch

    def forward(self, x):
        b3 = self.b3x3_2(self.b3x3_1(x))
        b7 = self.b7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"b7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_valid(x)], 1)


class InceptionE(_Block):  # mixed 9-10, 8x8
    def __init__(self, in_ch: int, use_actual_stats: bool):
        super().__init__()
        self.use_actual_stats = use_actual_stats
        self.conv("b1x1", in_ch, 320)
        self.conv("b3x3_1", in_ch, 384)
        self.conv("b3x3_2a", 384, 384, (1, 3))
        self.conv("b3x3_2b", 384, 384, (3, 1))
        self.conv("b3x3dbl_1", in_ch, 448)
        self.conv("b3x3dbl_2", 448, 384, (3, 3))
        self.conv("b3x3dbl_3a", 384, 384, (1, 3))
        self.conv("b3x3dbl_3b", 384, 384, (3, 1))
        self.conv("bpool", in_ch, 192)
        self.out_ch = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3 = self.b3x3_1(x)
        b3 = torch.cat([self.b3x3_2a(b3), self.b3x3_2b(b3)], 1)
        bd = self.b3x3dbl_2(self.b3x3dbl_1(x))
        bd = torch.cat([self.b3x3dbl_3a(bd), self.b3x3dbl_3b(bd)], 1)
        return torch.cat([self.b1x1(x), b3, bd, self.bpool(_avg_pool_same(x))], 1)


class InceptionV3(nn.Module):
    """NCHW ``[N, 3, 299, 299]`` -> (pool3 features ``[N, 2048]``, logits
    ``[N, num_classes]``)."""

    def __init__(self, num_classes: int = 1000, use_actual_stats: bool = False):
        super().__init__()
        s = use_actual_stats
        self.stem1 = BasicConv(3, 32, (3, 3), 2, "VALID", s)
        self.stem2 = BasicConv(32, 32, (3, 3), 1, "VALID", s)
        self.stem3 = BasicConv(32, 64, (3, 3), 1, "SAME", s)
        self.stem4 = BasicConv(64, 80, (1, 1), 1, "VALID", s)
        self.stem5 = BasicConv(80, 192, (3, 3), 1, "VALID", s)
        blocks = [lambda c: InceptionA(c, 32, s), lambda c: InceptionA(c, 64, s),
                  lambda c: InceptionA(c, 64, s), lambda c: InceptionB(c, s),
                  lambda c: InceptionC(c, 128, s), lambda c: InceptionC(c, 160, s),
                  lambda c: InceptionC(c, 160, s), lambda c: InceptionC(c, 192, s),
                  lambda c: InceptionD(c, s), lambda c: InceptionE(c, s),
                  lambda c: InceptionE(c, s)]
        ch = 192
        for i, make in enumerate(blocks):
            block = make(ch)
            self.add_module(f"mixed{i}", block)
            ch = block.out_ch
        self.fc = nn.Linear(ch, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.stem3(self.stem2(self.stem1(x)))
        x = _max_pool_valid(x)
        x = self.stem5(self.stem4(x))
        x = _max_pool_valid(x)
        for i in range(11):
            x = getattr(self, f"mixed{i}")(x)
        feats = x.mean(dim=(2, 3))
        return feats, self.fc(feats)


def _flax_path(name: str) -> str:
    """The reference's npz key of a port tensor name."""
    path = name.replace(".", "/")
    if path.endswith("/weight"):
        path = path[: -len("weight")] + "kernel"
    return path


def _flax_shape(t: torch.Tensor) -> Tuple[int, ...]:
    if t.dim() == 4:                      # OIHW -> HWIO
        return tuple(t.shape[i] for i in (2, 3, 1, 0))
    return tuple(t.shape[::-1])           # [out, in] -> [in, out]; 1-d as is


def _named_tensors(model: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(model.state_dict(keep_vars=True))


def param_paths(model: Optional[InceptionV3] = None) -> List[Tuple[str, Tuple[int, ...]]]:
    """The npz keys and flax-layout shapes ``load_params_npz`` expects, in
    the reference's order (its flax paths, sorted)."""
    if model is None:
        with torch.device("meta"):
            model = InceptionV3()
    out = [(_flax_path(n), _flax_shape(t)) for n, t in _named_tensors(model).items()]
    return sorted(out, key=lambda kv: tuple(kv[0].split("/")))


def load_params_npz(path: str, model: InceptionV3) -> None:
    """Load a flat npz in the reference's layout into ``model`` in place.
    Raises on any missing key or shape mismatch: a partial load would
    quietly corrupt FID."""
    raw = np.load(path)
    state = {}
    for name, t in _named_tensors(model).items():
        key, shape = _flax_path(name), _flax_shape(t)
        if key not in raw.files:
            raise KeyError(f"missing weight {key} in {path}")
        arr = raw[key]
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch {key}: {arr.shape} != {shape}")
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        state[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    model.load_state_dict(state)


def random_init_(model: InceptionV3, seed: int = 0) -> None:
    """Seed-fixed random weights (flax's defaults in distribution: lecun
    normal kernels, zero biases and betas, stored statistics 0 and 1)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            initializers.lecun_normal_(m.weight, m.weight[0].numel(), gen)
    nn.init.zeros_(model.fc.bias)


@contextlib.contextmanager
def _no_tf32():
    """float32 convolutions and matmuls at full precision on the card."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class InceptionV3Features:
    """IS/FID extractor: NHWC images in [-1, 1], at most 299x299 -> (2048-d
    features, 1000 logits), float32 with TF32 off."""

    feature_dim = 2048
    num_classes = 1000

    def __init__(self, params_npz: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        dev = resolve_device(device)
        self.model = InceptionV3(use_actual_stats=params_npz is None)
        if params_npz is None:
            random_init_(self.model, seed)
        else:
            load_params_npz(params_npz, self.model)
        self.model.to(dev).eval()
        self.device = dev

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = images.float().permute(0, 3, 1, 2)
        h, w = x.shape[2:]
        if h > SIZE or w > SIZE:
            raise ValueError(f"InceptionV3Features takes images up to {SIZE}x{SIZE} "
                             f"(the reference antialiases a downscale; not ported), "
                             f"got {h}x{w}")
        with _no_tf32():
            if (h, w) != (SIZE, SIZE):
                x = F.interpolate(x, size=(SIZE, SIZE), mode="bilinear",
                                  align_corners=False)
            return self.model(x)
