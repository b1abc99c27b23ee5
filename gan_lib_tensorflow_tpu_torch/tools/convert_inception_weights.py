"""Convert pretrained InceptionV3 weights into the npz that
``eval/inception_v3.py:load_params_npz`` reads (port of
``tools/convert_inception_weights.py``; the same routes, checks and output).

Sources:
1. ``.npz`` (or ``.h5``, when h5py is installed) with keras names
   (``conv2d_42/kernel``, ``batch_normalization_42/{beta,moving_mean,
   moving_variance}``, ``predictions/{kernel,bias}``; a trailing ``:0`` is
   fine). Keras numbers its layers in creation order, the order in which the
   modules of ``InceptionV3`` are created (``param_paths(sort=False)``), so
   the numbered layers zip one to one onto the target paths.
2. ``.npz`` already in the target layout (``mixed3/b3x3dbl_1/conv/kernel``):
   checked and passed through.
3. A torchvision ``Inception3`` state dict (``.pt``/``.pth``): its convs and
   BNs in state-dict order (``AuxLogits`` skipped), OIHW kernels transposed
   to HWIO, and BN's gamma, which this BN lacks, folded into the variance:
   ``gamma (x - mu) / sqrt(v + eps) = (x - mu) / sqrt(v' + eps)`` with
   ``v' = (v + eps) / gamma^2 - eps`` (gamma must be > 0).

Every target tensor must come out, at its shape: a missing tensor or a shape
mismatch ends the tool (``SystemExit``) and nothing is written.
``torchvision_state_dict`` makes a random state dict in torchvision's
layout, to check the torch route without downloaded weights.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.convert_inception_weights SRC OUT.npz \\
           [--verify [--device cuda|cpu]]
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..eval.inception_v3 import InceptionV3Features, param_paths

BN_EPS = 1e-3  # keras/torchvision InceptionV3 BN epsilon, = eval.inception_v3's

Path = Tuple[str, ...]


def creation_order_paths() -> List[Tuple[Path, Tuple[int, ...]]]:
    """``[(path, shape)]`` of the target tensors in module-creation order."""
    return [(tuple(key.split("/")), shape) for key, shape in param_paths(sort=False)]


def _partition_targets(paths):
    """Split creation-ordered paths into conv kernels, BN units, fc."""
    convs, bns, fc = [], {}, {}
    for path, shape in paths:
        name = path[-1]
        if name == "kernel" and path[-2] == "conv":
            convs.append((path, shape))
        elif path[:1] == ("fc",):
            fc[name] = (path, shape)
        elif name in ("beta", "moving_mean", "moving_variance"):
            # one BasicConv = one BN unit, keyed by its module prefix
            bns.setdefault(path[:-1], {})[name] = (path, shape)
        else:
            raise AssertionError(f"unexpected target tensor {path}")
    return convs, list(bns.values()), fc


_KERAS_CONV = re.compile(r"(?:^|/)conv2d(?:_(\d+))?/kernel(?::0)?$")
_KERAS_BN = re.compile(r"(?:^|/)batch_normalization(?:_(\d+))?/"
                       r"(beta|moving_mean|moving_variance)(?::0)?$")
_KERAS_FC = re.compile(r"(?:^|/)(?:predictions|dense)(?:_\d+)?/(kernel|bias)(?::0)?$")


def _read_source(path: str):
    """SRC as a flat ``{name: array}`` and its format (None: sniff it)."""
    if path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        return {k: v.numpy() for k, v in sd.items()}, "torch"
    if path.endswith(".h5"):
        try:
            import h5py
        except ImportError as e:
            raise SystemExit(f"reading {path} needs h5py (absent): {e}")
        flat = {}
        with h5py.File(path, "r") as f:
            root = f["model_weights"] if "model_weights" in f else f

            def visit(name, obj):
                if hasattr(obj, "shape") and obj.shape is not None:
                    flat[name] = np.asarray(obj)
            root.visititems(visit)
        return flat, "keras"
    if path.endswith(".npz"):
        with np.load(path) as d:
            return dict(d), None
    raise SystemExit(f"unsupported source format: {path}")


def _from_keras(flat, convs, bns, fc_t):
    """Zip keras-numbered tensors onto the creation-ordered targets."""
    def indexed(regex, two_groups=False):
        hits = {}
        for name, arr in flat.items():
            m = regex.search(name)
            if m:
                idx = int(m.group(1) or 0)
                key = (idx, m.group(2)) if two_groups else idx
                if key in hits:
                    raise SystemExit(f"duplicate source tensor for {key}: {name}")
                hits[key] = arr
        return hits

    src_convs, src_bns = indexed(_KERAS_CONV), indexed(_KERAS_BN, two_groups=True)
    if len(src_convs) != len(convs):
        raise SystemExit(f"source has {len(src_convs)} conv kernels, target needs {len(convs)}")
    out = {}
    for i, (path, _) in enumerate(convs):
        if i not in src_convs:
            raise SystemExit(f"missing conv2d_{i}/kernel in source")
        out["/".join(path)] = src_convs[i]
    for i, unit in enumerate(bns):
        for stat, (path, _) in unit.items():
            if (i, stat) not in src_bns:
                raise SystemExit(f"missing batch_normalization_{i}/{stat}")
            out["/".join(path)] = src_bns[(i, stat)]
    for name, arr in flat.items():
        m = _KERAS_FC.search(name)
        if m and m.group(1) in fc_t:
            out["/".join(fc_t[m.group(1)][0])] = arr
    return out


def _from_torch(flat, convs, bns, fc_t):
    """torchvision ``Inception3``: its Conv2d/BN modules come in the same
    order; transpose the kernels, fold gamma."""
    conv_w = [(k, v) for k, v in flat.items()
              if k.endswith(".conv.weight") and not k.startswith("AuxLogits")]
    bn_units: Dict[str, dict] = {}
    for k, v in flat.items():
        if k.startswith("AuxLogits"):
            continue
        m = re.match(r"(.*)\.bn\.(weight|bias|running_mean|running_var)$", k)
        if m:
            bn_units.setdefault(m.group(1), {})[m.group(2)] = v
    if len(conv_w) != len(convs) or len(bn_units) != len(bns):
        raise SystemExit(f"torch source has {len(conv_w)} convs / {len(bn_units)} BNs, "
                         f"target needs {len(convs)} / {len(bns)}")
    conv_index = {k: i for i, (k, _) in enumerate(conv_w)}

    def conv_order(item):
        key = item[0] + ".conv.weight"
        if key not in conv_index:
            raise SystemExit(f"BN unit {item[0]} has no sibling conv")
        return conv_index[key]

    out = {}
    for (path, _), (_, w) in zip(convs, conv_w):
        out["/".join(path)] = np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO
    for unit_t, (prefix, unit_s) in zip(bns, sorted(bn_units.items(), key=conv_order)):
        missing = {"weight", "bias", "running_mean", "running_var"} - set(unit_s)
        if missing:
            raise SystemExit(f"missing {sorted(f'{prefix}.bn.{m}' for m in missing)} in source")
        gamma = unit_s["weight"].astype(np.float64)
        if np.any(gamma <= 0):
            raise SystemExit(f"{prefix}: {np.sum(gamma <= 0)} BN gammas <= 0 cannot fold "
                             "into a BN without gamma; use a keras-format source")
        v_fold = (unit_s["running_var"].astype(np.float64) + BN_EPS) / gamma ** 2 - BN_EPS
        out["/".join(unit_t["beta"][0])] = unit_s["bias"]
        out["/".join(unit_t["moving_mean"][0])] = unit_s["running_mean"]
        out["/".join(unit_t["moving_variance"][0])] = v_fold.astype(np.float32)
    if "fc.weight" in flat:
        out["/".join(fc_t["kernel"][0])] = flat["fc.weight"].T
        out["/".join(fc_t["bias"][0])] = flat["fc.bias"]
    return out


def convert(src_path: str) -> Dict[str, np.ndarray]:
    """SRC -> ``{npz key: float32 array}``; ``SystemExit`` on a missing
    tensor or a shape mismatch."""
    flat, fmt = _read_source(src_path)
    paths = creation_order_paths()
    convs, bns, fc_t = _partition_targets(paths)
    if fmt is None:  # an npz: sniff its naming
        if any(_KERAS_CONV.search(k) for k in flat):
            fmt = "keras"
        elif all("/".join(p) in flat for p, _ in paths):
            fmt = "flax"
        elif any(k.endswith(".conv.weight") for k in flat):
            fmt = "torch"
        else:
            raise SystemExit("npz keys match neither keras names, torch names, nor the "
                             "target layout: nothing to zip")
    if fmt == "keras":
        out = _from_keras(flat, convs, bns, fc_t)
    elif fmt == "torch":
        out = _from_torch(flat, convs, bns, fc_t)
    else:
        out = {"/".join(p): flat["/".join(p)] for p, _ in paths}
    for path, shape in paths:  # no partial load: every tensor, at its shape
        key = "/".join(path)
        if key not in out:
            raise SystemExit(f"converted output missing {key}")
        got = tuple(out[key].shape)
        if got != shape:
            raise SystemExit(f"shape mismatch {key}: source {got} != target {shape}")
        out[key] = np.asarray(out[key], np.float32)
    return out


# torchvision's module names for the target's: stem1 -> Conv2d_1a_3x3, ...,
# mixed0 -> Mixed_5b, ...; its branches are b* -> branch*, bpool -> branch_pool
_TV_STEMS = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
             "Conv2d_4a_3x3")
_TV_MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
             "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")


def _tv_module(prefix: Path) -> str:
    if prefix[0].startswith("stem"):
        return _TV_STEMS[int(prefix[0][4:]) - 1]
    branch = "branch_pool" if prefix[1] == "bpool" else "branch" + prefix[1][1:]
    return f"{_TV_MIXED[int(prefix[0][5:])]}.{branch}"


def torchvision_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A random state dict in torchvision's ``Inception3`` layout: its key
    names and order (``AuxLogits`` after ``Mixed_6e``), OIHW kernels, BN
    gamma > 0 and variance > 0, ``num_batches_tracked``, fc ``[1000, 2048]``."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    convs, bns, fc = _partition_targets(creation_order_paths())
    aux = {"AuxLogits.conv0": (128, 768, 1, 1), "AuxLogits.conv1": (768, 128, 5, 5)}
    sd: Dict[str, torch.Tensor] = {}

    def basic(name: str, oihw) -> None:  # scaled so that activations stay O(1)
        o = oihw[0]
        fan_in = int(np.prod(oihw[1:]))
        sd[f"{name}.conv.weight"] = t(rng.standard_normal(oihw) / np.sqrt(fan_in))
        sd[f"{name}.bn.weight"] = t(0.5 * np.abs(rng.standard_normal(o)) + 0.75)
        sd[f"{name}.bn.bias"] = t(rng.standard_normal(o) * 0.1)
        sd[f"{name}.bn.running_mean"] = t(rng.standard_normal(o) * 0.1)
        sd[f"{name}.bn.running_var"] = t(np.abs(rng.standard_normal(o)) + 0.5)
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)

    for path, (h, w, i, o) in convs:
        name = _tv_module(path[:-2])
        basic(name, (o, i, h, w))
        if name.startswith("Mixed_6e.branch_pool"):
            for aux_name, oihw in aux.items():
                basic(aux_name, oihw)
            sd["AuxLogits.fc.weight"] = t(rng.standard_normal((1000, 768)) * 0.01)
            sd["AuxLogits.fc.bias"] = t(np.zeros(1000))
    fc_in, fc_out = fc["kernel"][1]
    sd["fc.weight"] = t(rng.standard_normal((fc_out, fc_in)) * 0.01)
    sd["fc.bias"] = t(rng.standard_normal(fc_out) * 0.01)
    return sd


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="keras .npz/.h5, target-layout .npz, or torchvision .pt[h]")
    p.add_argument("out", help="output npz")
    p.add_argument("--verify", action="store_true",
                   help="load the result into InceptionV3Features and run one batch")
    p.add_argument("--device", default="cuda", help="where --verify runs the batch")
    args = p.parse_args(argv)

    out = convert(args.src)
    np.savez(args.out, **out)
    print(f"wrote {len(out)} tensors -> {args.out}", flush=True)
    if args.verify:
        net = InceptionV3Features(params_npz=args.out, device=args.device)
        feats, logits = net(torch.zeros(2, 64, 64, 3, device=net.device))
        if tuple(feats.shape) != (2, 2048) or tuple(logits.shape) != (2, 1000):
            raise SystemExit(f"verify failed: feats {tuple(feats.shape)}, "
                             f"logits {tuple(logits.shape)}")
        print(f"verify ok: feats {tuple(feats.shape)}, logits {tuple(logits.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
