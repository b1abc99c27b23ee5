"""Import a reference TF1 ``tf.train.Saver`` checkpoint into the port
(port of ``tools/import_tf1_checkpoint.py``), without TensorFlow.

A user migrating from ``GAN_Lib_Tensorflow`` keeps a trained model: the
checkpoint (a V2 bundle or V1 table files, every dtype TensorFlow returns)
is read by ``tools/tf1_bundle.py`` (a hand-written reader, CRC32C
checked), the variables are mapped onto the target model by the
reference's matcher, and a step-0 checkpoint in the port's format is
written under ``OUT/ckpt`` (``train/checkpoint.py``).

Mapping contract (the reference's, unchanged):

1. optimizer/bookkeeping slots are dropped (``Adam``, ``beta*_power``,
   ``global_step``, EMA shadow copies, ...) before any tensor is decoded;
2. variables partition into generator vs discriminator by name substring
   (``--g-prefix``/``--d-prefix``; default: auto-detect ``gen``/``dis``);
3. each variable gets a *role* from its trailing name component
   (W/weights/kernel/filter -> kernel, b/bias -> bias, gamma/scale -> scale,
   beta/offset -> BN bias, moving_mean -> mean, moving_variance -> var,
   u -> spectral-norm u, embed -> embedding), and the target's leaves get
   roles from the reference's flax names (``convert.flax_view``: a ``bias``
   whose module also holds ``scale`` is a BN beta);
4. within each (network, role, shape) group, TF variables in natural name
   order align with the target's leaves in natural flax-path order;
5. anything still ambiguous or unmatched must be pinned via ``--map``
   (JSON ``{tf_var_name: "flax/leaf/path"}``, the reference's paths); the
   tool writes ``import_report.json`` (byte-equal to the reference tool's)
   and **fails loudly** on unmatched target leaves unless
   ``--allow-partial``.

Layouts: TF conv kernels are HWIO and dense kernels ``[in, out]``, as the
reference's flax leaves; ``convert.load_flax_view`` turns them into the
port's layouts. ``--nchw-boundary`` re-orders the G input dense's output
columns (kernel and bias) from (C,H,W) to (H,W,C) flattening, in the flax
view, as the reference does.

The checkpoint: Adam(2e-4, 0, 0.9) with zero slots for both networks, no
lr schedule, EMA 0.9999 seeded with the imported G, step 0. ``cli.sample``
and ``cli.evaluate`` take it up. The train CLIs do not, as the
reference's do not take up its tool's checkpoint: ``train_sngan`` and
``train_sngan_imagenet`` hold an lr schedule the checkpoint lacks,
``train_acgan`` and ``train_pix2pix`` no EMA, and ``train_pggan`` reads
per-phase directories (each refuses or ignores it as the reference's
does).

Under ``--allow-partial`` an unmatched leaf takes the reference tool's
init: G's ``g_init(PRNGKey(0))`` and D's ``d_init(PRNGKey(1))`` draw
(``:368-369``), computed without JAX by ``tools/flax_init.py``; its uniform
draws are bit-equal to JAX's, its normal and truncated-normal ones within 3
ulp (``log1p``). Only this tool uses that init; the port's models and
CLIs keep their own torch init (``ops/initializers.py``).

Example:
  python -m gan_lib_tensorflow_tpu_torch.tools.import_tf1_checkpoint --model sngan \\
      --ckpt /path/to/tf1/model.ckpt-100000 --out-dir runs/imported \\
      --report-only          # first look at the proposed mapping
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..convert import flax_view, load_flax_view
from ..models import acgan, pggan, pix2pix, sngan
from ..train import CheckpointManager, create_state
from .flax_init import reference_init
from .tf1_bundle import read_tf_checkpoint

_ROLE_PATTERNS = [
    (re.compile(r"(^|[./])(moving_mean|mean|mu)$", re.I), "mean"),
    (re.compile(r"(^|[./])(moving_variance|variance|var|sigma2)$", re.I), "var"),
    (re.compile(r"(^|[./])(gamma|scale|g)$"), "scale"),
    (re.compile(r"(^|[./])(beta|offset)$", re.I), "bn_bias"),
    (re.compile(r"(^|[./])(W|w|kernel|weights?|filters?)$"), "kernel"),
    (re.compile(r"(^|[./])(b|bias|biases)$"), "bias"),
    (re.compile(r"(^|[./])u$"), "u"),
    (re.compile(r"embed", re.I), "embedding"),
]

EMA_DECAY = 0.9999


def _natkey(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def tf_role(name: str) -> str:
    base = name.split(":")[0]
    for pat, role in _ROLE_PATTERNS:
        if pat.search(base):
            return role
    return "kernel" if name.count("/") else "unknown"


def partition_networks(tf_vars, g_prefix, d_prefix):
    g, d, skipped = {}, {}, []
    for name, val in tf_vars.items():
        low = name.lower()
        if g_prefix and g_prefix.lower() in low:
            g[name] = val
        elif d_prefix and d_prefix.lower() in low:
            d[name] = val
        elif "gen" in low:
            g[name] = val
        elif "dis" in low or re.search(r"(^|/)d([_./]|$)", low):
            d[name] = val
        else:
            skipped.append(name)
    return g, d, skipped


def match(tf_vars: Dict[str, np.ndarray], leaves, explicit: Dict[str, str],
          net: str):
    """Greedy (role, shape)-group alignment. Returns (assignments, report)."""
    assignments: Dict[Tuple[str, ...], np.ndarray] = {}
    report = {"network": net, "matched": [], "unmatched_tf": [],
              "unmatched_target": []}
    by_path = {p: (keys, v, role) for p, keys, v, role in leaves}
    used_tf, used_leaf = set(), set()

    for tf_name, leaf_path in explicit.items():
        if tf_name not in tf_vars:
            continue
        if leaf_path not in by_path:
            raise SystemExit(f"--map: no target leaf {leaf_path!r} in {net}")
        keys, target, _ = by_path[leaf_path]
        val = tf_vars[tf_name]
        if tuple(val.shape) != tuple(target.shape):
            raise SystemExit(
                f"--map: {tf_name} {val.shape} vs {leaf_path} {target.shape}")
        assignments[keys] = val
        used_tf.add(tf_name)
        used_leaf.add(leaf_path)
        report["matched"].append(
            {"tf": tf_name, "target": leaf_path, "how": "explicit"})

    groups: Dict[Tuple[str, tuple], List[str]] = {}
    for name, val in tf_vars.items():
        if name not in used_tf:
            groups.setdefault((tf_role(name), tuple(val.shape)), []).append(name)
    for key in groups:
        groups[key].sort(key=_natkey)

    leaf_groups: Dict[Tuple[str, tuple], List[str]] = {}
    for p, keys, v, role in leaves:
        if p not in used_leaf:
            leaf_groups.setdefault((role, tuple(v.shape)), []).append(p)
    for key in leaf_groups:
        leaf_groups[key].sort(key=_natkey)

    for key, names in sorted(groups.items(), key=lambda kv: str(kv[0])):
        targets = leaf_groups.get(key, [])
        for tf_name, leaf_path in zip(names, targets):
            keys, _, _ = by_path[leaf_path]
            assignments[keys] = tf_vars[tf_name]
            report["matched"].append(
                {"tf": tf_name, "target": leaf_path,
                 "how": "role+shape+order" if len(names) > 1 else "role+shape"})
        for tf_name in names[len(targets):]:
            report["unmatched_tf"].append(tf_name)
        leaf_groups[key] = targets[len(names):]
    for rest in leaf_groups.values():
        report["unmatched_target"].extend(rest)
    report["unmatched_target"].sort()
    report["unmatched_tf"].sort()
    return assignments, report


def unmatched_init(module: torch.nn.Module, assignments, seed: int, equalized: bool
                   ) -> Dict[Tuple[str, ...], np.ndarray]:
    """The reference tool's init (``PRNGKey(seed)``) of every flax leaf of
    ``module`` that ``assignments`` leaves out."""
    view = flax_view(module)
    shapes = {keys: arr.shape for _, keys, arr, _ in view}
    return reference_init(list(shapes), shapes, seed, equalized,
                          only=[k for k in shapes if k not in assignments])


def nchw_boundary_fixups(g_vars: Dict[Tuple[str, ...], np.ndarray], model: str
                         ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Permute the G input dense's output columns (kernel and bias) from
    NCHW to NHWC flattening order, over ``{flax keys: array}`` (the
    reference's rule, ``:219-252``: every ``kernel``/``bias`` under a path
    holding ``dense`` whose last dim is a multiple of 4x4)."""
    if model not in ("sngan", "acgan", "imagenet"):
        return g_vars
    h = w = 4
    out = {}
    for keys, arr in g_vars.items():
        dim = arr.shape[-1] if keys[-1] in ("kernel", "bias") else 0
        if (keys[-1] in ("kernel", "bias") and not dim % (h * w) and dim // (h * w) >= 1
                and "dense" in "/".join(keys).lower()):
            perm = np.arange(dim).reshape(dim // (h * w), h, w).transpose(1, 2, 0).ravel()
            arr = arr[..., perm]
        out[keys] = arr
    return out


def build_models(args):
    """The port's G and D of ``--model`` with the reference tool's
    arguments (``:255-308``; PGGAN without the fade-in)."""
    if args.model == "sngan":
        return (sngan.cifar_generator(num_classes=args.num_classes),
                sngan.cifar_discriminator(num_classes=args.num_classes))
    if args.model == "acgan":
        return acgan.ACGANGenerator(), acgan.ACGANDiscriminator()
    if args.model == "imagenet":
        nc = args.num_classes or 1000
        return (sngan.imagenet128_generator(num_classes=nc, width_mul=args.width_mul),
                sngan.imagenet128_discriminator(num_classes=nc, width_mul=args.width_mul))
    if args.model == "pix2pix":
        return (pix2pix.UNetGenerator(image_size=args.image_size, base_ch=args.ngf),
                pix2pix.PatchGANDiscriminator(base_ch=args.ndf))
    if args.model == "pggan":
        return (pggan.PGGANGenerator(resolution=args.resolution, fade_in=False,
                                     width_mul=args.width_mul),
                pggan.PGGANDiscriminator(resolution=args.resolution, fade_in=False,
                                         width_mul=args.width_mul))
    raise SystemExit(f"unknown --model {args.model!r}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="TF1 checkpoint prefix (the path Saver.save returned)")
    p.add_argument("--model", required=True,
                   choices=["sngan", "acgan", "pix2pix", "imagenet", "pggan"])
    p.add_argument("--out-dir", default="runs/imported")
    p.add_argument("--g-prefix", default=None,
                   help="substring marking generator variables")
    p.add_argument("--d-prefix", default=None)
    p.add_argument("--map", dest="map_json", default=None,
                   help="JSON file {tf_var_name: flax/leaf/path} overrides")
    p.add_argument("--num-classes", type=int, default=0)
    p.add_argument("--width-mul", type=float, default=1.0)
    p.add_argument("--resolution", type=int, default=64, help="pggan only")
    p.add_argument("--image-size", type=int, default=256, help="pix2pix only")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--nchw-boundary", action="store_true",
                   help="apply NCHW->NHWC dense-boundary permutation "
                        "(igul222-lineage checkpoints)")
    p.add_argument("--allow-partial", action="store_true",
                   help="give unmatched target leaves a fresh init: the reference "
                        "tool's (G from PRNGKey(0), D from PRNGKey(1))")
    p.add_argument("--report-only", action="store_true",
                   help="write the mapping report and exit without importing")
    p.add_argument("--device", default="cuda",
                   help="torch device the state is built on; without CUDA only 'cpu' runs")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    t0 = time.perf_counter()
    tf_vars = read_tf_checkpoint(args.ckpt)
    read_s = time.perf_counter() - t0
    n_bytes = sum(v.nbytes for v in tf_vars.values())
    print(f"read {len(tf_vars)} variables, {n_bytes} bytes, in {read_s:.3f} s "
          f"({n_bytes / max(read_s, 1e-9) / 1e6:.1f} MB/s)", flush=True)
    g_tf, d_tf, skipped = partition_networks(tf_vars, args.g_prefix,
                                             args.d_prefix)
    if not g_tf or not d_tf:
        raise SystemExit(
            f"could not partition checkpoint into G ({len(g_tf)} vars) / "
            f"D ({len(d_tf)} vars); pass --g-prefix/--d-prefix. "
            f"Variables seen: {sorted(tf_vars)[:20]} ...")

    explicit = {}
    if args.map_json:
        with open(args.map_json) as f:
            explicit = json.load(f)
        # every pin against the UNION of G/D variables up front: a typo'd TF
        # name would otherwise be skipped by both per-network passes and fall
        # back to the heuristic alignment the pin was meant to override
        unknown = sorted(set(explicit) - set(g_tf) - set(d_tf))
        if unknown:
            raise SystemExit(
                f"--map: TF variable(s) not in the checkpoint: {unknown}; "
                f"available: {sorted(set(g_tf) | set(d_tf))[:20]} ...")

    g, d = build_models(args)
    g_assign, g_report = match(g_tf, flax_view(g), explicit, "G")
    d_assign, d_report = match(d_tf, flax_view(d), explicit, "D")

    os.makedirs(args.out_dir, exist_ok=True)
    report = {"checkpoint": args.ckpt, "model": args.model,
              "skipped_unpartitioned": sorted(skipped),
              "generator": g_report, "discriminator": d_report}
    report_path = os.path.join(args.out_dir, "import_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    n_match = len(g_report["matched"]) + len(d_report["matched"])
    n_miss = len(g_report["unmatched_target"]) + len(d_report["unmatched_target"])
    print(f"matched {n_match} variables; {n_miss} target leaves unmatched; "
          f"report: {report_path}", flush=True)

    if args.report_only:
        return 0
    if n_miss and not args.allow_partial:
        raise SystemExit(
            f"{n_miss} target leaves have no source variable (see "
            f"{report_path}); pin them with --map or pass --allow-partial "
            f"to keep their fresh initialization")

    # each matched value cast to its leaf's float32 as the reference casts it
    # (``astype``: a complex value loses its imaginary part with numpy's
    # warning, a string that is no number raises numpy's ValueError); every
    # other leaf takes the reference's init of its network
    state = create_state(g, d, lr=2e-4, beta1=0.0, beta2=0.9, ema_decay=EMA_DECAY,
                         seed=0, device=args.device)
    g_vars = unmatched_init(state.g, g_assign, seed=0, equalized=args.model == "pggan")
    d_vars = unmatched_init(state.d, d_assign, seed=1, equalized=args.model == "pggan")
    g_vars.update({k: v.astype(np.float32) for k, v in g_assign.items()})
    d_vars.update({k: v.astype(np.float32) for k, v in d_assign.items()})
    if args.nchw_boundary:
        g_vars = nchw_boundary_fixups(g_vars, args.model)
    load_flax_view(state.g, g_vars)
    load_flax_view(state.d, d_vars)
    # imported weights ARE the trained model: seed EMA with them; Adam's
    # slots start at zero, as optax's init
    state.ema_params = {n: p.detach().clone() for n, p in state.g.named_parameters()}
    for opt, net in ((state.g_opt, state.g), (state.d_opt, state.d)):
        for p in net.parameters():
            opt.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
    ckpt = CheckpointManager(os.path.join(args.out_dir, "ckpt"))
    ckpt.save(0, state, wait=True)
    ckpt.close()
    print(f"wrote step-0 checkpoint to {os.path.join(args.out_dir, 'ckpt')} in "
          f"{time.perf_counter() - t0:.3f} s; consume with cli.sample / cli.evaluate "
          f"(--ckpt-dir {os.path.join(args.out_dir, 'ckpt')})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
