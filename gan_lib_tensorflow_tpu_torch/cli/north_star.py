"""One-command north-star verdict: SNGAN CIFAR-10 FID <= 25 (port of
``gan_lib_tensorflow_tpu/cli/north_star.py``).

In order:
  1. Asset check: real CIFAR-10 (``cifar-10-batches-py``) and InceptionV3
     weights converted to the JAX package's npz layout. Missing assets abort
     with return code 2 and the exact list of what is missing; nothing falls
     back to synthetic data.
  2. Train the reference 100k-step schedule (``cli.train_sngan`` defaults:
     hinge, n_critic 5, Adam(2e-4, 0, 0.9), linear decay), from the CIFAR-10
     store held on the card. Re-running the command resumes from the newest
     checkpoint.
  3. Real moments, computed once and cached in ``real_stats.npz``.
  4. Eval of 50k samples through InceptionV3 and the verdict line
     ``FID=<x> target<=25.0 PASS|FAIL``; the record goes to
     ``north_star_result.json``.

``--smoke`` runs the same wiring on synthetic data with the random-init
extractor; its verdict is ``UNGRADED(smoke)``.

One difference from the reference: the reference converts raw Keras ``.h5``
or torchvision ``.pth`` InceptionV3 weights itself by running
``tools/convert_inception_weights.py``, which imports JAX. This package does
not use JAX, so it accepts only the converted ``.npz``; given raw weights it
lists them as missing, says that the conversion runs where JAX is installed,
and returns 2.

Usage:
  python -m gan_lib_tensorflow_tpu_torch.cli.north_star \\
      --data-dir /data/cifar --inception-weights inception_v3.npz
  python -m gan_lib_tensorflow_tpu_torch.cli.north_star --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

FID_TARGET = 25.0


def find_cifar(data_dir: Optional[str]) -> Optional[str]:
    """The directory that holds ``data_batch_1`` (``data_dir`` itself or its
    ``cifar-10-batches-py``, then ``data`` and ``~/data``), or None. Unlike
    the reference, which returns the parent when it finds
    ``<c>/cifar-10-batches-py``, this always returns the directory of the
    pickles, which is what ``--data`` needs."""
    candidates = []
    if data_dir:
        candidates += [data_dir, os.path.join(data_dir, "cifar-10-batches-py")]
    candidates += ["data", "data/cifar-10-batches-py",
                   os.path.expanduser("~/data"),
                   os.path.expanduser("~/data/cifar-10-batches-py")]
    for c in candidates:
        if os.path.isfile(os.path.join(c, "data_batch_1")):
            return os.path.dirname(os.path.abspath(os.path.join(c, "data_batch_1")))
        if os.path.isfile(os.path.join(c, "cifar-10-batches-py", "data_batch_1")):
            return os.path.abspath(os.path.join(c, "cifar-10-batches-py"))
    return None


def resolve_inception(path: Optional[str]) -> Optional[str]:
    """The converted npz at ``path``, or None when there is none. Raw
    weights are not converted here (see the module docstring)."""
    if not path or not os.path.exists(path) or not path.endswith(".npz"):
        return None
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", default=None, help="dir containing cifar-10-batches-py")
    p.add_argument("--inception-weights", default=None,
                   help="InceptionV3 weights converted to the JAX package's npz layout")
    p.add_argument("--out-dir", default="runs/north_star")
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--n-samples", type=int, default=50_000)
    p.add_argument("--n-real", type=int, default=50_000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="synthetic end-to-end wiring check (UNGRADED verdict)")
    p.add_argument("--skip-train", action="store_true",
                   help="evaluate the existing checkpoint only")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA only 'cpu' runs")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    # ---- 1. assets
    if args.smoke:
        data_arg, weights, graded = "fake", None, False
        steps = min(args.steps, 60)
        n_samples = min(args.n_samples, 500)
        n_real = min(args.n_real, 500)
        print("SMOKE MODE: synthetic data + random-init extractor; the verdict "
              "below is UNGRADED wiring evidence only", flush=True)
    else:
        w = args.inception_weights
        cifar_dir = find_cifar(args.data_dir)
        weights = resolve_inception(w)
        missing = []
        if cifar_dir is None:
            missing.append(
                "  * CIFAR-10: put cifar-10-batches-py/ under --data-dir "
                "(https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz)")
        if weights is None and w and os.path.exists(w):
            missing.append(
                f"  * InceptionV3 weights: {w} is not a converted .npz; the "
                f"conversion imports JAX, so run it where JAX is installed "
                f"(python tools/convert_inception_weights.py {w} "
                f"inception_v3.npz) and pass the .npz")
        elif weights is None:
            missing.append(
                "  * InceptionV3 weights: pass --inception-weights <converted.npz> "
                "(see tools/convert_inception_weights.py)")
        if missing:
            print("north-star assets missing:\n" + "\n".join(missing))
            print("nothing trained; the verdict requires real assets "
                  "(BASELINE.json:5). Use --smoke for a wiring check.")
            return 2
        data_arg, graded = cifar_dir, True
        steps, n_samples, n_real = args.steps, args.n_samples, args.n_real

    # ---- 2. train (resumable)
    from . import evaluate, train_sngan
    ckpt_dir = os.path.join(args.out_dir, "ckpt")
    if args.skip_train and not os.path.isdir(ckpt_dir):
        print(f"--skip-train: no checkpoint at {ckpt_dir}. Train first:\n"
              f"  python -m gan_lib_tensorflow_tpu_torch.cli.north_star"
              + (" --smoke" if args.smoke else
                 f" --data-dir {args.data_dir or '<dir>'}"
                 f" --inception-weights {args.inception_weights or '<weights>'}")
              + f" --out-dir {args.out_dir}")
        return 2
    if not args.skip_train:
        # smoke: one checkpoint and grid at the end; graded: 20 in the run
        cadence = steps if args.smoke else max(steps // 20, 1)
        train_sngan.main([
            "--steps", str(steps), "--batch-size", str(args.batch_size),
            "--data", data_arg, "--out-dir", args.out_dir,
            "--seed", str(args.seed), "--device", args.device,
            "--ckpt-every", str(cadence), "--sample-every", str(cadence)])

    # ---- 3+4. cached real moments + eval
    out_json = os.path.join(args.out_dir, "north_star_result.json")
    eval_args = ["--model", "sngan", "--ckpt-dir", ckpt_dir,
                 "--n-samples", str(n_samples), "--n-real", str(n_real),
                 "--batch-size", "100", "--data", data_arg,
                 "--real-stats-npz", os.path.join(args.out_dir, "real_stats.npz"),
                 "--seed", str(args.seed), "--out-json", out_json,
                 "--device", args.device]
    if weights:
        eval_args += ["--inception-weights", weights]
    evaluate.main(eval_args)

    with open(out_json) as f:
        rec = json.load(f)
    fid = rec.get("fid")
    verdict = (("PASS" if fid is not None and fid <= FID_TARGET else "FAIL")
               if graded else "UNGRADED(smoke)")
    print(f"FID={fid:.3f} target<={FID_TARGET} {verdict} "
          f"(IS={rec.get('inception_score', float('nan')):.3f}, "
          f"step={rec.get('step')}, extractor={rec.get('extractor')})", flush=True)
    rec.update({"target": FID_TARGET, "verdict": verdict, "graded": graded})
    with open(out_json, "w") as f:
        json.dump(rec, f)
    return 0 if verdict != "FAIL" else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
