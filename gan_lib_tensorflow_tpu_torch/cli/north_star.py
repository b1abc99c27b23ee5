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

Raw InceptionV3 weights (a torchvision ``.pth``/``.pt``, or a keras ``.h5``
when h5py is installed) are converted here, as the reference converts them,
by ``tools/convert_inception_weights.py`` of this package, run in this
process; the result is cached under ``--out-dir``, keyed by the source's
path, mtime and size. Weights that do not convert are listed as missing,
with the converter's reason, and the command returns 2.

Usage:
  python -m gan_lib_tensorflow_tpu_torch.cli.north_star \\
      --data-dir /data/cifar --inception-weights inception_v3.npz
  python -m gan_lib_tensorflow_tpu_torch.cli.north_star --smoke
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Optional

import numpy as np

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


def resolve_inception(path: Optional[str], out_dir: str = ".") -> Optional[str]:
    """The converted npz of ``path``, or None when there is no such file.
    An ``.npz`` is taken as converted; raw weights are converted once into
    ``out_dir`` (the cache is keyed by the source's absolute path, mtime and
    size, so a replaced source is converted again). A source the converter
    refuses raises ``SystemExit`` with its reason."""
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        return path
    st = os.stat(path)
    key = hashlib.sha256(f"{os.path.abspath(path)}:{st.st_mtime_ns}:{st.st_size}"
                         .encode()).hexdigest()[:16]
    converted = os.path.join(out_dir, f"inception_v3_converted.{key}.npz")
    if os.path.exists(converted):
        return converted
    from ..tools import convert_inception_weights

    print(f"converting {path} -> {converted}", flush=True)
    tensors = convert_inception_weights.convert(path)
    os.makedirs(out_dir, exist_ok=True)
    partial = converted + ".partial"  # a cut write must not pass for the cache
    with open(partial, "wb") as f:
        np.savez(f, **tensors)
    os.replace(partial, converted)
    return converted


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", default=None, help="dir containing cifar-10-batches-py")
    p.add_argument("--inception-weights", default=None,
                   help="converted npz, or raw torchvision .pth / keras .h5 "
                        "(converted here)")
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
        missing = []
        if cifar_dir is None:
            missing.append(
                "  * CIFAR-10: put cifar-10-batches-py/ under --data-dir "
                "(https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz)")
        try:
            weights = resolve_inception(w, args.out_dir)
        except (SystemExit, Exception) as e:  # the converter's refusal, reported
            weights = None
            missing.append(f"  * InceptionV3 weights: {w} could not be converted "
                           f"({type(e).__name__}: {e})")
        else:
            if weights is None:
                missing.append(
                    "  * InceptionV3 weights: pass --inception-weights <converted.npz | "
                    "torchvision .pth | keras .h5> (see python -m "
                    "gan_lib_tensorflow_tpu_torch.tools.convert_inception_weights)")
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
