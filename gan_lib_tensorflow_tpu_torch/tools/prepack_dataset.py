"""Prepack ``.npz`` image data into a uint8 memmap store (port of the npz
route of ``tools/prepack_dataset.py``; the store layout is
``data/packed.py``'s).

Input: an ``.npz`` file, or a directory of them, each with ``data`` (NHWC
uint8, or rows of ``3 * size * size`` CHW bytes as the downsampled-ImageNet
files hold them) and ``labels`` (or ``label``); streamed file by file, never
concatenated in memory, into a labelled store. Labels that start at 1 across
all files are shifted to start at 0. With ``--resolutions`` the output is a
PGGAN pyramid store (members ``r{res:04d}/``): each chunk of the top level
is box-downsampled by 2 in float32 level after level (``data/multires.py``)
and rounded to uint8, byte-equal to the reference's writer.

Image folders (the reference decodes them with Pillow) and ``--paired``
(combined A|B images, Pillow as well) are refused with exit code 2: this
package does not use Pillow.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.prepack_dataset --src train_64x64 \\
           --out /data/packed64 --size 64
       python -m gan_lib_tensorflow_tpu_torch.tools.prepack_dataset --src faces.npz \\
           --out /data/pg --size 256 --resolutions 256,128,64,32,16,8,4
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from ..data import packed
from ..data.multires import box_downsample

PILLOW = ("the reference decodes images with Pillow, which this package does not "
          "use: pack them where the JAX package runs (tools/prepack_dataset.py), or "
          "convert them to .npz files with 'data' and 'labels' first")


def npz_inputs(src: str):
    """The ``.npz`` files of ``src`` (a file, or a directory of them), or
    None when ``src`` holds none."""
    if os.path.isfile(src) and src.endswith(".npz"):
        return [src]
    if os.path.isdir(src):
        return sorted(glob.glob(os.path.join(src, "*.npz"))) or None
    return None


def _labels(d) -> np.ndarray:
    return np.asarray(d["labels"] if "labels" in d else d["label"])


def pyramid_write(stores, labels_arrs, pos: int, chunk_u8: np.ndarray,
                  labels_chunk, resolutions) -> None:
    """Write a top-resolution uint8 chunk into every pyramid level (the
    reference's ``_pyramid_write``)."""
    cur, cur_res, f32 = chunk_u8, resolutions[0], None
    for res, store, labels in zip(resolutions, stores, labels_arrs):
        if res != cur_res:
            if f32 is None:
                f32 = cur.astype(np.float32)
            while cur_res > res:
                f32 = box_downsample(f32, 2)
                cur_res //= 2
            cur = np.clip(np.rint(f32), 0, 255).astype(np.uint8)
        store[pos:pos + len(cur)] = cur
        if labels is not None and labels_chunk is not None:
            labels[pos:pos + len(cur)] = labels_chunk


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, required=True, help="target (top) resolution")
    p.add_argument("--resolutions", default=None,
                   help="comma list (descending, each a power-of-2 divisor chain) -> "
                        "pyramid store with r{res:04d}/ members")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--limit", type=int, default=0, help="cap image count (testing)")
    p.add_argument("--paired", action="store_true",
                   help="combined A|B images (pix2pix): refused, see --help")
    args = p.parse_args(argv)
    if args.paired:
        p.error(f"--paired: {PILLOW}")
    files = npz_inputs(args.src)
    if files is None:
        if not os.path.exists(args.src):
            raise FileNotFoundError(f"--src {args.src!r}: no such file or directory")
        p.error(f"--src {args.src}: no .npz files; {PILLOW}")

    resolutions = ([int(r) for r in args.resolutions.split(",")]
                   if args.resolutions else [args.size])
    if resolutions[0] != args.size or resolutions != sorted(resolutions, reverse=True):
        raise ValueError("--resolutions must start at --size and descend")

    n = 0
    label_min = None
    for f in files:
        with np.load(f) as d:
            n += d["data"].shape[0]
            m = int(_labels(d).min())
            label_min = m if label_min is None else min(label_min, m)
    if args.limit:
        n = min(n, args.limit)
    # 1-indexed labels are decided once over every file: a 0-indexed file
    # without class 0 must not be shifted alone
    shift = 1 if label_min == 1 else 0
    if shift:
        print("note: labels are 1-indexed across all npz files; reindexing to 0-based",
              flush=True)

    multi = len(resolutions) > 1
    dirs = [os.path.join(args.out, f"r{res:04d}") if multi else args.out
            for res in resolutions]
    made = [packed.write_store(d, n, res, res, 3, classes=[])
            for d, res in zip(dirs, resolutions)]
    stores, labels_arrs = [m[0] for m in made], [m[1] for m in made]

    t0 = time.time()
    pos = 0
    for f in files:
        if pos >= n:
            break
        with np.load(f) as d:
            x = d["data"]
            if x.ndim == 2:
                x = x.reshape(-1, 3, args.size, args.size).transpose(0, 2, 3, 1)
            y = np.asarray(_labels(d), np.int64) - shift
            for i in range(0, len(x), args.chunk):
                if pos >= n:
                    break
                take = min(args.chunk, n - pos, len(x) - i)
                pyramid_write(stores, labels_arrs, pos,
                              np.ascontiguousarray(x[i:i + take], np.uint8),
                              y[i:i + take].astype(np.int32), resolutions)
                pos += take
    ncls = int(max(la.max() for la in labels_arrs) + 1) if pos else 0
    for d in dirs:
        path = os.path.join(d, packed.META_NAME)
        with open(path) as fh:
            meta = json.load(fh)
        meta["num_classes"], meta["classes"] = ncls, None
        with open(path, "w") as fh:
            json.dump(meta, fh)
    for d, store, labels in zip(dirs, stores, labels_arrs):
        packed.finalize_store(d, store, labels)
    dt = time.time() - t0
    print(json.dumps({"packed": pos, "resolutions": resolutions, "out": args.out,
                      "seconds": dt, "img_per_s": pos / max(dt, 1e-9),
                      "bytes": sum(int(np.prod(s.shape)) for s in stores)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
