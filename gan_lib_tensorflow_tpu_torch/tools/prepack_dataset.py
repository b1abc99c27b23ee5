"""Prepack an image dataset into a uint8 memmap store (port of
``tools/prepack_dataset.py``; the store layout is ``data/packed.py``'s, and
every store is byte-equal to the reference tool's on the same input).

Inputs:
  * a folder of class subdirectories of images -> labelled store (ImageNet)
  * a flat folder of images                     -> unlabelled store (CelebA-HQ)
  * an ``.npz`` file, or a directory of them, with ``data`` (NHWC uint8, or
    rows of ``3 * size * size`` CHW bytes as the downsampled-ImageNet files
    hold them) and ``labels`` (or ``label``) -> labelled store, streamed
    file by file; labels that start at 1 across all files start at 0
  * ``--paired``: a folder of combined A|B images (pix2pix) -> a paired
    store of ``[N, size, 2 * size, 3]`` rows, each half resized to --size

Images (``.jpg .jpeg .png .bmp .webp``, by lower-cased extension, sorted)
are decoded by ``data/codec.py`` (the hand-written JPEG, PNG and WebP
decoders, bit-equal to Pillow), center-cropped to their short side and
resized to --size with Pillow's bilinear resample; a file it cannot decode
(a truncated or corrupt one) stops the tool with a ``ValueError`` naming
it. With ``--resolutions`` the output is a
PGGAN pyramid store (members ``r{res:04d}/``): each chunk of the top level
is box-downsampled by 2 in float32 level after level (``data/multires.py``)
and rounded to uint8.

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.prepack_dataset --src imagenet/train \\
           --out /data/packed128 --size 128
       python -m gan_lib_tensorflow_tpu_torch.tools.prepack_dataset --src celeba_hq \\
           --out /data/pg --size 1024 --resolutions 1024,512,256,128,64,32,16,8,4
       python -m gan_lib_tensorflow_tpu_torch.tools.prepack_dataset --src facades/train \\
           --out /data/facades286 --size 286 --paired
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from ..data import codec, packed
from ..data.multires import box_downsample

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def npz_inputs(src: str):
    """The ``.npz`` files of ``src`` (a file, or a directory of them), or
    None when ``src`` holds none."""
    if os.path.isfile(src) and src.endswith(".npz"):
        return [src]
    if os.path.isdir(src):
        return sorted(glob.glob(os.path.join(src, "*.npz"))) or None
    return None


def image_inputs(src: str):
    """``(files, labels, classes)`` of an image folder (reference
    ``_list_inputs``): the images of its sorted class subdirectories with
    their class indices, or, when those hold none, its own images with
    labels and classes None."""
    if os.path.isdir(src):
        subdirs = sorted(d for d in os.listdir(src) if os.path.isdir(os.path.join(src, d)))
        files, labels = [], []
        for ci, c in enumerate(subdirs):
            for f in sorted(os.listdir(os.path.join(src, c))):
                if f.lower().endswith(IMG_EXTS):
                    files.append(os.path.join(src, c, f))
                    labels.append(ci)
        if files:
            return files, labels, subdirs
        flat = [os.path.join(src, f) for f in sorted(os.listdir(src))
                if f.lower().endswith(IMG_EXTS)]
        if flat:
            return flat, None, None
    raise FileNotFoundError(f"--src {src!r}: no images, class dirs, or npz found")


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


def _stores(out: str, n: int, resolutions, classes):
    """One store per resolution (``r{res:04d}/`` members when several)."""
    dirs = [os.path.join(out, f"r{res:04d}") if len(resolutions) > 1 else out
            for res in resolutions]
    made = [packed.write_store(d, n, res, res, 3, classes=classes)
            for d, res in zip(dirs, resolutions)]
    return dirs, [m[0] for m in made], [m[1] for m in made]


def pack_images(args, resolutions) -> int:
    """An image folder (class subdirectories or flat) -> a store, or a
    pyramid of them, in chunks of --chunk images."""
    files, labels, classes = image_inputs(args.src)
    n = min(len(files), args.limit) if args.limit else len(files)
    dirs, stores, labels_arrs = _stores(args.out, n, resolutions, classes)
    t0 = time.time()
    for pos in range(0, n, args.chunk):
        chunk = files[pos:pos + args.chunk][:n - pos]
        pyramid_write(stores, labels_arrs, pos,
                      np.stack([codec.load_square(f, args.size) for f in chunk]),
                      None if labels is None else
                      np.asarray(labels[pos:pos + len(chunk)], np.int32), resolutions)
        if (pos + len(chunk)) % (args.chunk * 8) == 0:
            print(f"  {pos + len(chunk)}/{n} ({(pos + len(chunk)) / (time.time() - t0):.0f} "
                  "img/s)", flush=True)
    for d, store, la in zip(dirs, stores, labels_arrs):
        packed.finalize_store(d, store, la)
    dt = time.time() - t0
    print(json.dumps({"packed": n, "resolutions": resolutions, "out": args.out,
                      "seconds": dt, "img_per_s": n / max(dt, 1e-9),
                      "bytes": sum(int(np.prod(s.shape)) for s in stores)}), flush=True)
    return 0


def pack_paired(args) -> int:
    """--paired: combined A|B images -> a paired store at --size per half
    (``write_store(..., paired=True)``)."""
    files, _, _ = image_inputs(args.src)
    n = min(len(files), args.limit) if args.limit else len(files)
    s = args.size
    store, _ = packed.write_store(args.out, n, s, 2 * s, 3, classes=None, paired=True)
    t0 = time.time()
    for pos in range(n):
        store[pos] = np.concatenate(codec.load_halves(files[pos], s), axis=1)
        if (pos + 1) % (args.chunk * 4) == 0:
            print(f"  {pos + 1}/{n} ({(pos + 1) / (time.time() - t0):.0f} img/s)", flush=True)
    packed.finalize_store(args.out, store, None)
    dt = time.time() - t0
    print(json.dumps({"packed": n, "paired": True, "scale_size": s, "out": args.out,
                      "seconds": dt, "img_per_s": n / max(dt, 1e-9),
                      "bytes": int(np.prod(store.shape))}), flush=True)
    return 0


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
                   help="combined A|B images (pix2pix): store both halves at --size "
                        "per half; the per-step jitter happens in "
                        "data.PackedPairedStore")
    args = p.parse_args(argv)
    if args.paired:
        return pack_paired(args)
    resolutions = ([int(r) for r in args.resolutions.split(",")]
                   if args.resolutions else [args.size])
    if resolutions[0] != args.size or resolutions != sorted(resolutions, reverse=True):
        raise ValueError("--resolutions must start at --size and descend")
    files = npz_inputs(args.src)
    if files is None:
        return pack_images(args, resolutions)

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
