"""Render the ``rich`` synthetic distribution into a packed uint8 store (port
of ``tools/prepack_synthetic.py``): the real side of SWD/FID-style evals of
models trained on ``--data device-rich``, where no real CelebA-HQ or
ImageNet is at hand.

Labels, then images, are drawn from one ``default_rng(--seed)`` in chunks of
``--chunk`` by the host renderer (``data/fake.py:_rich_images_np``, the
reference's draw for draw) and quantized to uint8 as the real-data path
stores them, so the store is byte-equal to the reference tool's on the
same flags. ``--resolutions 128,64,...,4`` also writes the PGGAN ladder's
pyramid (``r{res:04d}/`` members, each level the 2x box downsample of the
one above, as ``tools/prepack_dataset.py --resolutions`` writes it), which
``cli.train_pggan --data <out>`` reads.

Usage:
  python -m gan_lib_tensorflow_tpu_torch.tools.prepack_synthetic --out /data/rich256 \\
      --n 16384 --size 256
  python -m gan_lib_tensorflow_tpu_torch.tools.prepack_synthetic --out /data/pyr128 \\
      --n 16384 --size 128 --resolutions 128,64,32,16,8,4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..data import fake, packed
from .prepack_dataset import pyramid_write


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=16384)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--num-classes", type=int, default=0,
                   help="0 = unconditional (labels all zero, no labels.npy)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--resolutions", default=None,
                   help="comma list starting at --size and descending by "
                        "2x: also write the PGGAN pyramid members "
                        "(r{res:04d}/ subdirs, box-downsampled)")
    args = p.parse_args(argv)

    resolutions = ([int(r) for r in args.resolutions.split(",")]
                   if args.resolutions else [args.size])
    if resolutions[0] != args.size or resolutions != sorted(resolutions, reverse=True):
        raise ValueError("--resolutions must start at --size and descend")
    multi = len(resolutions) > 1
    dirs = [os.path.join(args.out, f"r{res:04d}") if multi else args.out
            for res in resolutions]

    classes = [str(i) for i in range(args.num_classes)] if args.num_classes else None
    made = [packed.write_store(d, args.n, res, res, 3, classes=classes)
            for d, res in zip(dirs, resolutions)]
    stores, labels_arrs = [m[0] for m in made], [m[1] for m in made]
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for pos in range(0, args.n, args.chunk):
        k = min(args.chunk, args.n - pos)
        lab = (rng.integers(0, args.num_classes, (k,)).astype(np.int32)
               if args.num_classes else np.zeros((k,), np.int32))
        x = fake._rich_images_np(rng, lab, args.size, max(args.num_classes, 1))
        chunk_u8 = np.clip(np.rint((x + 1.0) * 127.5), 0, 255).astype(np.uint8)
        pyramid_write(stores, labels_arrs, pos, chunk_u8, lab, resolutions)
        if (pos // args.chunk) % 16 == 0:
            done = pos + k
            print(f"  {done}/{args.n} ({done / max(time.time() - t0, 1e-9):.0f} img/s)",
                  flush=True)
    for d, images, labels in zip(dirs, stores, labels_arrs):
        packed.finalize_store(d, images, labels)
    dt = time.time() - t0
    print(json.dumps({"packed": args.n, "size": args.size, "out": args.out,
                      "resolutions": resolutions, "seconds": round(dt, 1),
                      "img_per_s": round(args.n / max(dt, 1e-9), 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
