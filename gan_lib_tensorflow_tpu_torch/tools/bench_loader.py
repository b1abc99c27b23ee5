"""Real-data loader feed rates and the memmap RSS bound (port of
``tools/bench_loader.py``).

Builds a synthetic packed store (uint8 memmap, ImageNet-128-like by
default) and measures:
  * ``PackedImageStore`` batch assembly (a sorted gather out of the memmap,
    normalized on the host)
  * the same through ``ThreadedSource``: one worker (what the CLIs stream
    with) and two (the round-robin order)
  * ``DeviceCachedStore``: the store held on ``--device``, each batch a
    gather and normalize there (the CLIs' default for a store that fits)
  * with ``--rss-demo``, the RSS growth while a fresh process streams the
    whole store, which must stay far below the store's size

One JSON line per loader: ``loader, batch, img_per_s, ms_per_batch`` (the
first also ``n, size, store_gb, rss_delta_mb``).

Usage: python -m gan_lib_tensorflow_tpu_torch.tools.bench_loader --n 4000 --size 128 --batch 64
       python -m gan_lib_tensorflow_tpu_torch.tools.bench_loader --n 16000 --size 128 --rss-demo
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from .. import data, resolve_device
from ..data import packed
from ..utils.profiler import hard_sync
from . import harness

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def build_store(out_dir: str, n: int, size: int) -> None:
    """Fill a labelled store with seeded random bytes in chunks written
    straight into the memmap (the store is never whole in memory)."""
    images, labels = packed.write_store(out_dir, n, size, size, 3,
                                        classes=[str(i) for i in range(1000)])
    rng = np.random.default_rng(0)
    for i in range(0, n, 256):
        take = min(256, n - i)
        images[i:i + take] = rng.integers(0, 256, (take, size, size, 3), np.uint8)
        labels[i:i + take] = rng.integers(0, 1000, take)
    packed.finalize_store(out_dir, images, labels)


def measure(source, batch_size: int, n_batches: int, device=None) -> dict:
    """Batches per second after one warm batch (the first pays the
    permutation and page faults); ``device``: synchronized with it at both
    ends."""
    it = iter(source)
    next(it)
    hard_sync(device)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        b = next(it)
    hard_sync(device)
    dt = time.perf_counter() - t0
    if not str(b["image"].dtype).endswith("float32"):  # numpy or torch
        raise TypeError(f"the loader yielded {b['image'].dtype} images, not float32")
    return {"img_per_s": n_batches * batch_size / dt, "ms_per_batch": dt / n_batches * 1e3}


RSS_DEMO = """
import json, sys
sys.path.insert(0, {repo!r})
from gan_lib_tensorflow_tpu_torch import data
def status(key):
    return next((int(l.split()[1]) for l in open('/proc/self/status')
                 if l.startswith(key)), 0) / 1024.0
r0, f0 = status('VmRSS'), status('RssFile')
src = data.PackedImageStore({store!r}, batch_size={batch}, seed=1)
r_open = status('VmRSS')
it = iter(src)
n = len(src) // {batch}
for _ in range(n):
    next(it)
r1, f1 = status('VmRSS'), status('RssFile')
print(json.dumps({{"rss_demo": True, "streamed_batches": n,
                  "open_cost_mb": r_open - r0, "rss_delta_mb": r1 - r0,
                  "file_backed_mb": f1 - f0, "heap_delta_mb": (r1 - r0) - (f1 - f0)}}))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=4000)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n-batches", type=int, default=100)
    p.add_argument("--store-dir", default=None,
                   help="reuse an existing store instead of building one")
    p.add_argument("--keep", action="store_true")
    p.add_argument("--rss-demo", action="store_true",
                   help="report RSS before/after streaming the whole store")
    p.add_argument("--device", default="cuda",
                   help="where DeviceCachedStore holds the store")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    store_dir = args.store_dir or os.path.join(
        tempfile.gettempdir(), f"ganpack_bench_{args.n}x{args.size}")
    try:
        if not packed.is_packed_dir(store_dir):
            t0 = time.perf_counter()
            build_store(store_dir, args.n, args.size)
            harness.emit({"built": store_dir, "n": args.n, "size": args.size,
                          "gb": args.n * args.size ** 2 * 3 / 1e9,
                          "build_s": time.perf_counter() - t0})
        b = args.batch
        base_rss = rss_mb()
        store = data.PackedImageStore(store_dir, batch_size=b, seed=0)
        row = {"loader": "PackedImageStore", "n": len(store), "size": store.image_size,
               "batch": b, "store_gb": len(store) * store.image_size ** 2 * 3 / 1e9}
        row.update(measure(store, b, args.n_batches))
        row["rss_delta_mb"] = rss_mb() - base_rss
        harness.emit(row)
        for workers in (1, 2):
            threaded = data.ThreadedSource(
                data.PackedImageStore(store_dir, batch_size=b, seed=0), num_workers=workers)
            harness.emit({"loader": f"ThreadedSource(PackedImageStore, workers={workers})",
                          "batch": b, **measure(threaded, b, args.n_batches)})
        cached = data.DeviceCachedStore(store_dir, batch_size=b, seed=0, device=dev)
        harness.emit({"loader": "DeviceCachedStore", "batch": b,
                      "resident_mb": cached.nbytes_resident() / 2**20,
                      **measure(cached, b, args.n_batches, dev), "card": harness.card(dev)})
        del cached
        if args.rss_demo:
            # a fresh process: its RSS holds no thread queues or allocator
            # arenas of this one; the heap delta leaves out the reclaimable
            # file-backed memmap pages
            out = subprocess.run(
                [sys.executable, "-c", RSS_DEMO.format(repo=REPO, store=store_dir, batch=b)],
                capture_output=True, text=True, check=True)
            harness.emit(json.loads(out.stdout.strip().splitlines()[-1]))
    finally:
        if not args.keep and not args.store_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
