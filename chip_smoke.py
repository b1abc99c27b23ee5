#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
final line):
  1. device: torch's name for the card, and nvidia-smi's name and power limit
  2. build: compile both hand-written kernels (nvcc, sm_90a) from csrc/, one
     nvcc process per source, started together
  3. power-iteration kernel vs plain: the batched power-iteration kernel
     against its plain PyTorch version on the card (sigma, u', v and
     d sigma / dW; rtol 1e-4, float32 with TF32 off), at the CIFAR-D,
     tests/test_pallas.py and ImageNet-128 wide shapes; two launches on the
     same inputs must be bit-identical
  4. fade-in kernel vs plain: ``fadein_blend`` against its plain version
     (rtol 1e-5, atol 1e-6) at the tests/test_pallas.py shape with alpha
     0, 0.37 and 1, at both PGGAN 1024^2 shapes in channels-last layout, and
     at a ragged, unaligned size; first gradients and a double backward;
     bit-equal at sizes either side of whole blocks, at offsets 0-3
  5. SNGAN main path: the fused SNGAN CIFAR-10 train step at full width
     (batch 64, n_critic 5, bf16 compute, EMA 0.9999, on-device fake data)
     through the port's CLI ``build`` and ``train_loop``; images/s, ms/step,
     peak memory; the power-iteration kernel must launch 6 times per step
     (5 critic D forwards + 1 in the G loss); then D and G forwards in
     float32 on the card against the CPU
  6. PGGAN main path: the ladder 4^2 -> 1024^2 at full width (Karras
     channels, z 512, Karras batch schedule, fused_scale D blocks from 128,
     bf16) through the port's CLI parsing and ``train_pggan_ladder``, 2 steps
     per phase (17 phases, 8 of them transitions); the fade-in kernel must
     launch 6 times per transition step and never in a stabilize step, every
     logged metric must be finite, and every tensor shared across a
     migration must be carried bit-exact
  7. PGGAN 1024^2 transition phase at batch 4, built by the ladder's own
     ``build_phase``: images/s, ms/step, peak memory; then full-width
     float32 G and D of the 64^2 transition stage on the card against the
     CPU (rtol 1e-3, atol 1e-3)
  8. kernel timing at the main paths' shapes: device time of CUDA-graph
     replays (many launches captured once, replayed between CUDA events, so
     the host's launch gaps are left out), taken in turns: each kernel, its
     plain version, the one PyTorch call that computes the same function
     where there is one, the bound of the work on this card, the host time
     of one wrapper call, the power iteration's empty-kernel floor, and
     nvidia-smi's clocks before and after
  9. checkpoint, resume, sample, eval on the card (cuDNN deterministic, in
     a temporary directory): (a) the full-width SNGAN step through
     ``train_sngan.main`` with a checkpoint every 4 steps and a fault at step
     6, re-run to resume from step 4 to 12, and every tensor of that run
     bit-equal to an uninterrupted 12-step run, the power-iteration kernel
     launched 6 times per step in each run; checkpoint bytes, save and
     restore ms; (b) ``cli.sample`` writes the 64-image grid; (c)
     ``cli.evaluate`` with the random-init InceptionV3 at 5000 samples and
     5000 reals, then again from the cached real moments, to the last digit;
     samples/s of the eval passes; InceptionV3 on the card against the CPU;
     (d) the PGGAN ladder to 64x64 at full width with per-phase checkpoints,
     interrupted in the 64x64 transition and re-run to its end, the fade-in
     kernel launched 6 times per transition step (and once per sample grid
     of a transition phase)
 10. data layer and north star (in a temporary directory): a synthetic
     CIFAR-10 pickle directory at the real layout and size (50,000 + 10,000
     images); ``train_sngan.main --data <dir>`` for 12 full-width steps
     through ``DeviceCachedStore`` (resident bytes, ms/step, 6
     power-iteration launches per step), one device batch bit-equal to the
     host gather of the same ``indices_for(pos)``; a ``--device-cache off``
     run's first batch through ``prefetch_to_device`` bit-equal to the host
     stream's, and 2 steps of it; one ``north_star.main`` call on that
     directory with an InceptionV3 npz written from the port's random-init
     net (statistics calibrated on the data): a verdict line and
     ``graded: true`` in its record (FAIL is expected: the extractor is
     random)
 11. SNGAN-projection ImageNet-128 at full width: a packed store of 3,200
     128x128 images with 1000-class labels written by the port's
     ``write_store``; ``train_sngan_imagenet.main --data <store>`` for 12
     steps across an epoch boundary (images/s, ms/step, peak memory, 6
     power-iteration launches per step, which of D's 19 weights the kernel
     streams); the kernel against its plain version at D's 19 weights; full
     width float32 G and D on the card against the CPU at batch 2; the
     19-weight launch's device time beside its bound and the empty-kernel
     floor

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import math
import os
import pickle
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores. Both kernels' work is fp32 and not on the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

WARM_STEPS, TIMED_STEPS = 3, 20
N_CRITIC, BATCH = 5, 64
PGGAN_STEPS_PER_PHASE = 2
PGGAN_WARM, PGGAN_TIMED = 3, 10

# shapes of the two fade-ins of the PGGAN 1024^2 transition step at batch 4:
# G's RGB [N, 3, 1024, 1024], D's first block output [N, 32, 512, 512]
FADEIN_MAIN_SHAPES = [(4, 3, 1024, 1024), (4, 32, 512, 512)]
FADEIN_PALLAS_SHAPE = (3, 17, 9, 4)  # tests/test_pallas.py:37
FADEIN_BLOCK_ELEMS = 1024 * 4  # one block of csrc/fadein_blend.cu: 1024 threads x float4

# [fan_in, out] of the 11 CIFAR-D spectral-norm weights, and of test_pallas.py
CIFAR_D_SHAPES = ([(27, 128), (1152, 128), (3, 128), (1152, 128), (1152, 128),
                   (128, 128)] + [(1152, 128)] * 4 + [(128, 1)])
PALLAS_SHAPES = [(1152, 128), (27, 64), (128, 1), (9, 256)]
# the SNGAN-projection ImageNet-128 D's widest 3x3 convs (512->1024, 1024->1024):
# slabs too large for shared memory, streamed from device memory
IMAGENET_WIDE_SHAPES = [(4608, 1024), (9216, 1024)]
# the real CIFAR-10 layout: five training pickles and one test pickle of
# 10,000 images each, 3072 bytes per image
CIFAR_FILES, CIFAR_PER_FILE = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"], 10_000
CIFAR_STEPS, IMAGENET_STEPS, LOG_EVERY = 12, 12, 4
IMAGENET_STORE = 3_200  # 10 fused steps of 5 x 64 images: an epoch ends inside the run


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def device_ms(fn, iters: int, repeats: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured once in a
    CUDA graph after a warm-up, the graph replayed ``repeats`` times between
    CUDA events; the median replay over ``iters``. The host's launch gaps are
    not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up where the capture will run
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(fn, calls: int) -> float:
    """Median host time of one call of ``fn`` (no synchronisation between
    calls): what a wrapper costs the host per launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def timed_in_turns(fns: dict, iters: int, rounds: int = 3) -> dict:
    """``device_ms`` of each function, taken in turns over ``rounds`` rounds
    (the order reversed every other round); the median of the rounds."""
    got = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(device_ms(fns[k], iters))
    return {k: statistics.median(v) for k, v in got.items()}


def compare_kernel(pi, torch, shapes, seed):
    """Kernel vs plain version on random weights; returns the max abs error
    of sigma, u' and v."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ws = [torch.randn(k, m, device="cuda", generator=g) for m, k in shapes]
    us = [torch.randn(1, k, device="cuda", generator=g) for _, k in shapes]
    sigma, u_out, v_out = pi.launch(ws, us)
    s_ref, u_ref, v_ref = pi.plain_power_iteration(ws, us)
    u_ref, v_ref = torch.cat(u_ref), torch.cat(v_ref)
    torch.testing.assert_close(sigma, s_ref.detach(), rtol=1e-4, atol=0.0)
    torch.testing.assert_close(u_out, u_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v_out, v_ref, rtol=1e-4, atol=1e-5)
    err = max(float((sigma - s_ref).abs().max()), float((u_out - u_ref).abs().max()),
              float((v_out - v_ref).abs().max()))

    # gradient: autograd through the kernel's Function vs through the plain
    c = torch.randn(len(shapes), device="cuda", generator=g)
    grads = []
    for fn in (lambda w: pi.batched_power_iteration(w, us),
               lambda w: pi.plain_power_iteration(w, us)[0]):
        wg = [w.clone().requires_grad_(True) for w in ws]
        (fn(wg) * c).sum().backward()
        grads.append([w.grad for w in wg])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)

    # update flag: u' written into the u buffers only when asked
    u_copy = [u.clone() for u in us]
    pi.launch(ws, u_copy, write_u=False)
    check(all(torch.equal(a, b) for a, b in zip(u_copy, us)), "u moved without update")
    pi.launch(ws, u_copy, write_u=True)
    torch.testing.assert_close(torch.cat([u.reshape(-1) for u in u_copy]), u_out)
    return err


def compare_fadein(fd, torch):
    """The fade-in kernel vs its plain version: outputs, first gradients and
    a double backward. Returns the max abs error of the outputs."""
    g = torch.Generator(device="cuda").manual_seed(2)
    cl = torch.channels_last
    cases = [(FADEIN_PALLAS_SHAPE, a, None) for a in (0.0, 0.37, 1.0)]
    cases += [(s, 0.37, cl) for s in FADEIN_MAIN_SHAPES]
    cases.append(((1001,), 0.37, "unaligned"))  # scalar path and ragged tail
    err = 0.0
    for shape, alpha, layout in cases:
        if layout == "unaligned":
            a = torch.randn(shape[0] + 1, device="cuda", generator=g)[1:]
            b = torch.randn(shape[0] + 1, device="cuda", generator=g)[1:]
        else:
            a = torch.randn(shape, device="cuda", generator=g)
            b = torch.randn(shape, device="cuda", generator=g)
            if layout is not None:
                a, b = a.contiguous(memory_format=layout), b.contiguous(memory_format=layout)
        before = fd.launches
        out = fd.fadein_blend(a, b, alpha)
        check(fd.launches == before + 1, "fade-in launch counter did not advance")
        check(out.stride() == a.stride(), f"output strides {out.stride()} != {a.stride()}")
        ref = fd.plain_fadein_blend(a, b, alpha)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        err = max(err, float((out - ref).abs().max()))
    # first gradients through the wrapper vs through the plain version
    a = torch.randn(FADEIN_MAIN_SHAPES[1], device="cuda", generator=g).contiguous(memory_format=cl)
    b = torch.randn_like(a)
    r = torch.randn_like(a)
    grads = []
    for fn in (fd.fadein_blend, fd.plain_fadein_blend):
        ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        (fn(ag, bg, 0.37) * r).sum().backward()
        grads.append((ag.grad, bg.grad))
    for x, y in zip(*grads):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    # double backward, as the gradient penalty takes it through D's blend
    x0 = torch.randn(4, 32, 16, 16, device="cuda", generator=g).contiguous(memory_format=cl)
    second = []
    for fn in (fd.fadein_blend, fd.plain_fadein_blend):
        w = torch.tensor(1.7, device="cuda", requires_grad=True)
        x = x0.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((fn(w * x, x * x, 0.3) ** 2).sum(), x, create_graph=True)
        (gw,) = torch.autograd.grad((gx ** 2).sum(), w)
        second.append(gw)
    torch.testing.assert_close(second[0], second[1], rtol=1e-5, atol=1e-6)
    return err


def snapshot(st):
    """Every tensor of G, D and the EMA, cloned on the device."""
    return {("g", n): p.detach().clone() for n, p in st.g.named_parameters()} | {
        ("d", n): p.detach().clone() for n, p in st.d.named_parameters()} | {
        ("ema", n): t.clone() for n, t in st.ema_params.items()}


def flat_items(obj, path=()):
    """(path, leaf) of every leaf of nested dicts, lists and tuples."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from flat_items(v, path + (k,))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from flat_items(v, path + (i,))
    else:
        yield path, obj


def timed_calls(module, name: str, sink: list) -> None:
    """Wrap ``module.name`` so each call appends its synchronised seconds to
    ``sink`` (the eval passes inside ``cli.evaluate``)."""
    import torch
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapped)


def checkpoint_resume_eval(card: str, tmp: str) -> None:
    """Phase 9, in the temporary directory ``tmp``."""
    import contextlib
    import io

    import torch
    from gan_lib_tensorflow_tpu_torch.cli import evaluate, sample, train_pggan, train_sngan
    from gan_lib_tensorflow_tpu_torch.data import DeviceFakeImages
    from gan_lib_tensorflow_tpu_torch.eval import metrics
    from gan_lib_tensorflow_tpu_torch.eval.inception_v3 import InceptionV3Features
    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.train import CheckpointManager, to_checkpoint
    from gan_lib_tensorflow_tpu_torch.train.pggan_loop import train_pggan_ladder

    # (a) SNGAN: fault at step 6, resume from the step-4 checkpoint to 12
    run, straight_dir = os.path.join(tmp, "sngan"), os.path.join(tmp, "sngan_straight")
    sn_args = ["--data", "fake", "--device", "cuda", "--batch-size", str(BATCH),
               "--n-critic", str(N_CRITIC), "--ema-decay", "0.9999", "--compute-dtype",
               "bf16", "--steps", "12", "--ckpt-every", "4", "--sample-every", "6",
               "--log-every", "4"]
    launches = []
    pi.launches = 0
    try:
        train_sngan.main(sn_args + ["--out-dir", run, "--fault-inject-step", "6"])
        check(False, "the injected fault did not raise")
    except RuntimeError as e:
        check("fault injected at step 6" in str(e), f"unexpected error: {e}")
    launches.append(pi.launches)
    check(CheckpointManager(os.path.join(run, "ckpt")).latest_step() == 4,
          "the step-4 checkpoint is not the latest after the fault")
    for out_dir in (run, straight_dir):
        pi.launches = 0
        state = train_sngan.main(sn_args + ["--out-dir", out_dir])
        torch.cuda.synchronize()
        launches.append(pi.launches)
        if out_dir == run:
            resumed = state
    straight = state
    check(resumed.step == straight.step == 12, "a run did not end at step 12")
    check(launches == [6 * 6, 6 * 8, 6 * 12],
          f"power-iteration launches {launches} in 6, 8 and 12 steps, want 6 per step")
    got = dict(flat_items(to_checkpoint(resumed)))
    want = dict(flat_items(to_checkpoint(straight)))
    check(got.keys() == want.keys(), "the resumed and uninterrupted states differ in keys")
    differ = [k for k in want if not (torch.equal(got[k], want[k])
                                      if isinstance(want[k], torch.Tensor)
                                      else got[k] == want[k])]
    check(not differ, f"{len(differ)} of {len(want)} leaves differ after the resume, "
                      f"e.g. {differ[:5]}")
    n_tensors = sum(isinstance(v, torch.Tensor) for v in want.values())
    print(f"SNGAN resume: fault at step 6, resumed from step 4 to 12; all {len(want)} "
          f"leaves ({n_tensors} tensors: G, D, EMA, Adam slots, lr schedules, noise "
          f"generators) bit-equal to the uninterrupted run; power-iteration launches "
          f"{launches[0]}, {launches[1]}, {launches[2]} in 6, 8, 12 steps (6 per step)")

    ckpt = CheckpointManager(os.path.join(run, "ckpt"))
    n_bytes = os.path.getsize(ckpt.path(12))
    bench = CheckpointManager(os.path.join(tmp, "bench"), max_to_keep=1)
    save_ms, restore_ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench.save(i, straight, wait=True)
        save_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        bench.restore_latest(straight)
        torch.cuda.synchronize()
        restore_ms.append(1e3 * (time.perf_counter() - t0))
    bench.close()
    print(f"checkpoint: {n_bytes} bytes on disk ({n_bytes / 1e6:.2f} MB); save (host "
          f"copy + write, waited) {', '.join(f'{t:.1f}' for t in save_ms)} ms; restore "
          f"(read + copy to the card) {', '.join(f'{t:.1f}' for t in restore_ms)} ms  [{card}]")

    # (b) the sample grid of that checkpoint
    png = os.path.join(tmp, "samples.png")
    sample.main(["--model", "sngan", "--ckpt-dir", os.path.join(run, "ckpt"),
                 "--out", png, "--n", "64", "--device", "cuda"])
    with open(png, "rb") as f:
        head = f.read(24)
    width, height = struct.unpack(">II", head[16:24])
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
          and (width, height) == (8 * 32, 8 * 32),
          f"sample grid header {head!r}, want a 256x256 PNG (8x8 tiles of 32x32)")
    print(f"cli.sample: {png} is a {width}x{height} PNG (8x8 tiles of 32x32), "
          f"{os.path.getsize(png)} bytes")

    # (c) IS/FID through the full random-init InceptionV3, then from the cache
    passes, reals, fids = [], [], []
    timed_calls(evaluate, "evaluate_generator", passes)
    timed_calls(evaluate, "compute_statistics", reals)
    timed_calls(metrics, "frechet_distance", fids)  # host sqrtm, inside each pass
    ev_args = ["--model", "sngan", "--ckpt-dir", os.path.join(run, "ckpt"),
               "--n-samples", "5000", "--n-real", "5000", "--data", "fake",
               "--real-stats-npz", os.path.join(tmp, "real_stats.npz"), "--device", "cuda"]
    results, logs = [], []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            results.append(evaluate.main(ev_args))
        logs.append(buf.getvalue())
        print(buf.getvalue(), end="")
    first, second = results
    check(all(math.isfinite(first[k]) for k in ("inception_score", "fid"))
          and first["step"] == 12 and first["samples_evaluated"] == 5000,
          f"eval result {first}")
    check("cached real moments to" in logs[0] and "loaded cached real moments" in logs[1]
          and len(reals) == 1, "the second eval did not load the cached real moments")
    check(first == second, f"the cached-moment eval differs: {first} vs {second}")
    # the device passes without the host FID (scipy sqrtm of a 2048x2048 product)
    device_s = [p - f for p, f in zip(passes, fids)]
    print(f"eval: IS {first['inception_score']!r} +- {first['inception_score_std']!r}, "
          f"FID {first['fid']!r}, step {first['step']}; the second call (cached real "
          f"moments) agrees in every digit. Real pass 5000 images {reals[0]:.2f} s "
          f"({5000 / reals[0]:.1f} images/s); generate + features + sums of 5000 "
          f"samples {device_s[0]:.2f} s and {device_s[1]:.2f} s ({5000 / device_s[0]:.1f} "
          f"and {5000 / device_s[1]:.1f} samples/s); FID on the host (scipy sqrtm) "
          f"{fids[0]:.2f} s and {fids[1]:.2f} s; whole calls {passes[0]:.2f} s and "
          f"{passes[1]:.2f} s; float32, TF32 off  [{card}]")

    nets = [InceptionV3Features(seed=0, device=d) for d in ("cuda", "cpu")]
    x = next(iter(DeviceFakeImages(batch_size=4, device="cpu")))["image"][0]
    (f_gpu, l_gpu), (f_cpu, l_cpu) = nets[0](x.cuda()), nets[1](x)
    torch.testing.assert_close(f_gpu.cpu(), f_cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-3, atol=1e-3)
    inc_err = max(float((f_gpu.cpu() - f_cpu).abs().max()),
                  float((l_gpu.cpu() - l_cpu).abs().max()))
    print(f"InceptionV3 (random init, batch statistics) features and logits of 4 "
          f"images at 32x32 on the card agree with the CPU, float32 with TF32 off "
          f"(rtol 1e-3, atol 1e-3): max abs err {inc_err:.3e}  [{card}]")
    del nets

    # (d) PGGAN to 64x64: interrupted one batch into the 64x64 transition, re-run
    class Interrupted(Exception):
        pass

    class RaiseAfterOne:
        yields_stacks = True

        def __init__(self, inner):
            self.inner = inner

        def set_stream_position(self, pos):
            self.inner.set_stream_position(pos)

        def __iter__(self):
            it = iter(self.inner)
            yield next(it)
            raise Interrupted()

    pg_args = train_pggan.parse_args([
        "--data", "fake", "--device", "cuda", "--final-resolution", "64",
        "--steps-per-phase", str(PGGAN_STEPS_PER_PHASE), "--log-every", "1",
        "--compute-dtype", "bf16", "--out-dir", os.path.join(tmp, "pggan"),
        "--ckpt-every", "1", "--sample-every", str(PGGAN_STEPS_PER_PHASE)])
    cfg = train_pggan.ladder_config(pg_args)
    make_source = train_pggan.source_factory(pg_args)
    counts, current = [], []

    def hook(when, res, name, st):
        if when == "start":
            current[:] = [(res, name)]
            counts.append([res, name, fd.launches, pi.launches])
        else:
            torch.cuda.synchronize()
            counts[-1][2:] = [fd.launches - counts[-1][2], pi.launches - counts[-1][3], st.step]

    def interrupting(res, batch):
        src = make_source(res, batch)
        return RaiseAfterOne(src) if current[0] == (64, "transition") else src

    t0 = time.perf_counter()
    fd.launches = pi.launches = 0  # count this path's launches only
    try:
        train_pggan_ladder(cfg, interrupting, phase_hook=hook, log_fn=lambda it, m: None)
        check(False, "the interrupting source did not raise")
    except Interrupted:
        counts[-1][2:] = [fd.launches - counts[-1][2], pi.launches - counts[-1][3]]
    totals = [(fd.launches, pi.launches)]
    first_run, counts = counts, []
    fd.launches = pi.launches = 0
    resumed_pg = train_pggan_ladder(cfg, make_source, phase_hook=hook,
                                    log_fn=lambda it, m: None)
    torch.cuda.synchronize()
    totals.append((fd.launches, pi.launches))
    pg_s = time.perf_counter() - t0
    check(len(first_run) == 8 and len(counts) == 9, f"{len(first_run)} and {len(counts)} "
          "phases in the interrupted run and the re-run, want 8 and 9")
    check(resumed_pg.step == PGGAN_STEPS_PER_PHASE and resumed_pg.alpha == 1.0,
          "the re-run ladder did not end in the 64x64 stabilize phase")
    # a transition phase trained to its end launches 6 per step + 1 for its grid
    full = 6 * PGGAN_STEPS_PER_PHASE + 1
    want_first = [full if n == "transition" else 0 for _, n, *_ in first_run[:-1]] + [6]
    want_again = [0] * 7 + [6 * (PGGAN_STEPS_PER_PHASE - 1) + 1, 0]
    got_first = [rec[2] for rec in first_run]
    got_again = [rec[2] for rec in counts]
    check(got_first == want_first and got_again == want_again,
          f"fade-in launches per phase {got_first} then {got_again}, want "
          f"{want_first} then {want_again}")
    check(totals == [(sum(got_first), 0), (sum(got_again), 0)],
          f"PGGAN ladder runs launched (fade-in, power iteration) {totals}, want "
          f"{[(sum(got_first), 0), (sum(got_again), 0)]}")
    print(f"PGGAN ladder 4x4 -> 64x64 at full width, per-phase checkpoints: interrupted "
          f"after 1 step of the 64x64 transition (fade-in launches per phase "
          f"{got_first}), re-run resumed every phase (launches {got_again}: 6 per "
          f"transition step, 1 per transition sample grid), {pg_s:.1f} s for both runs")


def captured(module, name: str, sink: list) -> None:
    """Wrap ``module.name`` so each call appends its return value to
    ``sink`` (the data source a CLI builds inside its ``main``)."""
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        sink.append(out)
        return out

    setattr(module, name, wrapped)
    return inner


def last_sec_per_step(out_dir: str) -> float:
    """``sec_per_step`` of the last line of ``log.jsonl``: the wall time of
    the last ``LOG_EVERY`` steps, the metric read that ends them included."""
    with open(os.path.join(out_dir, "log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    check(all(math.isfinite(v) for rec in lines for v in rec.values()),
          f"non-finite metrics in {out_dir}/log.jsonl")
    return lines[-1]["sec_per_step"]


def write_cifar(path: str, seed: int = 0) -> None:
    """A synthetic ``cifar-10-batches-py`` at the real layout and size."""
    import numpy as np
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for name in CIFAR_FILES:
        with open(os.path.join(path, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (CIFAR_PER_FILE, 3072), "uint8"),
                         b"labels": rng.integers(0, 10, CIFAR_PER_FILE).tolist()}, f)


def calibrated_inception_npz(path: str, images) -> None:
    """Write the port's random-init InceptionV3 in the npz layout the
    reference's converter writes, its stored BN statistics set to the batch
    statistics of ``images`` (so the stored-statistics extractor a graded
    run loads normalizes as the random-init one does)."""
    import torch
    from gan_lib_tensorflow_tpu_torch.eval.inception_v3 import (BasicConv, InceptionV3Features,
                                                                save_params_npz)
    net = InceptionV3Features(seed=0, device="cuda")  # batch statistics
    convs = [m for m in net.model.modules() if isinstance(m, BasicConv)]
    stats = {}
    hooks = [m.conv.register_forward_hook(
        lambda mod, inp, out, m=m: stats.__setitem__(
            m, (out.mean(dim=(0, 2, 3)), out.var(dim=(0, 2, 3), unbiased=False))))
        for m in convs]
    net(images)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        for m in convs:
            m.moving_mean.copy_(stats[m][0])
            m.moving_variance.copy_(stats[m][1])
    save_params_npz(path, net.model)


def data_layer_and_north_star(card: str, tmp: str) -> None:
    """Phase 10, in the temporary directory ``tmp``."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch import data
    from gan_lib_tensorflow_tpu_torch.cli import common, north_star, train_sngan
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    from gan_lib_tensorflow_tpu_torch.train.loop import device_batches

    cifar = os.path.join(tmp, "cifar-10-batches-py")
    t0 = time.perf_counter()
    write_cifar(cifar)
    host = data.Cifar10(data_dir=cifar)
    check(host.images.shape == (50_000, 32, 32, 3), f"CIFAR store {host.images.shape}")
    print(f"synthetic CIFAR-10 at the real layout: {len(CIFAR_FILES)} pickles of "
          f"{CIFAR_PER_FILE} images, written and read in {time.perf_counter() - t0:.2f} s")

    # (a) the full-width SNGAN step on the store held on the card
    sources = []
    inner = captured(common, "image_source", sources)
    run = os.path.join(tmp, "sngan_cifar")
    sn_args = ["--data", cifar, "--device", "cuda", "--batch-size", str(BATCH),
               "--n-critic", str(N_CRITIC), "--compute-dtype", "bf16",
               "--log-every", str(LOG_EVERY), "--sample-every", "1000", "--ckpt-every", "1000"]
    try:
        pi.launches = 0  # count this path's launches only
        state = train_sngan.main(sn_args + ["--steps", str(CIFAR_STEPS), "--out-dir", run])
        torch.cuda.synchronize()
        launches = pi.launches
    finally:
        common.image_source = inner
    src = sources[0]
    check(isinstance(src, data.DeviceCachedStore), f"--data <dir> gave {type(src).__name__}")
    resident = src.nbytes_resident()
    check(resident >= 153_600_000, f"{resident} bytes resident, want the whole store")
    check(state.step == CIFAR_STEPS and launches == (N_CRITIC + 1) * CIFAR_STEPS,
          f"power-iteration launches {launches} in {state.step} steps, want 6 per step")
    sps = last_sec_per_step(run)
    idx = src.indices_for(5)
    dev = src.gather(idx)
    want = data.normalize_u8(torch.from_numpy(host.images[idx]))
    check(torch.equal(dev["image"].cpu(), want)
          and np.array_equal(dev["image"].cpu().numpy(),
                             data.base.normalize_u8_np(host.images[idx]))
          and np.array_equal(dev["label"].cpu().numpy(), host.labels[idx]),
          "a device batch differs from the host gather of the same indices")
    print(f"SNGAN on CIFAR-10 held on the card: {resident} bytes resident, "
          f"{1e3 * sps:.2f} ms/step over steps {CIFAR_STEPS - LOG_EVERY + 1}-{CIFAR_STEPS} "
          f"({N_CRITIC * BATCH / sps:.1f} images/s), power-iteration launches {launches} in "
          f"{CIFAR_STEPS} steps; step 5's batch [{N_CRITIC}, {BATCH}, 32, 32, 3] gathered and "
          f"normalized on the card equals the host gather bit for bit  [{card}]")

    # (b) streamed: uint8 from one host worker, normalized on the card
    args = train_sngan.parse_args(sn_args + ["--device-cache", "off"])
    streamed = common.image_source(args, BATCH, 32, 10, n_micro=N_CRITIC)
    check(isinstance(streamed, data.ThreadedSource), "--device-cache off did not stream")
    first = next(device_batches(streamed, N_CRITIC, torch.device("cuda")))
    worker = iter(data.Cifar10(batch_size=BATCH, data_dir=cifar, seed=args.seed + 1000003))
    for i in range(N_CRITIC):
        b = next(worker)
        check(torch.equal(first["image"][i].cpu(), data.normalize_u8(torch.from_numpy(b["image"])))
              and np.array_equal(first["label"][i].cpu().numpy(), b["label"]),
              f"streamed microbatch {i} differs from the host stream")
    pi.launches = 0
    t0 = time.perf_counter()
    state = train_sngan.main(sn_args + ["--device-cache", "off", "--steps", "2",
                                        "--out-dir", os.path.join(tmp, "sngan_streamed")])
    torch.cuda.synchronize()
    check(state.step == 2 and pi.launches == 2 * (N_CRITIC + 1),
          f"streamed run: {pi.launches} launches in 2 steps")
    print(f"--device-cache off: the first stack through prefetch_to_device equals the "
          f"host worker's uint8 batches normalized on the CPU, bit for bit; 2 steps "
          f"trained ({time.perf_counter() - t0:.2f} s with the build), {pi.launches} launches")
    del state, src, sources

    # (c) the north star on that directory, graded with a random extractor
    npz = os.path.join(tmp, "inception_v3.npz")
    calibrated_inception_npz(npz, data.normalize_u8(torch.from_numpy(host.images[:64])).cuda())
    out = os.path.join(tmp, "north_star")
    t0 = time.perf_counter()
    rc = north_star.main(["--data-dir", tmp, "--inception-weights", npz, "--out-dir", out,
                          "--steps", "4", "--n-samples", "1000", "--n-real", "1000",
                          "--device", "cuda"])
    ns_s = time.perf_counter() - t0
    with open(os.path.join(out, "north_star_result.json")) as f:
        rec = json.load(f)
    check(rc in (0, 1) and rec["graded"] is True and rec["verdict"] in ("PASS", "FAIL")
          and math.isfinite(rec["fid"]) and rec["step"] == 4
          and rec["extractor"] == "inception_v3_pretrained"
          and os.path.abspath(rec["real_source"]) == os.path.abspath(cifar),
          f"north star rc {rc}, record {rec}")
    print(f"north_star: rc {rc}, verdict {rec['verdict']} (graded {rec['graded']}), FID "
          f"{rec['fid']!r}, IS {rec['inception_score']!r}, 4 steps, 1000 samples and 1000 "
          f"reals, {ns_s:.1f} s  [{card}]")


def imagenet128(card: str, tmp: str) -> None:
    """Phase 11, in the temporary directory ``tmp``."""
    import numpy as np
    import torch
    from gan_lib_tensorflow_tpu_torch.cli import train_sngan_imagenet
    from gan_lib_tensorflow_tpu_torch.data.packed import finalize_store, write_store
    from gan_lib_tensorflow_tpu_torch.models import sngan
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi

    store = os.path.join(tmp, "imagenet128")
    t0 = time.perf_counter()
    images, labels = write_store(store, IMAGENET_STORE, 128, 128, 3,
                                 classes=[str(c) for c in range(1000)])
    rng = np.random.default_rng(1)
    images[:] = rng.integers(0, 256, images.shape, np.uint8)
    labels[:] = rng.integers(0, 1000, IMAGENET_STORE)
    finalize_store(store, images, labels)
    del images
    print(f"packed store: {IMAGENET_STORE} images of 128x128x3 with 1000-class labels "
          f"({IMAGENET_STORE * 128 * 128 * 3} bytes), written in {time.perf_counter() - t0:.2f} s")

    run = os.path.join(tmp, "imagenet_run")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pi.launches = 0  # count this path's launches only
    t0 = time.perf_counter()
    state = train_sngan_imagenet.main([
        "--data", store, "--device", "cuda", "--steps", str(IMAGENET_STEPS),
        "--log-every", str(LOG_EVERY), "--sample-every", "1000", "--ckpt-every", "1000",
        "--compute-dtype", "bf16", "--out-dir", run])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = pi.launches
    peak = torch.cuda.max_memory_allocated()
    check(state.step == IMAGENET_STEPS and launches == (N_CRITIC + 1) * IMAGENET_STEPS,
          f"power-iteration launches {launches} in {state.step} steps, want 6 per step")
    d = state.d
    dims = [(m.weight[0].numel(), m.weight.shape[0]) for m in d.sn_layers]
    check(len(dims) == 19, f"{len(dims)} SN weights in the ImageNet-128 D")
    plan = pi.plan_power_iteration(dims)  # what D's table was built from
    streamed = sorted({c.weight for c in plan.ctas if c.stream})
    names = [n for n, m in d.named_modules() if m in d.sn_layers]
    sps = last_sec_per_step(run)
    print(f"SNGAN-projection ImageNet-128, full width, 1000 classes, batch {BATCH}, n_critic "
          f"{N_CRITIC}, bf16, from the store held on the card: images/s/GPU "
          f"{N_CRITIC * BATCH / sps:.1f}  ms/step {1e3 * sps:.2f} (steps "
          f"{IMAGENET_STEPS - LOG_EVERY + 1}-{IMAGENET_STEPS})  peak memory "
          f"{peak / 2**20:.0f} MiB  kernel launches {launches} in {IMAGENET_STEPS} steps; "
          f"{run_s:.1f} s for the run with its build  [{card}]")
    print(f"power-iteration plan of D's 19 weights: {len(plan.ctas)} CTAs, "
          f"{plan.smem_bytes} B of shared memory per CTA; streamed from device memory: "
          + ", ".join(f"{names[i]} {list(dims[i])}" for i in streamed))

    # the kernel at D's 19 weights against its plain version
    err = compare_kernel(pi, torch, dims, 4)
    print(f"batched_power_iteration at the ImageNet-128 D's 19 weights "
          f"({sum(m * k for m, k in dims)} values): sigma/u'/v/grad agree with the plain "
          f"version (rtol 1e-4, TF32 off), max abs err {err:.3e}")

    # full-width float32 G and D, card vs CPU, batch 2
    g32 = sngan.imagenet128_generator()
    d32 = sngan.imagenet128_discriminator()
    g32.load_state_dict(state.g.state_dict())
    d32.load_state_dict(d.state_dict())
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(2, 128, generator=gen)
    lab = torch.tensor([3, 997])
    with torch.no_grad():
        imgs_cpu = g32(z, lab, train=False)
        logits_cpu = d32(imgs_cpu, lab)
        imgs = g32.cuda()(z.cuda(), lab.cuda(), train=False)
        logits = d32.cuda()(imgs, lab.cuda())
    check(tuple(imgs.shape) == (2, 128, 128, 3) and bool(torch.isfinite(imgs).all())
          and bool(torch.isfinite(logits).all()), "ImageNet-128 G/D output not finite")
    torch.testing.assert_close(imgs.cpu(), imgs_cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-3, atol=1e-3)
    print(f"float32 ImageNet-128 G and D at full width on the card agree with the CPU "
          f"(rtol 1e-3, atol 1e-3): max abs err images "
          f"{float((imgs.cpu() - imgs_cpu).abs().max()):.3e}, logits "
          f"{float((logits.cpu() - logits_cpu).abs().max()):.3e}")
    del g32, d32, state

    # the 19-weight launch by device time
    ws = [m.weight.detach() for m in d.sn_layers]
    us = [m.u.detach().clone() for m in d.sn_layers]
    table = pi.PowerIterationTable()
    t = timed_in_turns({"kernel": lambda: pi.launch(ws, us, table=table),
                        "plain": lambda: pi.plain_power_iteration(ws, us)}, 50)
    floor_ms = device_ms(lambda: pi.launch_empty(table), 200)
    ms_, ks = [m for m, _ in dims], [k for _, k in dims]
    n_bytes = 4 * (sum(m * k for m, k in dims) + sum(ks) + len(ws) + sum(ks) + sum(ms_))
    n_flops = sum(4 * m * k for m, k in dims)
    bound_ms = 1e3 * max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS)
    print(f"batched_power_iteration, ImageNet-128 D (19 weights): kernel "
          f"{1e3 * t['kernel']:.2f} us, plain {1e3 * t['plain']:.2f} us, empty-kernel floor "
          f"{1e3 * floor_ms:.2f} us, bound {1e3 * bound_ms:.2f} us (bytes: {n_bytes} B at "
          f"3.35 TB/s; {n_flops} flop), {n_bytes / t['kernel'] / 1e9:.3f} TB/s, "
          f"{bound_ms / t['kernel']:.3f} of the bound; {N_CRITIC + 1} launches per step "
          f"{(N_CRITIC + 1) * 1e3 * t['kernel']:.1f} us of {1e3 * sps:.2f} ms  [{card}]")
    # where the launch's time goes: the streamed weights, the others, and the
    # largest weight alone (one cluster of 8 CTAs), each as its own launch
    largest = max(range(len(dims)), key=lambda i: dims[i][0] * dims[i][1])
    for label, sel in (("streamed", streamed),
                       ("slab in shared memory", [i for i in range(len(dims)) if i not in streamed]),
                       (f"largest alone ({names[largest]})", [largest])):
        if not sel:
            continue
        sub_w, sub_u, sub_t = [ws[i] for i in sel], [us[i] for i in sel], pi.PowerIterationTable()
        sub_ms = device_ms(lambda: pi.launch(sub_w, sub_u, table=sub_t), 50)
        w_bytes = 4 * sum(dims[i][0] * dims[i][1] for i in sel)
        print(f"  {label}: {len(sel)} weights, {w_bytes} B of W, {1e3 * sub_ms:.2f} us, "
              f"{w_bytes / sub_ms / 1e9:.3f} TB/s of W read once  [{card}]")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gan_lib_tensorflow_tpu_torch.cli import common, train_pggan, train_sngan
        from gan_lib_tensorflow_tpu_torch.models import pggan, sngan
        from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
        from gan_lib_tensorflow_tpu_torch.ops import init_weights
        from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
        from gan_lib_tensorflow_tpu_torch.train import (LoopConfig,
                                                        make_train_step,
                                                        train_loop)
        from gan_lib_tensorflow_tpu_torch.train.pggan_loop import (build_phase,
                                                                   train_pggan_ladder)
    except ImportError as e:
        raise SystemExit("chip_smoke FAILED: run it from the repository root "
                         f"(the port's package is missing: {e})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"torch device: {kind} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("allow_tf32: matmul False, cudnn False")
    print(f"nvidia-smi: {smi.splitlines()[0]}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    libraries = [pi.library, fd.library]
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.load) for lib in libraries]:
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"kernels build+load (parallel nvcc): {build_s:.2f} s")
    for lib in libraries:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib.name}:", line.strip())

    phase("3 power-iteration kernel vs plain")
    before = pi.launches
    err = max(compare_kernel(pi, torch, CIFAR_D_SHAPES, 0),
              compare_kernel(pi, torch, PALLAS_SHAPES, 1),
              compare_kernel(pi, torch, IMAGENET_WIDE_SHAPES, 2))
    check(pi.launches > before, "launch counter did not advance")
    g = torch.Generator(device="cuda").manual_seed(3)
    ws = [torch.randn(k, m, device="cuda", generator=g) for m, k in CIFAR_D_SHAPES]
    us = [torch.randn(1, k, device="cuda", generator=g) for _, k in CIFAR_D_SHAPES]
    first, second = pi.launch(ws, us), pi.launch(ws, us)
    check(all(torch.equal(x, y) for x, y in zip(first, second)),
          "two launches on the same inputs differ")
    print(f"batched_power_iteration: sigma/u'/v/grad agree at the CIFAR-D, test_pallas.py "
          f"and ImageNet-128 wide shapes, max abs err {err:.3e}; two launches bit-identical")

    phase("4 fade-in kernel vs plain")
    fade_err = compare_fadein(fd, torch)
    # either side of a whole number of blocks, aligned and off a 16-byte boundary
    per_block = FADEIN_BLOCK_ELEMS
    for n in (per_block - 1, per_block + 1, 3 * per_block - 1, 3 * per_block + 1, 5):
        for offset in range(4):
            a = torch.randn(n + offset, device="cuda")[offset:]
            b = torch.randn(n + offset, device="cuda")[offset:]
            check(torch.equal(fd.fadein_blend(a, b, 0.37), fd.plain_fadein_blend(a, b, 0.37)),
                  f"fade-in differs from its plain version at n {n}, offset {offset}")
    print(f"fadein_blend: outputs, gradients and double backward agree "
          f"(rtol 1e-5, atol 1e-6), max abs err {fade_err:.3e}; bit-equal at sizes around "
          f"the {per_block}-element block, aligned and unaligned")

    phase("5 SNGAN main path: fused CIFAR-10 step")
    args = train_sngan.parse_args([
        "--data", "fake", "--device", "cuda", "--batch-size", str(BATCH),
        "--n-critic", str(N_CRITIC), "--ema-decay", "0.9999",
        "--compute-dtype", "bf16", "--steps", str(WARM_STEPS + TIMED_STEPS)])
    g, d, spec, state = train_sngan.build(args)
    source = common.image_source(args, BATCH, 32, 10, n_micro=spec.n_critic)
    step_fn = make_train_step(spec)
    logs = []
    log_fn = lambda it, m: logs.append((it, m))
    pi.launches = 0  # count this path's launches only
    train_loop(state, step_fn, source, LoopConfig(WARM_STEPS, WARM_STEPS), log_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_loop(state, step_fn, source,
               LoopConfig(WARM_STEPS + TIMED_STEPS, TIMED_STEPS), log_fn)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    main_launches = pi.launches
    n_steps = WARM_STEPS + TIMED_STEPS
    check(main_launches == 6 * n_steps,
          f"kernel launched {main_launches} times in {n_steps} steps, want 6 per step")
    ips = N_CRITIC * BATCH * TIMED_STEPS / dt
    print(f"metrics: {logs}")
    print(f"images/s/GPU: {ips:.1f}  ms/step: {1e3 * dt / TIMED_STEPS:.2f}  "
          f"peak memory: {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  "
          f"kernel launches: {main_launches} in {n_steps} steps  [{smi.splitlines()[0]}]")

    # the trained networks in float32 on the card vs on the CPU (plain SN)
    d32, g32 = sngan.cifar_discriminator(), sngan.cifar_generator()
    d32.load_state_dict(d.state_dict())
    g32.load_state_dict(g.state_dict())
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(4, 128, generator=gen)
    with torch.no_grad():
        imgs = g32.cuda()(z.cuda(), train=False)
        imgs_cpu = copy.deepcopy(g32).cpu()(z, train=False)
        check(tuple(imgs.shape) == (4, 32, 32, 3) and bool(torch.isfinite(imgs).all()),
              f"generator output {tuple(imgs.shape)} not finite")
        torch.testing.assert_close(imgs.cpu(), imgs_cpu, rtol=1e-3, atol=1e-3)
        logits = d32.cuda()(imgs)
        logits_cpu = copy.deepcopy(d32).cpu()(imgs_cpu)
        torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-3, atol=1e-3)
    print("float32 G and D on the card agree with the CPU (rtol 1e-3, atol 1e-3)")

    phase("6 PGGAN main path: ladder 4x4 -> 1024x1024")
    pg_args = train_pggan.parse_args([
        "--data", "fake", "--device", "cuda", "--final-resolution", "1024",
        "--steps-per-phase", str(PGGAN_STEPS_PER_PHASE), "--log-every", "1",
        "--compute-dtype", "bf16"])
    cfg = train_pggan.ladder_config(pg_args)
    cfg.out_dir = None  # no checkpoints or sample grids here: phase 9 drives those
    per_phase, pg_logs, carried = [], [], {}
    last = {}

    def phase_hook(when, res, name, st):
        if when == "start":
            if last:  # every tensor shared with the phase before, bit-exact
                now = snapshot(st)
                shared = [k for k in last if k in now and now[k].shape == last[k].shape]
                check(shared and all(torch.equal(last[k], now[k]) for k in shared),
                      f"trunk not carried bit-exact into {res}x{res} {name}")
                carried[(res, name)] = len(shared)
            last.clear()
            per_phase.append([res, name, fd.launches, pi.launches, time.perf_counter()])
        else:
            torch.cuda.synchronize()
            rec = per_phase[-1]
            rec[2], rec[3] = fd.launches - rec[2], pi.launches - rec[3]
            rec[4] = time.perf_counter() - rec[4]
            rec.append(pg_logs[-1])
            last.update(snapshot(st))

    fd.launches = 0  # count this path's launches only
    pi.launches = 0
    t0 = time.perf_counter()
    pg_state = train_pggan_ladder(cfg, train_pggan.source_factory(pg_args),
                                  phase_hook=phase_hook,
                                  log_fn=lambda it, m: pg_logs.append(m))
    torch.cuda.synchronize()
    ladder_s = time.perf_counter() - t0
    ladder_launches = fd.launches
    last.clear()
    n_trans = sum(1 for r in per_phase if r[1] == "transition")
    for res, name, n_fd, n_pi, secs, metrics in per_phase:
        want = 6 * PGGAN_STEPS_PER_PHASE if name == "transition" else 0
        print(f"  {res:4d}x{res:<4d} {name:10s} fade-in launches {n_fd:2d} (want {want}), "
              f"{secs:.2f} s, tensors carried {carried.get((res, name), 0)}, "
              + " ".join(f"{k} {v:.4g}" for k, v in metrics.items()))
        check(n_fd == want and n_pi == 0,
              f"{res}x{res} {name}: {n_fd} fade-in launches, want {want}")
    check(len(per_phase) == 17 and n_trans == 8, f"{len(per_phase)} phases, want 17")
    check(len(carried) == 16, "a migration was not checked")
    check(ladder_launches == 6 * PGGAN_STEPS_PER_PHASE * n_trans,
          f"{ladder_launches} fade-in launches in the ladder")
    check(len(pg_logs) == 17 * PGGAN_STEPS_PER_PHASE and all(
        math.isfinite(v) for m in pg_logs for v in m.values()), "non-finite ladder metrics")
    check(pg_state.step == PGGAN_STEPS_PER_PHASE and pg_state.alpha == 1.0,
          "ladder did not end in the 1024x1024 stabilize phase")
    print(f"ladder: {len(per_phase)} phases in {ladder_s:.1f} s, fade-in launches "
          f"{ladder_launches} ({n_trans} transitions x {PGGAN_STEPS_PER_PHASE} steps x 6)")
    del pg_state

    phase("7 PGGAN 1024x1024 transition phase, batch 4")
    ph = build_phase(cfg, 1024, "transition")
    pg_source = iter(train_pggan.source_factory(pg_args)(1024, ph.batch))
    pg_step = make_train_step(ph.spec)
    for i in range(PGGAN_WARM):
        ph.state.alpha = ph.alpha_fn(i)
        pg_step(ph.state, next(pg_source))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(PGGAN_WARM, PGGAN_WARM + PGGAN_TIMED):
        ph.state.alpha = ph.alpha_fn(i)
        pg_metrics = pg_step(ph.state, next(pg_source))
    torch.cuda.synchronize()
    pg_dt = (time.perf_counter() - t0) / PGGAN_TIMED
    check(all(math.isfinite(float(v)) for v in pg_metrics.values()), "non-finite 1024 metrics")
    print(f"PGGAN 1024x1024 transition batch {ph.batch}: images/s/GPU "
          f"{ph.batch / pg_dt:.2f}  ms/step: {1e3 * pg_dt:.2f}  peak memory: "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB  "
          f"[{smi.splitlines()[0]}]")
    del ph, pg_step, pg_source

    # full-width float32 G and D of the 64x64 transition stage, card vs CPU
    g64 = pggan.PGGANGenerator(resolution=64, fade_in=True)
    d64 = pggan.PGGANDiscriminator(resolution=64, fade_in=True, fused_from=128)
    gen = torch.Generator().manual_seed(3)
    for net in (g64, d64):
        init_weights(net, gen)
    z = torch.randn(4, 512, generator=gen)
    with torch.no_grad():
        imgs_cpu = g64(z, 0.37)
        logits_cpu = d64(imgs_cpu, 0.37)
        before = fd.launches
        imgs = g64.cuda()(z.cuda(), 0.37)
        logits = d64.cuda()(imgs, 0.37)
    check(fd.launches == before + 2, "the 64x64 stage did not launch the fade-in kernel")
    check(tuple(imgs.shape) == (4, 64, 64, 3) and bool(torch.isfinite(imgs).all()),
          f"PGGAN generator output {tuple(imgs.shape)} not finite")
    torch.testing.assert_close(imgs.cpu(), imgs_cpu, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-3, atol=1e-3)
    print("float32 PGGAN 64x64 transition G and D on the card agree with the CPU "
          "(rtol 1e-3, atol 1e-3)")
    del g64, d64

    phase("8 kernel timing at the main paths' shapes")
    clocks = "clocks.sm,clocks.mem,power.limit"
    print(f"nvidia-smi {clocks} before: {nvidia_smi(clocks)}", flush=True)
    card = smi.splitlines()[0]
    ws = [m.weight.detach() for m in d.sn_layers]
    us = [m.u.detach().clone() for m in d.sn_layers]
    table = pi.PowerIterationTable()
    pi_times = timed_in_turns({
        "kernel": lambda: pi.launch(ws, us, table=table),
        "plain": lambda: pi.plain_power_iteration(ws, us)}, 200)
    kernel_ms, plain_ms = pi_times["kernel"], pi_times["plain"]
    # an empty kernel with the same grid, cluster and shared memory: the floor
    # of the clustered launch (the first kernel's package, which A/B runs
    # time with this script, has no such path)
    floor = (f"{1e3 * device_ms(lambda: pi.launch_empty(table), 200):.2f} us"
             if hasattr(pi, "launch_empty") else "not in this package")
    pi_host = host_us(lambda: pi.launch(ws, us, table=table), 500)
    ms_, ks = [w[0].numel() for w in ws], [w.shape[0] for w in ws]
    n_bytes = 4 * (sum(m * k for m, k in zip(ms_, ks))      # W
                   + sum(ks) + len(ws) + sum(ks) + sum(ms_))  # u in; sigma, u', v out
    n_flops = sum(4 * m * k for m, k in zip(ms_, ks))
    bound_ms = 1e3 * max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS)
    bound_by = "bytes" if n_bytes / PEAK_BYTES_PER_S >= n_flops / PEAK_FP32_FLOPS else "operations"
    print(f"batched_power_iteration: kernel {1e3 * kernel_ms:.2f} us, plain "
          f"{1e3 * plain_ms:.2f} us, empty-kernel floor {floor}, bound "
          f"{1e3 * bound_ms:.3f} us ({bound_by}: {n_bytes} B, {n_flops} flop), "
          f"library_ms: none, host {pi_host:.1f} us per wrapper call  [{card}]")

    # fade-in: the step's two blends; the bound counts a and b read once and
    # out written once, 12 bytes per element; 3 flops per element are far
    # below the fp32 rate
    cl = torch.channels_last
    fade = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for shape in FADEIN_MAIN_SHAPES:
        a = torch.randn(shape, device="cuda").contiguous(memory_format=cl)
        b = torch.randn(shape, device="cuda").contiguous(memory_format=cl)
        n = a.numel()
        t = timed_in_turns({"kernel": lambda: fd.launch(a, b, 0.37),
                            "lerp": lambda: torch.lerp(b, a, 0.37),
                            "plain": lambda: fd.plain_fadein_blend(a, b, 0.37)}, 20)
        k_ms, p_ms, l_ms = t["kernel"], t["plain"], t["lerp"]
        f_host = host_us(lambda: fd.launch(a, b, 0.37), 100)
        n_bytes, n_flops = 12 * n, 3 * n
        b_ms = 1e3 * max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS)
        print(f"fadein_blend {list(shape)} channels-last: kernel {1e3 * k_ms:.2f} us, plain "
              f"{1e3 * p_ms:.2f} us, torch.lerp {1e3 * l_ms:.2f} us, bound "
              f"{1e3 * b_ms:.2f} us (bytes: {n_bytes} B, {n_flops} flop), "
              f"{n_bytes / k_ms / 1e9:.3f} TB/s, host {f_host:.1f} us per wrapper call  [{card}]")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                       ("bound_ms", b_ms)):
            fade[key] += v / len(FADEIN_MAIN_SHAPES)
        del a, b
    print(f"fadein_blend: one 1024x1024 transition step launches it 6 times "
          f"(G 2 at {list(FADEIN_MAIN_SHAPES[0])}, D 4 at {list(FADEIN_MAIN_SHAPES[1])}); "
          f"the JSON line gives the mean of one launch at each shape")
    print(f"nvidia-smi {clocks} after: {nvidia_smi(clocks)}", flush=True)

    phase("9 checkpoint, resume, sample, eval on the card")
    t9 = time.perf_counter()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        checkpoint_resume_eval(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.backends.cudnn.deterministic = False
    print(f"phase 9: {time.perf_counter() - t9:.1f} s  [{card}]")

    phase("10 data layer and north star: CIFAR-10 held on the card")
    t10 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data_layer_and_north_star(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s  [{card}]")

    phase("11 SNGAN-projection ImageNet-128 at full width")
    t11 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        imagenet128(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s  [{card}]")

    print(json.dumps({"kernels": [{
        "name": "batched_power_iteration",
        "route": "cuda",
        "source": "gan_lib_tensorflow_tpu_torch/csrc/power_iteration.cu",
        "replaces": "gan_lib_tensorflow_tpu/ops/pallas_kernels.py:63",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "fadein_blend",
        "route": "cuda",
        "source": "gan_lib_tensorflow_tpu_torch/csrc/fadein_blend.cu",
        "replaces": "gan_lib_tensorflow_tpu/ops/pallas_kernels.py:122",
        "launches": ladder_launches,
        "max_abs_err": fade_err,
        "ms": fade["ms"],
        "plain_ms": fade["plain_ms"],
        "bound_ms": fade["bound_ms"],
        "bound_by": "bytes",
        "library_ms": fade["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
