#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
final line):
  1. device: torch's name for the card, and nvidia-smi's name and power limit
  2. build: compile the hand-written kernel (nvcc, sm_90a) from csrc/
  3. kernel vs plain: the batched power-iteration kernel against its plain
     PyTorch version on the card (sigma, u', v and d sigma / dW; rtol 1e-4,
     float32 with TF32 off), at the CIFAR-D and tests/test_pallas.py shapes
  4. main path: the fused SNGAN CIFAR-10 train step at full width (batch 64,
     n_critic 5, bf16 compute, EMA 0.9999, on-device fake data) through the
     port's CLI ``build`` and ``train_loop``; images/s, ms/step, peak memory;
     the kernel must launch 6 times per step (5 critic D forwards + 1 in the
     G loss); then D and G forwards in float32 on the card against the CPU
  5. kernel timing at the main path's shapes (CUDA events): kernel, plain
     version and the bound of the work on this card

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores. The kernel's work is fp32 matrix-vector.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

WARM_STEPS, TIMED_STEPS = 3, 20
N_CRITIC, BATCH = 5, 64

# [fan_in, out] of the 11 CIFAR-D spectral-norm weights, and of test_pallas.py
CIFAR_D_SHAPES = ([(27, 128), (1152, 128), (3, 128), (1152, 128), (1152, 128),
                   (128, 128)] + [(1152, 128)] * 4 + [(128, 1)])
PALLAS_SHAPES = [(1152, 128), (27, 64), (128, 1), (9, 256)]


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` calls, by CUDA
    events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gan_lib_tensorflow_tpu_torch.cli import common, train_sngan
        from gan_lib_tensorflow_tpu_torch.models import sngan
        from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
        from gan_lib_tensorflow_tpu_torch.train import (LoopConfig,
                                                        make_train_step,
                                                        train_loop)
    except ImportError as e:
        raise SystemExit("chip_smoke FAILED: run it from the repository root "
                         f"(the port's package is missing: {e})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"torch device: {kind} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("allow_tf32: matmul False, cudnn False")
    print(f"nvidia-smi: {smi.splitlines()[0]}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    pi.load_library()
    build_s = time.perf_counter() - t0
    print(f"kernel build+load: {build_s:.2f} s")
    for line in pi.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    phase("3 kernel vs plain")
    before = pi.launches
    err = max(compare_kernel(pi, torch, CIFAR_D_SHAPES, 0),
              compare_kernel(pi, torch, PALLAS_SHAPES, 1))
    check(pi.launches > before, "launch counter did not advance")
    print(f"batched_power_iteration: sigma/u'/v/grad agree, max abs err {err:.3e}")

    phase("4 fused SNGAN CIFAR-10 step")
    args = train_sngan.parse_args([
        "--data", "fake", "--device", "cuda", "--batch-size", str(BATCH),
        "--n-critic", str(N_CRITIC), "--ema-decay", "0.9999",
        "--compute-dtype", "bf16", "--steps", str(WARM_STEPS + TIMED_STEPS)])
    g, d, spec, state = train_sngan.build(args)
    source = common.image_source(args, BATCH, 32, 10, n_micro=spec.n_critic)
    step_fn = make_train_step(spec)
    logs = []
    log_fn = lambda it, m: logs.append((it, m))
    pi.launches = 0  # count the main path's launches only
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

    phase("5 kernel timing at the main path's shapes")
    ws = [m.weight.detach() for m in d.sn_layers]
    us = [m.u.detach().clone() for m in d.sn_layers]
    table = pi.PowerIterationTable()
    kernel_ms = cuda_ms(lambda: pi.launch(ws, us, table=table), 200)
    plain_ms = cuda_ms(lambda: pi.plain_power_iteration(ws, us), 20)
    ms_, ks = [w[0].numel() for w in ws], [w.shape[0] for w in ws]
    n_bytes = 4 * (sum(m * k for m, k in zip(ms_, ks))      # W
                   + sum(ks) + len(ws) + sum(ks) + sum(ms_))  # u in; sigma, u', v out
    n_flops = sum(4 * m * k for m, k in zip(ms_, ks))
    bound_ms = 1e3 * max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOPS)
    bound_by = "bytes" if n_bytes / PEAK_BYTES_PER_S >= n_flops / PEAK_FP32_FLOPS else "operations"
    print(f"batched_power_iteration: kernel {1e3 * kernel_ms:.2f} us, plain "
          f"{1e3 * plain_ms:.2f} us, bound {1e3 * bound_ms:.3f} us ({bound_by}: "
          f"{n_bytes} B, {n_flops} flop), library_ms: none  [{smi.splitlines()[0]}]")

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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
