"""Environment doctor for the CUDA card (the port's counterpart of
``tools/doctor.py``): what the port needs, probed with hard timeouts.

Every probe runs in a subprocess of its own (this file run as a script,
``--probe NAME``), killed with everything it started when its time is up,
so the doctor always returns; the probes run side by side, and one JSON
report is printed:

  python -m gan_lib_tensorflow_tpu_torch.tools.doctor            # full report
  python -m gan_lib_tensorflow_tpu_torch.tools.doctor --quick    # no compute probes

Probes: ``versions`` (torch, its CUDA, numpy, scipy, triton);
``device_enumeration`` (count, name and compute capability: the kernels need
9.0); ``power`` (nvidia-smi's name and power limit); ``device_compute`` (a
256x256 matmul round trip); ``toolchain`` (``nvcc`` and the host C++
compiler, found as ``ops/cuda_lib.py`` finds them); ``kernel_build`` (both
``csrc/*.cu`` built for sm_90a through ``ops/cuda_lib.py``: a build cut by
the timeout leaves a ``.tmp``, never a library the next load takes);
``kernel_launch`` (one launch of ``batched_power_iteration`` and one of
``fadein_blend`` against their plain versions, at ``chip_smoke.py`` phases
3-4's tolerances); ``host_libs`` (the image decoders ``imgcodec`` and
``webpdec`` built and loaded); ``cpu_ranks`` (a 2-rank gloo group through
``dryrun.launch`` that all-reduces one tensor); ``north_star_assets``
(CIFAR-10 and InceptionV3 weights for the graded north-star run).
``--quick`` skips ``device_compute`` and ``kernel_launch``.

A missing piece (no card, no ``nvcc``) is reported, never raised. The exit
code is 0 only when the card is healthy: enumerated at capability 9.0, both
kernels built (and, without ``--quick``, computing and launching within
tolerance). The verdict says whether the card is healthy, present but
unusable (naming the failed probes), or absent (a CPU-only environment).

This file imports only the standard library at the top, so the probes that
need no torch (``power``, ``toolchain``, ``kernel_build``, ``host_libs``,
``north_star_assets``) start in a fraction of a second.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import time

DOCTOR = os.path.abspath(__file__)
PKG = os.path.dirname(os.path.dirname(DOCTOR))
REPO = os.path.dirname(PKG)
PROBES = ("versions", "device_enumeration", "power", "device_compute", "toolchain",
          "kernel_build", "kernel_launch", "host_libs", "cpu_ranks", "north_star_assets")
COMPUTE_PROBES = ("device_compute", "kernel_launch")
KERNELS = ("power_iteration", "fadein_blend")
HOST_LIBS = ("imgcodec", "webpdec")
# chip_smoke.py phases 3-4
PI_SHAPES = [(1152, 128), (27, 64), (128, 1), (9, 256)]  # (m, k) of W [k, m]
FADEIN_SHAPE = (4, 32, 64, 64)


def _sub(argv: list, timeout: float) -> dict:
    """Run ``python argv...`` with the repo on ``PYTHONPATH``, in a session of
    its own, killed with all it started after ``timeout`` seconds. Its last
    stdout line is its result (parsed when it is JSON)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *argv], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        return {"ok": False, "seconds": round(time.perf_counter() - t0, 2), "result": None,
                "error": f"timeout after {timeout:g}s"}
    finally:
        try:  # whatever the probe left running in its session
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    lines = out.strip().splitlines()
    result = lines[-1] if lines else ""
    try:
        result = json.loads(result)
    except ValueError:
        pass
    errors = err.strip().splitlines()
    return {"ok": proc.returncode == 0, "seconds": round(time.perf_counter() - t0, 2),
            "result": result,
            "error": errors[-1][:300] if proc.returncode and errors else None}


def probe(name: str, timeout: float) -> dict:
    """One probe in its own process (this file, ``--probe name``)."""
    return _sub([DOCTOR, "--probe", name, "--probe-timeout", str(timeout)], timeout)


# ---------------------------------------------------------------- the probes
# Each returns (ok, result); they run in the probe's process.

def _from_file(*path: str):
    """The port's module at ``path`` (under the package) loaded from its
    file: the package's ``__init__`` and its torch import are not run."""
    spec = importlib.util.spec_from_file_location(
        "doctor_" + os.path.splitext(path[-1])[0], os.path.join(PKG, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cuda_lib():
    """``ops/cuda_lib.py``: no torch, no package import."""
    return _from_file("ops", "cuda_lib.py")


def _first_line(text: str) -> str:
    lines = [s for s in str(text).strip().splitlines() if s.strip()]
    return lines[0] if lines else ""


def probe_versions(timeout):
    out = {"python": sys.version.split()[0]}
    for mod in ("torch", "numpy", "scipy", "triton"):
        try:
            out[mod] = getattr(importlib.import_module(mod), "__version__", "?")
        except Exception as e:  # a missing package is reported
            out[mod] = f"unimportable: {type(e).__name__}: {e}"
    if not out["torch"].startswith("unimportable"):
        import torch
        out["torch.version.cuda"] = torch.version.cuda
    ok = not any(out[m].startswith("unimportable") for m in ("torch", "numpy", "scipy"))
    return ok, out


def probe_device_enumeration(timeout):
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = [{"index": i, "name": torch.cuda.get_device_name(i),
                "capability": list(torch.cuda.get_device_capability(i))} for i in range(n)]
    out = {"count": n, "devices": devices, "kernels_need": [9, 0]}
    if not n:
        out.update(_no_card()[1])
    return bool(n) and all(d["capability"] == [9, 0] for d in devices), out


def probe_power(timeout):
    smi = shutil.which("nvidia-smi")
    if not smi:
        return False, {"nvidia_smi": "MISSING (not on PATH)"}
    proc = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode == 0 and bool(lines), {
        "nvidia_smi": smi, "line": lines[0] if lines else None, "lines": lines,
        "error": _first_line(proc.stderr) or None}


def _no_card():
    return False, {"card": "MISSING (torch.cuda.is_available() is False)"}


def probe_device_compute(timeout):
    import torch
    if not torch.cuda.is_available():
        return _no_card()
    x = torch.ones(256, 256, device="cuda")
    y = (x @ x).cpu()
    return bool((y == 256.0).all()), f"matmul ok {float(y[0, 0])}"


def probe_toolchain(timeout):
    cuda_lib = _cuda_lib()
    out, ok = {}, True
    for key, find in (("nvcc", cuda_lib._nvcc), ("cxx", lambda: cuda_lib._cxx("host sources"))):
        try:
            path = find()
        except RuntimeError as e:
            out[key], ok = f"MISSING ({e})", False
            continue
        proc = subprocess.run([path, "--version"], capture_output=True, text=True)
        lines = [s for s in proc.stdout.splitlines() if s.strip()]
        out[key] = path
        out[f"{key}_version"] = next((s for s in lines if "release" in s), _first_line(
            proc.stdout))
    return ok, out


def _build(names, suffix: str):
    cuda_lib = _cuda_lib()
    out, ok = {}, True
    for name in names:
        lib = cuda_lib.KernelLibrary(name, lambda lib: None, suffix=suffix)
        so = lib.path()
        rec = {"so": os.path.relpath(so, REPO), "cached": os.path.exists(so)}
        t0 = time.perf_counter()
        try:
            lib.load()
            rec["seconds"] = round(time.perf_counter() - t0, 2)
        except Exception as e:  # a failed build is reported
            rec["error"], ok = _first_line(e), False
        out[name] = rec
    return ok, out, cuda_lib


def probe_kernel_build(timeout):
    ok, out, cuda_lib = _build(KERNELS, ".cu")
    out["flags"] = " ".join(cuda_lib.NVCC_FLAGS)
    dump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in KERNELS:
        rec = out[name]
        if "error" in rec or not os.path.exists(dump):
            continue
        proc = subprocess.run([dump, "--list-elf", os.path.join(REPO, rec["so"])],
                              capture_output=True, text=True)
        rec["elf"] = [s.split()[-1] for s in proc.stdout.splitlines() if s.strip()]
        if not any("sm_90a" in e for e in rec["elf"]):
            rec["error"], ok = "no sm_90a code in the library", False
    return ok, out


def probe_kernel_launch(timeout):
    import torch

    from gan_lib_tensorflow_tpu_torch.ops import fadein as fd
    from gan_lib_tensorflow_tpu_torch.ops import power_iteration as pi
    if not torch.cuda.is_available():
        return _no_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    out, ok = {}, True
    g = torch.Generator(device="cuda").manual_seed(0)
    ws = [torch.randn(k, m, device="cuda", generator=g) for m, k in PI_SHAPES]
    us = [torch.randn(1, k, device="cuda", generator=g) for _, k in PI_SHAPES]
    pi.launches = fd.launches = 0
    sigma, u_out, v_out = pi.launch(ws, us)
    s_ref, u_ref, v_ref = pi.plain_power_iteration(ws, us)
    u_ref, v_ref = torch.cat(u_ref), torch.cat(v_ref)
    rec = {"launches": pi.launches, "shapes": PI_SHAPES,
           "tolerance": "sigma rtol 1e-4; u', v rtol 1e-4 atol 1e-5",
           "max_abs_err": max(float((a - b).abs().max()) for a, b in
                              ((sigma, s_ref), (u_out, u_ref), (v_out, v_ref)))}
    try:
        torch.testing.assert_close(sigma, s_ref.detach(), rtol=1e-4, atol=0.0)
        torch.testing.assert_close(u_out, u_ref, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(v_out, v_ref, rtol=1e-4, atol=1e-5)
    except AssertionError as e:
        rec["error"], ok = _first_line(e), False
    out["batched_power_iteration"] = rec
    a = torch.randn(FADEIN_SHAPE, device="cuda", generator=g).contiguous(
        memory_format=torch.channels_last)
    b = torch.randn(FADEIN_SHAPE, device="cuda", generator=g).contiguous(
        memory_format=torch.channels_last)
    blend, ref = fd.launch(a, b, 0.37), fd.plain_fadein_blend(a, b, 0.37)
    rec = {"launches": fd.launches, "shape": list(FADEIN_SHAPE),
           "tolerance": "rtol 1e-5, atol 1e-6",
           "max_abs_err": float((blend - ref).abs().max())}
    try:
        torch.testing.assert_close(blend, ref, rtol=1e-5, atol=1e-6)
    except AssertionError as e:
        rec["error"], ok = _first_line(e), False
    out["fadein_blend"] = rec
    return ok and out["batched_power_iteration"]["launches"] == 1 and fd.launches == 1, out


def probe_host_libs(timeout):
    ok, out, _ = _build(HOST_LIBS, ".cpp")
    return ok, out


def cpu_rank_all_reduce() -> None:
    """One rank's part of ``cpu_ranks``: rank r gives r + 1; all must sum."""
    import torch
    import torch.distributed as dist
    world = dist.get_world_size()
    t = torch.full((4,), float(dist.get_rank() + 1))
    dist.all_reduce(t)
    if t.tolist() != [world * (world + 1) / 2] * 4:
        raise RuntimeError(f"all_reduce gave {t.tolist()}")


def probe_cpu_ranks(timeout):
    import tempfile

    from gan_lib_tensorflow_tpu_torch import dryrun
    with tempfile.TemporaryDirectory() as td:
        dryrun.launch("gan_lib_tensorflow_tpu_torch.tools.doctor:cpu_rank_all_reduce", 2, td,
                      timeout=timeout)
    return True, {"world": 2, "backend": "gloo", "all_reduce": "1 + 2 = 3 on every rank"}


def probe_north_star_assets(timeout):
    north_star = _from_file("cli", "north_star.py")  # numpy only at its top
    cifar_dir = north_star.find_cifar(os.environ.get("CIFAR_DIR"))
    # an npz is taken as converted; torchvision .pth/.pt and keras .h5
    # weights are converted by cli.north_star on first use
    weights = [w for w in (os.environ.get("INCEPTION_WEIGHTS"), "data/inception_v3.npz",
                           "data/inception_v3.h5", "data/inception_v3.pth",
                           "data/inception_v3.pt",
                           os.path.expanduser("~/data/inception_v3.npz"))
               if w and os.path.exists(w)]
    out = {"cifar10": cifar_dir or "MISSING (cifar-10-batches-py not found)",
           "inception_weights": weights[0] if weights else
           "MISSING (set INCEPTION_WEIGHTS or drop data/inception_v3.npz)"}
    out["graded_command"] = (
        f"python -m gan_lib_tensorflow_tpu_torch.cli.north_star --data-dir {cifar_dir} "
        f"--inception-weights {weights[0]}" if cifar_dir and weights else
        "BLOCKED until the assets above exist; `--smoke` wiring check is always available")
    return True, out


def run_probe_here(name: str, timeout: float) -> int:
    """The probe's own process: print its result, exit 0 when it is ok."""
    ok, result = globals()[f"probe_{name}"](timeout)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


# ---------------------------------------------------------------- the report

def verdict(report: dict, quick: bool):
    """``(healthy, text)`` of a report."""
    enum, power = report["device_enumeration"], report["power"]
    count = enum["result"].get("count", 0) if isinstance(enum["result"], dict) else 0
    card_seen = count > 0 or power["ok"]
    needed = ["device_enumeration", "kernel_build"] + ([] if quick else list(COMPUTE_PROBES))
    failed = [name for name in needed if not report[name]["ok"]]
    if card_seen and not failed:
        name = enum["result"]["devices"][0]["name"]
        return True, (f"accelerator healthy: {name}, capability 9.0, both kernels built for "
                      "sm_90a" + ("" if quick else ", computing and launching within tolerance"))
    if card_seen:
        return False, (f"a card is present but unusable: {', '.join(failed)} failed; "
                       "see those probes' records")
    return False, ("no CUDA card: a CPU-only environment (the CPU tests, the dry runs and "
                   "--device cpu runs remain available)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true",
                   help="skip the compute probes (device_compute, kernel_launch)")
    p.add_argument("--probe-timeout", type=float, default=90.0)
    p.add_argument("--probe", choices=PROBES, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.probe:
        return run_probe_here(args.probe, args.probe_timeout)

    names = [n for n in PROBES if not (args.quick and n in COMPUTE_PROBES)]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(probe, n, args.probe_timeout) for n in names
                   if n != "kernel_launch"}
        if "kernel_launch" in names:  # on the libraries kernel_build leaves
            build = futures["kernel_build"]
            futures["kernel_launch"] = pool.submit(
                lambda: build.exception() or probe("kernel_launch", args.probe_timeout))
        report = {n: futures[n].result() for n in names}
    healthy, report["verdict"] = verdict(report, args.quick)
    report["seconds"] = round(time.perf_counter() - t0, 2)
    print(json.dumps(report, indent=2), flush=True)
    return 0 if healthy else 1


if __name__ == "__main__":
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(DOCTOR):
        sys.path.pop(0)  # run as a script: the tools directory is no package root
    sys.exit(main())
