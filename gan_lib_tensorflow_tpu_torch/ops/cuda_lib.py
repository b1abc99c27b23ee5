"""Build and load the port's hand-written native sources.

Each source exposes a plain C interface: a CUDA kernel ``csrc/<name>.cu``,
compiled with ``nvcc`` for ``sm_90a``, or host code ``csrc/<name>.cpp``
(the image decoder), compiled with the host's C++ compiler (``c++``, else
``g++``). At first use it is built into ``_build/lib<name>_<hash>.so``
beside this package, where the hash is of the source, so an edited source
builds anew and an unchanged one is built once. The library is loaded with
``ctypes``; the caller declares its functions' argument types.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the port's CUDA kernels cannot be built")
    return path


def _cxx(source: str) -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError(f"no host C++ compiler (c++ or g++) on PATH: {source} "
                       "cannot be built")


class KernelLibrary:
    """One native source, built once per source version and loaded once per
    process, whichever thread asks first (loader threads share it).
    ``declare(lib)`` sets the ``argtypes``/``restype`` of its functions;
    every library also exports ``gl_error_string(int)``. ``suffix`` picks
    the compiler: ``.cu`` (nvcc) or ``.cpp`` (host)."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None],
                 suffix: str = ".cu"):
        self.name = name
        self.source = os.path.join(CSRC_DIR, f"{name}{suffix}")
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""  # the compiler's output (ptxas's register/shared-memory report)

    def _command(self, out: str) -> list:
        if self.source.endswith(".cpp"):
            return [_cxx(self.source), *CXX_FLAGS, "-o", out, self.source]
        return [_nvcc(), *NVCC_FLAGS, "-o", out, self.source]

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                self._lib = self._build_and_load()
        return self._lib

    def path(self) -> str:
        """The built library's path (which need not exist yet)."""
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"lib{self.name}_{digest}.so")

    def _build_and_load(self) -> ctypes.CDLL:
        so = self.path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = self._command(tmp)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"{os.path.basename(cmd[0])} failed on {self.source} "
                                   f"({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, so)  # atomic: concurrent builders never load half a file
        lib = ctypes.CDLL(so)
        self._declare(lib)
        lib.gl_error_string.argtypes = [ctypes.c_int]
        lib.gl_error_string.restype = ctypes.c_char_p
        return lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            raise RuntimeError(f"{what} launch failed: "
                               + self.load().gl_error_string(err).decode())
