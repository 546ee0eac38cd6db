"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles on first use with ``nvcc`` into its own shared
library with a plain C interface under ``build/fasttalk_tpu_torch/`` of
the checkout, and is loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds). Library names carry a hash of the source and of the
shared headers (``csrc/*.cuh``), so an edited kernel or header rebuilds
and a stale library is never loaded. Every exported C
function returns ``cudaGetLastError()``; the wrappers raise on non-zero.

Nothing here runs at import: the CPU tests import every module and this
host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fasttalk_tpu_torch")
SOURCES = ("int8_matmul", "decode_attention", "int4_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "fasttalk_tpu_torch need the CUDA toolkit")


def _target(name: str) -> tuple[str, str]:
    """The source and the library path for ``csrc/<name>.cu``. The hash
    covers the source, every ``csrc/*.cuh`` header (a source may include
    any of them) and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str) -> tuple[subprocess.Popen | None, str, str]:
    """Start nvcc for one source unless its library is already built."""
    src, lib = _target(name)
    if os.path.isfile(lib):
        return None, lib, lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, proc: subprocess.Popen | None, tmp: str,
            lib: str) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a reader never sees a partial library


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile the given sources in parallel (one nvcc each); returns
    name -> library path. Raises on any build failure."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, (proc, tmp, lib) in started.items():
            _finish(n, proc, tmp, lib)
        return {n: lib for n, (_, _, lib) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build((name,))[name]
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
