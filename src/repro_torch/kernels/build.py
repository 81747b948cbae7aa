"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, and loaded with ``ctypes``. Nothing includes PyTorch's headers, so
a build takes seconds, not minutes. Libraries are named by a digest of
their sources and flags and live in ``_build/`` beside this file (listed
in ``.gitignore``); a changed source builds anew. The compiler's
register and shared-memory report (``-Xptxas -v``) is kept beside each
library as ``<library>.log``.

A missing ``nvcc``, a failed compile or a failed load raises: the port
has no CPU fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("decode", "stores", "flash", "stream", "stencil")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
#: seconds from the start of the last build to each library's compiler exit
BUILD_SECONDS: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> list:
    """Compile every named source not built yet, all at once.

    One ``nvcc`` process per source, all started together; returns the
    names that were compiled, and records each one's seconds from the
    start to its compiler's exit in :data:`BUILD_SECONDS`. Raises with the
    compiler's output if any compile fails.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    t0 = time.perf_counter()
    jobs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_name(out.name + ".log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=f, stderr=subprocess.STDOUT)
        jobs[n] = (proc, tmp, out, log)
    pending = set(jobs)
    while pending:
        for n in sorted(pending):
            if jobs[n][0].poll() is not None:
                BUILD_SECONDS[n] = time.perf_counter() - t0
                pending.discard(n)
        if pending:
            time.sleep(0.05)
    failed = []
    for n, (proc, tmp, out, log) in jobs.items():
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n"
                          f"{log.read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return todo


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed.

    ``signatures`` maps each exported function to its ``argtypes``;
    every function returns a CUDA error code as ``int`` (0 is success).
    """
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
