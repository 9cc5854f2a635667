"""Compiles ``csrc/*.cu`` with ``nvcc`` into shared libraries
with a plain C interface and loads them with ``ctypes``.

Each source builds into its own ``lib<name>-<hash>.so`` under
``build/quilt_tpu_torch/`` at the repository root; the hash covers the
source text, the shared ``csrc/*.cuh`` headers and the compiler flags, so an edited kernel rebuilds and an
unchanged one is reused. Nothing here runs at import time: ``nvcc`` and
``ctypes`` are touched only on the first launch of a CUDA kernel (or by
``build_all``), so the package imports on machines without a CUDA toolkit.

A build holds an exclusive ``fcntl.flock`` on ``<name>.lock`` in the build
directory for each source it builds, and looks for the library again once
it holds them, so processes that build at first use together (the ranks of
a multi-process run on a fresh checkout) take turns instead of racing on
one ``.so``.

Every C entry point takes its pointers and the CUDA stream as ``void*``
and returns ``cudaGetLastError()`` after the launch; ``Kernel.launch``
raises when that is not ``cudaSuccess``.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "quilt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin); the "
            "CUDA kernels of quilt_tpu_torch need the CUDA toolkit"
        )
    return path


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(SRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


@contextlib.contextmanager
def build_lock(name: str):
    """Holds the exclusive lock on building ``csrc/<name>.cu``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (default: every ``csrc/*.cu``), one
    ``nvcc`` process per source, all started together, each under its
    build lock. Returns {name: ptxas report} of the sources it compiled;
    raises with the compiler output on failure."""
    if names is None:
        names = (p.stem for p in SRC_DIR.glob("*.cu"))
    names = sorted(set(names))
    with contextlib.ExitStack() as locks:
        for name in names:
            locks.enter_context(build_lock(name))
        return _compile(names)


def _compile(names) -> Dict[str, str]:
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check_tensor(t, name: str, dtype, shape, device) -> None:
    """Refuse a kernel argument the kernel does not take: wrong device,
    dtype, shape or a non-contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``argtypes`` lists the ctypes types of the entry's arguments (the
    stream, a ``c_void_p``, is appended by ``launch``). ``launches`` is a
    plain integer that the wrapper's launch path, and nothing else,
    increments; a caller may reset it to 0. ``name`` tells apart two counts
    of one entry (the same C function launched for two samplers); it is the
    entry's name unless given."""

    def __init__(self, library: str, entry: str, argtypes, name: Optional[str] = None):
        self.library = library
        self.entry = entry
        self.name = name or entry
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        import torch

        if self._fn is None:
            fn = getattr(load(self.library), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.entry} failed to launch "
                f"(cudaError {err})"
            )
        self.launches += 1
