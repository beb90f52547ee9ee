"""Build and load the port's CUDA kernels.

Each source in `amgx_tpu_torch/csrc/` compiles with `nvcc` for `sm_90a`
into its own shared library with a plain C interface, loaded through
`ctypes`. Libraries land in `amgx_tpu_torch/_build/<hash>/`, keyed by a
hash of all sources and the compiler flags, so an edited source
rebuilds and an unchanged checkout builds once. All sources compile
concurrently (one `nvcc` process each). A failed build raises: there is
no fallback to the plain PyTorch versions.

Nothing here runs at import time; the first kernel launch (or
`build_all()`) triggers the build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("dia.cu", "stencil_tb.cu", "stencil_tb_slab.cu", "krylov.cu",
           "tail.cu", "csr.cu", "rap.cu", "dense.cu", "gs.cu",
           "segment.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# the sources compiled by this process (each nvcc run) and the libraries
# it has loaded, in load order: the serving warm-start store records the
# latter so a restarted bucket loads them before its first request
BUILT: list = []
LOADED: list = []
# one build and one load per library, whichever thread asks first: the
# builder and scheduler threads of several service replicas may all
# launch their first kernel at once
_LOCK = threading.RLock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh", ".h")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _lib_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_ROOT, _digest(), f"libamgx_{stem}.so")


def build_all() -> dict:
    """Compile every missing library, all sources at once. Returns
    {"seconds": wall time, "built": [sources compiled], "ptxas": {source:
    nvcc's resource report}}; raises KernelBuildError on any failure."""
    with _LOCK:
        return _build_all()


def _build_all() -> dict:
    t0 = time.perf_counter()
    todo = [s for s in SOURCES if not os.path.isfile(_lib_path(s))]
    report = {"seconds": 0.0, "built": todo, "ptxas": {}}
    if todo:
        nvcc = _nvcc()
        out_dir = os.path.dirname(_lib_path(todo[0]))
        os.makedirs(out_dir, exist_ok=True)
        procs = []
        for src in todo:
            # compile to a private name, then rename: a concurrent
            # process never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            report["ptxas"][src] = log
            if proc.returncode != 0:
                failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
                os.unlink(tmp)
            else:
                os.replace(tmp, _lib_path(src))
                BUILT.append(src)
        if failed:
            raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    report["seconds"] = time.perf_counter() - t0
    return report


def resource_lines(log: str) -> list:
    """nvcc's `-Xptxas -v` report of one source, one line per kernel:
    "<entry function>: Used N registers, ...; <stack frame and spills>"."""
    lines, name, frame = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used " in ln and name is not None:
            lines.append(f"{name}: {ln.split('Used ', 1)[1].strip()}; "
                         f"{frame}")
            name, frame = None, ""
    return lines


def library(source: str = "dia.cu") -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _LOCK:
        return _library(source)


@functools.lru_cache(maxsize=None)
def _library(source: str) -> ctypes.CDLL:
    path = _lib_path(source)
    if not os.path.isfile(path):
        build_all()
    lib = ctypes.CDLL(path)
    LOADED.append(source)
    return lib
