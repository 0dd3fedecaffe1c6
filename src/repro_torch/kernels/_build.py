"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``kernels/<dir>/<op>.cu`` with a plain C interface
(``KERNELS`` names its directory and its extra flags). At first use,
``load(op)`` compiles it with ``nvcc`` into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``) and
opens it with ``ctypes``; the library's name carries a hash of the source,
of every header it includes (``#include "..."``, followed from file to
file, wherever the header lies) and of the flags, so an edit to a source or
to a shared header rebuilds every library that uses it, and an unchanged one
is reused. A build that fails raises with
nvcc's log.

The sources include no PyTorch headers, so each compiles in seconds; the
wrappers pass ``data_ptr()`` pointers and the current stream. Nothing here
runs at import time: the CPU tests import every module, and the CPU has no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["KERNELS", "BUILD_DIR", "load", "build_all", "build_log"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"

_COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
#: op -> (directory, extra nvcc flags). The cell's plain versions round
#: every product and sum on their own, so its kernels must not contract them
#: into FMAs.
KERNELS = {
    "floatsd_matmul": ("floatsd_matmul", ()),
    "floatsd_matmul_dw": ("floatsd_matmul", ()),
    "lstm_cell": ("lstm_cell", ("--fmad=false",)),
    "lstm_cell_bwd": ("lstm_cell", ("--fmad=false",)),
    "floatsd4_matmul": ("floatsd4_matmul", ()),
    "floatsd_quantize": ("floatsd_quantize", ()),
    # shares the cell's sigmoid (lstm_cell_common.cuh) and its rounding
    "qsigmoid": ("qsigmoid", ("--fmad=false",)),
    "rwkv_wkv": ("rwkv_wkv", ()),
    "flash_attention": ("flash_attention", ()),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(op: str) -> list[Path]:
    """The source of ``op`` and every header it includes with quotes,
    resolved against the including file's directory, transitively."""
    folder, _ = KERNELS[op]
    todo = [_KERNELS_DIR / folder / f"{op}.cu"]
    seen: list[Path] = []
    while todo:
        f = todo.pop(0).resolve()
        if f in seen:
            continue
        seen.append(f)
        todo += [f.parent / inc for inc in _INCLUDE.findall(f.read_text())]
    return seen


def _target(op: str) -> tuple[Path, list[str]]:
    src, *headers = _sources(op)
    flags = [*_COMMON_FLAGS, *KERNELS[op][1]]
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(headers):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{op}-{digest}.so", [str(src), *flags]


def _start(op: str):
    """Start nvcc for ``op`` unless its library exists; returns the process
    (or None) and the library path."""
    lib, args = _target(op)
    if lib.exists():
        return None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *args, "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return (proc, tmp), lib


def _finish(op: str, pending, lib: Path) -> None:
    if pending is not None:
        proc, tmp = pending
        log, _ = proc.communicate()
        _LOGS[op] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {op} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
    _LIBS[op] = ctypes.CDLL(str(lib))


def build_all(ops=None) -> None:
    """Build every kernel (or ``ops``) not yet loaded, one nvcc per source,
    all started together."""
    with _LOCK:
        todo = [op for op in (ops or KERNELS) if op not in _LIBS]
        started = [(op, *_start(op)) for op in todo]
        errors = []
        for op, pending, lib in started:  # wait for every nvcc, even after a failure
            try:
                _finish(op, pending, lib)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]


def load(op: str) -> ctypes.CDLL:
    """The loaded library of ``op``, built at first use."""
    lib = _LIBS.get(op)
    if lib is None:
        build_all([op])
        lib = _LIBS[op]
    return lib


def build_log(op: str) -> str:
    """nvcc's output (ptxas register and spill report) for ``op``, if this
    process built it."""
    return _LOGS.get(op, "")
