"""Builds the CUDA kernels on first use and binds them through ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface.  No source includes PyTorch's
headers, so a build takes seconds; every source compiles in parallel, one
``nvcc`` each.  Libraries land in ``kernels/build/`` (git-ignored) under a
name carrying a digest of the source and the flags: an edited source
rebuilds, an unchanged one loads at once.

Nothing here runs at import time.  :func:`ensure_built` is called eagerly by
the tuner before a search on the card (so a build error raises instead of
quietly disqualifying the ``cuda`` candidates) and lazily by every wrapper.

:func:`expect` and :func:`stream` are the wrappers' operand checks and launch
stream.  ``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else, so a run can show which kernels the
main path really went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "SOURCES",
    "BUILD_DIR",
    "LAUNCHES",
    "BUILD_LOG",
    "reset_launches",
    "ensure_built",
    "function",
    "check",
    "expect",
    "stream",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("sell_spmv", "sell_spmv_blocked", "bcsr_spmm", "spmspv_scatter")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

LAUNCHES: collections.Counter = collections.Counter()
# nvcc's stderr per source (``-Xptxas -v``: registers, shared memory, spills).
BUILD_LOG: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from kernels/csrc at first use on a machine with the toolkit"
        )
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def ensure_built() -> dict[str, Path]:
    """Compile every missing library (in parallel) and load all of them.

    Raises ``RuntimeError`` with nvcc's output when a source fails to build.
    """
    with _lock:
        targets = {name: _target(name) for name in SOURCES}
        todo = {n: t for n, t in targets.items() if not t.exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name, target in todo.items():
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True,
                    ),
                    tmp,
                )
            errors = []
            for name, (proc, tmp) in procs.items():
                out, err = proc.communicate()
                BUILD_LOG[name] = (out + err).strip()
                if proc.returncode != 0:
                    errors.append(f"{name}.cu (rc {proc.returncode}):\n{out}{err}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, targets[name])
            if errors:
                raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        for name, target in targets.items():
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(target))
        return targets


def function(source: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<source>.cu`` with its
    argument types declared (pointers and the stream as ``c_void_p``, so
    ctypes never truncates them to 32 bits); returns a CUDA error code."""
    key = (source, symbol)
    fn = _fns.get(key)
    if fn is None:
        ensure_built()
        fn = getattr(_libs[source], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(source: str, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if code != 0:
        err = _libs[source].kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {code} ({err(code).decode()})")


def expect(t: torch.Tensor, name: str, dtype, device, ndim: int) -> None:
    """Refuse an operand the kernel cannot take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(device: torch.device) -> int:
    """The handle of the current CUDA stream, which kernels launch on."""
    return torch.cuda.current_stream(device).cuda_stream
