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
stream.  :func:`refuse_autograd` keeps a kernel's output from reaching
autograd: no kernel has a backward, and a ctypes launch writes an output
that autograd would take for a constant, so a gradient through it would
be silently lost.  ``LAUNCHES`` counts kernel launches by name; each
wrapper adds one (:func:`count`) where it launches its kernel and nowhere
else, so a run can show which kernels the main path really went through.
The count takes a lock: an engine's repair thread launches beside its
serving thread.

A launch made while the calling thread's current stream captures a CUDA
graph runs nothing yet: :func:`count` adds it to that thread's capture
tally instead.  The capture takes the tally (:func:`take_tally`) and each
replay of the graph adds it to ``LAUNCHES`` (:func:`add_replay`).  The
tally is per thread, so a thread that captures never counts the eager
launches of another, nor they its captured ones.
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
    "count",
    "take_tally",
    "add_replay",
    "ensure_built",
    "function",
    "check",
    "expect",
    "refuse_autograd",
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
_count_lock = threading.Lock()
_capturing = threading.local()  # .tally: this thread's captured launches


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES.clear()


def _tally() -> collections.Counter:
    tally = getattr(_capturing, "tally", None)
    if tally is None:
        tally = _capturing.tally = collections.Counter()
    return tally


def count(name: str) -> None:
    """Add one launch of kernel ``name`` to ``LAUNCHES``, or to the calling
    thread's capture tally while its current stream is capturing."""
    if torch.cuda.is_current_stream_capturing():
        _tally()[name] += 1
        return
    with _count_lock:
        LAUNCHES[name] += 1


def take_tally() -> collections.Counter:
    """The launches the calling thread captured since its last call; its
    tally starts again from nothing."""
    tally = _tally()
    _capturing.tally = collections.Counter()
    return tally


def add_replay(tally: collections.Counter) -> None:
    """Count one replay of a graph that captured ``tally``."""
    with _count_lock:
        LAUNCHES.update(tally)


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


def expect(t: torch.Tensor, name: str, dtype, device, ndim: int,
           align: int = 0) -> None:
    """Refuse an operand the kernel cannot take.

    ``align``: the byte boundary the operand's first element must sit on,
    for a kernel that reads it in vectors.  A misaligned vector load would
    fault the whole CUDA context instead of raising here."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(
            f"{name} must start on a {align}-byte boundary (a view at storage "
            f"offset {t.storage_offset()} does not; pass a copy)"
        )


def refuse_autograd(kernel: str, *operands: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and a floating
    operand requires grad.  Every wrapper calls it before it launches or
    falls back to its plain version, on the CPU too, as the JAX package's
    ``jax.grad`` through a Pallas kernel raises in interpret mode."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in operands if t.is_floating_point()):
        raise NotImplementedError(
            f"{kernel}: the kernel has no backward, so its output would reach "
            "autograd as a constant and drop the operands' gradients; run it "
            "under torch.no_grad(), or differentiate its plain version")


def stream(device: torch.device) -> int:
    """The handle of the current CUDA stream, which kernels launch on."""
    return torch.cuda.current_stream(device).cuda_stream
