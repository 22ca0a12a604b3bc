"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each CUDA source has a plain C interface and is compiled by ``nvcc`` into
its own shared library for ``sm_90a``, then loaded with ``ctypes`` —
no PyTorch headers, so a build takes seconds. Libraries land in
``<repo>/build/kernels`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.

Nothing here runs at import time: the first wrapper that launches a
kernel calls :func:`library`, and :func:`build_all` (used by
``chip_smoke.py``) starts one ``nvcc`` per source, all at once.

Every wrapper launches through a :class:`Launcher`, and the path is lean
because most main-path launches (searchsorted, probe) cost far more host
time than device time: the C entry is bound once, the caller's current
stream is read as a raw handle, and :func:`check_cuda` passes a good
tensor with one test.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: the kernels of the data-VCS path (diff, merge, seal) ...
VCS_SOURCES = ("rowhash", "searchsorted", "segsum_diff", "probe")
#: ... and every kernel, the model stack's attention (forward and
#: backward) included
SOURCES = VCS_SOURCES + ("flash_attention", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: kernel name -> launches since the last reset. A wrapper's Launcher adds
#: one where it launches its CUDA kernel and nowhere else (the CPU path of
#: a wrapper runs the plain version and does not count), so a run can
#: prove that the main path went through the kernels.
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels build on the GPU host")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc (returns (proc, tmp, final) or None if built)."""
    out = _lib_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log.decode()}")
    os.replace(tmp, out)      # atomic: a reader never sees half a library


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every listed kernel source that is not built yet, with one
    nvcc process per source started together."""
    with _LOCK:
        nvcc = None
        jobs = {}
        for name in names:
            if _lib_path(name).is_file():
                continue
            nvcc = nvcc or nvcc_path()
            jobs[name] = _start(name, nvcc)
        for name, job in jobs.items():
            if job is not None:
                _finish(name, job)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source (built on demand)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _LIBS[name] = lib
    return lib


def c_function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of kernel library ``name`` with its C signature set
    (every pointer and the stream as ``c_void_p`` so none is cut to 32
    bits); returns the C function, whose int result is cudaGetLastError."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


class Launcher:
    """One C entry of a kernel library, bound on its first launch (not
    looked up per call), launching on the caller's current stream.

    ``launcher(device, *args)`` calls the entry as ``fn(device, *args,
    stream)`` with the raw handle of ``device``'s current stream (so a
    launch under ``torch.cuda.stream(s)`` lands on ``s``), raises on a
    non-zero CUDA error and counts the launch in :data:`LAUNCHES`."""

    __slots__ = ("name", "symbol", "argtypes", "_fn", "_stream")

    def __init__(self, name: str, symbol: str, argtypes) -> None:
        self.name, self.symbol, self.argtypes = name, symbol, argtypes
        self._fn = None
        self._stream = None

    def __call__(self, device: int, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._bind()
        err = fn(device, *args, self._stream(device))
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES[self.name] += 1

    def _bind(self):
        # the raw cudaStream_t of the device's current stream, without the
        # Python Stream object torch.cuda.current_stream builds per call
        self._stream = torch._C._cuda_getCurrentRawStream
        self._fn = c_function(self.name, self.symbol, self.argtypes)
        return self._fn


def check_cuda(t, dtype, ndim: int, what: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype/rank."""
    if t.is_cuda and t.dtype == dtype and t.dim() == ndim \
            and t.is_contiguous():
        return
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
