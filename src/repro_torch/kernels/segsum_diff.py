"""segsum_diff: the diff-aggregation scan over a key-sorted signed stream.

Wrapper of the CUDA kernel ``csrc/segsum_diff.cu`` (the port of the
Pallas ``repro/kernels/segsum_diff.py::segsum_pallas``). A CUDA tensor
launches the kernel; a CPU tensor runs the plain version,
:func:`ref.segsum`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

NAME = "segsum_diff"
#: the single-pass scan's tile (``kThreads``, ``kQuads``, ``kTile`` of the
#: kernel): THREADS threads x QUADS quads of 4 consecutive rows. The
#: scratch holds a tile counter and one status word per tile; the kernel
#: refuses a scratch shorter than its own tile count needs.
THREADS, QUADS = 512, 2
TILE = THREADS * QUADS * 4

# (device, lo, hi, r_lo, r_hi, signs, n, boundary, csum, scratch,
#  scratch words, stream)
_SEGSUM = build.Launcher(NAME, "rt_segsum", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])


def segsum(lo: torch.Tensor, hi: torch.Tensor, signs: torch.Tensor,
           r_lo=None, r_hi=None):
    """(N,) key words sorted by (lo, hi) and (N,) int32 signs -> (boundary
    (N,) bool, csum (N,) int32): new-run flags (row 0 always; the optional
    second pair ``r_lo, r_hi`` ORs its change flags in) and the inclusive
    cumulative sum of the signs over the whole stream. A CUDA stream takes
    one launch (after one memset of the scratch), whatever its length."""
    if lo.device.type == "cpu":
        return ref.segsum(lo, hi, signs, r_lo, r_hi)
    words = [lo, hi] + ([] if r_lo is None else [r_lo, r_hi])
    for t in words:
        build.check_cuda(t, torch.int64, 1, NAME)
        if t.shape != lo.shape:
            raise ValueError(f"{NAME}: word lanes differ in length")
    build.check_cuda(signs, torch.int32, 1, NAME)
    n = lo.shape[0]
    if signs.shape[0] != n:
        raise ValueError(f"{NAME}: {signs.shape[0]} signs for {n} keys")
    bnd = torch.empty((n,), dtype=torch.bool, device=lo.device)
    csum = torch.empty((n,), dtype=torch.int32, device=lo.device)
    if n == 0:
        return bnd, csum
    scratch_words = (n + TILE - 1) // TILE + 1
    scratch = torch.empty((scratch_words,), dtype=torch.int64,
                          device=lo.device)
    r_lo_p = None if r_lo is None else r_lo.data_ptr()
    r_hi_p = None if r_hi is None else r_hi.data_ptr()
    _SEGSUM(lo.get_device(), lo.data_ptr(), hi.data_ptr(), r_lo_p, r_hi_p,
            signs.data_ptr(), n, bnd.data_ptr(), csum.data_ptr(),
            scratch.data_ptr(), scratch_words)
    return bnd, csum
