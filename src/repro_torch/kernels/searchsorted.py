"""searchsorted: lower / upper bound of uint64 queries in a sorted table.

Wrapper of the CUDA kernel ``csrc/searchsorted.cu`` (the port of the
Pallas ``repro/kernels/searchsorted.py::searchsorted_pallas``). A CUDA
tensor launches the kernel; a CPU tensor runs the plain version,
:func:`ref.lower_bound`. The result equals ``numpy.searchsorted`` on the
words read as uint64.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

NAME = "searchsorted"


def searchsorted(tab: torch.Tensor, q: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """(N,) ascending uint64 words, (Q,) query words (both int64 bits) ->
    (Q,) int64 insertion points in [0, N] for ``side`` "left" / "right"."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    if q.device.type == "cpu":
        return ref.lower_bound(tab, q, side)
    build.check_cuda(tab, torch.int64, 1, NAME)
    build.check_cuda(q, torch.int64, 1, NAME)
    out = torch.empty(q.shape, dtype=torch.int64, device=q.device)
    if q.shape[0] == 0 or tab.shape[0] == 0:
        return out.zero_()
    fn = build.c_function(NAME, "rt_searchsorted", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    dev = q.device.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.launched(NAME, fn(dev, tab.data_ptr(), tab.shape[0], q.data_ptr(),
                            q.shape[0], int(side == "right"),
                            out.data_ptr(), stream))
    return out
