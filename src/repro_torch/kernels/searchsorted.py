"""searchsorted: lower / upper bound of uint64 queries in a sorted table.

Wrapper of the CUDA kernel ``csrc/searchsorted.cu`` (the port of the
Pallas ``repro/kernels/searchsorted.py::searchsorted_pallas``). A CUDA
tensor launches the kernel; a CPU tensor runs the plain version,
:func:`ref.lower_bound`. The result equals ``numpy.searchsorted`` on the
words read as uint64.

Two entries share one descent: :func:`searchsorted` takes one side for
every query, :func:`searchsorted_sides` a side per query (the first
``n_left`` queries left, the rest right), which bounds several windows of
one table in one launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

NAME = "searchsorted"

# (device, tab, n, q, nq, side_right, out, stream)
_ONE_SIDE = build.Launcher(NAME, "rt_searchsorted", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
# (device, tab, n, q, nq, n_left, out, stream)
_PER_QUERY = build.Launcher(NAME, "rt_searchsorted_sides", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])


def searchsorted(tab: torch.Tensor, q: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """(N,) ascending uint64 words, (Q,) query words (both int64 bits) ->
    (Q,) int64 insertion points in [0, N] for ``side`` "left" / "right"."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    if q.is_cpu:
        return ref.lower_bound(tab, q, side)
    return _launch(_ONE_SIDE, tab, q, side == "right")


def searchsorted_sides(tab: torch.Tensor, q: torch.Tensor,
                       n_left: int) -> torch.Tensor:
    """As :func:`searchsorted`, with side "left" for ``q[:n_left]`` and
    "right" for ``q[n_left:]``."""
    if not 0 <= n_left <= q.shape[0]:
        raise ValueError(f"n_left {n_left} outside [0, {q.shape[0]}]")
    if q.is_cpu:
        return ref.lower_bound_sides(tab, q, n_left)
    return _launch(_PER_QUERY, tab, q, n_left)


def _launch(entry: build.Launcher, tab: torch.Tensor, q: torch.Tensor,
            side_arg: int) -> torch.Tensor:
    build.check_cuda(tab, torch.int64, 1, NAME)
    build.check_cuda(q, torch.int64, 1, NAME)
    dev = q.get_device()
    if tab.get_device() != dev:
        raise ValueError(f"{NAME}: table and queries on different devices")
    out = torch.empty_like(q)
    n, nq = tab.shape[0], q.shape[0]
    if nq == 0 or n == 0:
        return out.zero_()
    entry(dev, tab.data_ptr(), n, q.data_ptr(), nq, side_arg,
          out.data_ptr())
    return out
