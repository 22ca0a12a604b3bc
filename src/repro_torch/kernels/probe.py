"""probe: fused 128-bit key probe (run start + run length).

Wrapper of the CUDA kernel ``csrc/probe.cu`` (the port of the Pallas
``repro/kernels/probe.py::probe_pallas``). A CUDA tensor launches the
kernel; a CPU tensor runs the plain version, :func:`ref.probe`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

NAME = "probe"

# (device, t_lo, t_hi, n, q_lo, q_hi, nq, out, stream)
_PROBE = build.Launcher(NAME, "rt_probe", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_void_p])


def probe(t_lo: torch.Tensor, t_hi: torch.Tensor, q_lo: torch.Tensor,
          q_hi: torch.Tensor):
    """Table (N,) words sorted by (lo, hi), queries (Q,) words (int64 bits
    of uint64) -> (start, cnt) (Q,) int64: the exact 128-bit lower bound
    (defined for misses too) and the length of the equal-key run."""
    if q_lo.is_cpu:
        return ref.probe(t_lo, t_hi, q_lo, q_hi)
    for t in (t_lo, t_hi, q_lo, q_hi):
        build.check_cuda(t, torch.int64, 1, NAME)
    if t_hi.shape != t_lo.shape or q_hi.shape != q_lo.shape:
        raise ValueError(f"{NAME}: lo/hi word lanes differ in length")
    dev = q_lo.get_device()
    if any(t.get_device() != dev for t in (t_lo, t_hi, q_hi)):
        raise ValueError(f"{NAME}: table and queries on different devices")
    nq, n = q_lo.shape[0], t_lo.shape[0]
    out = q_lo.new_empty((2, nq))          # row 0 start, row 1 cnt
    if nq == 0 or n == 0:
        out.zero_()
    else:
        _PROBE(dev, t_lo.data_ptr(), t_hi.data_ptr(), n, q_lo.data_ptr(),
               q_hi.data_ptr(), nq, out.data_ptr())
    return out[0], out[1]
