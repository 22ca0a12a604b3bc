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


def probe(t_lo: torch.Tensor, t_hi: torch.Tensor, q_lo: torch.Tensor,
          q_hi: torch.Tensor):
    """Table (N,) words sorted by (lo, hi), queries (Q,) words (int64 bits
    of uint64) -> (start, cnt) (Q,) int64: the exact 128-bit lower bound
    (defined for misses too) and the length of the equal-key run."""
    if q_lo.device.type == "cpu":
        return ref.probe(t_lo, t_hi, q_lo, q_hi)
    for t in (t_lo, t_hi, q_lo, q_hi):
        build.check_cuda(t, torch.int64, 1, NAME)
    if t_hi.shape != t_lo.shape or q_hi.shape != q_lo.shape:
        raise ValueError(f"{NAME}: lo/hi word lanes differ in length")
    nq = q_lo.shape[0]
    start = torch.empty((nq,), dtype=torch.int64, device=q_lo.device)
    cnt = torch.empty((nq,), dtype=torch.int64, device=q_lo.device)
    if nq == 0 or t_lo.shape[0] == 0:
        return start.zero_(), cnt.zero_()
    fn = build.c_function(NAME, "rt_probe", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    dev = q_lo.device.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.launched(NAME, fn(dev, t_lo.data_ptr(), t_hi.data_ptr(),
                            t_lo.shape[0], q_lo.data_ptr(), q_hi.data_ptr(),
                            nq, start.data_ptr(), cnt.data_ptr(), stream))
    return start, cnt
