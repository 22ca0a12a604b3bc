"""rowhash: 128-bit row signatures from uint32 column lanes.

Wrapper of the CUDA kernel ``csrc/rowhash.cu`` (the port of the Pallas
``repro/kernels/rowhash.py::rowhash_pallas``). A CUDA tensor launches the
kernel; a CPU tensor runs the plain version, :func:`ref.signatures`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

NAME = "rowhash"

# (device, lanes, rows, cols, lo, hi, stream)
_ROWHASH = build.Launcher(NAME, "rt_rowhash", [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def signatures(lanes: torch.Tensor):
    """(R, C) int32 lanes (uint32 bits) -> (sig_lo, sig_hi) (R,) int64
    words (uint64 bits), ``sig_lo = w1 << 32 | w0``, ``sig_hi = w3 << 32 |
    w2`` of the four signature chains."""
    if lanes.device.type == "cpu":
        return ref.signatures(lanes)
    build.check_cuda(lanes, torch.int32, 2, NAME)
    r, c = lanes.shape
    lo = torch.empty((r,), dtype=torch.int64, device=lanes.device)
    hi = torch.empty((r,), dtype=torch.int64, device=lanes.device)
    if r == 0:
        return lo, hi
    _ROWHASH(lanes.get_device(), lanes.data_ptr(), r, c, lo.data_ptr(),
             hi.data_ptr())
    return lo, hi
