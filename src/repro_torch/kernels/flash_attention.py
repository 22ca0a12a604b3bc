"""flash_attention: online-softmax attention forward.

Wrapper of the CUDA kernel ``csrc/flash_attention.cu`` (the port of the
Pallas ``repro/kernels/flash_attention.py::flash_attention_pallas``). A
CUDA tensor launches the kernel; a CPU tensor runs the plain version,
:func:`ref.attention`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

NAME = "flash_attention"
#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block: int = 256) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) with H % KV == 0 -> (B,Sq,H,hd).

    On the card: bf16, contiguous, hd in :data:`HEAD_DIMS`; anything else
    raises ``ValueError`` (no cast, no fallback). The kernel's tiles are
    fixed (64 query rows x 64 keys); ``block`` is the plain version's
    block size on the CPU, which changes only the order of float sums."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, block=block)
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        build.check_cuda(t, torch.bfloat16, 4, f"{NAME} {what}")
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{NAME} {what}: must be 16-byte aligned on "
                             f"q's device")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{NAME}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {hd} not in {HEAD_DIMS}")
    if KV == 0 or H % KV or Sk == 0:
        raise ValueError(f"{NAME}: needs H % KV == 0 and Sk >= 1 "
                         f"(H {H}, KV {KV}, Sk {Sk})")
    o = torch.empty_like(q)
    if Sq == 0 or B == 0:
        return o
    fn = build.c_function(NAME, "rt_flash_attention", [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    dev = q.device.index
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.launched(NAME, fn(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), B, Sq, Sk, H, KV, hd, int(causal),
                            stream))
    return o
