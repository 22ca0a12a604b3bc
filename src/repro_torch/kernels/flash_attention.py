"""flash_attention: online-softmax attention forward.

Wrapper of the CUDA kernel ``csrc/flash_attention.cu`` (the port of the
Pallas ``repro/kernels/flash_attention.py::flash_attention_pallas``). A
CUDA tensor launches the kernel; a CPU tensor runs the plain version,
:func:`ref.attention`.

The wrapper calls the op ``repro_torch::flash_attention``, defined on a
``torch.library.Library`` (lighter on the host than a ``custom_op``,
whose Python layers run on every call): its CUDA registration validates and
launches, its CPU registration runs the plain version, and its fake
registration gives the output shapes alone, so that a ``meta`` or fake
tensor traces the op without a launch (``launch.dryrun``). Its FLOP
formula (``torch.utils.flop_counter``) is :func:`flops`: 4 hd per
admitted (query, key) pair and query head, the operation count of the
kernel's bound.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, ref

NAME = "flash_attention"
#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)
#: fields of :func:`config`, in the order ``rt_flash_attention_config``
#: writes them
CONFIG_FIELDS = ("block_m", "block_n", "stages", "threads", "regs",
                 "producer_regs", "consumer_regs", "smem_bytes",
                 "static_smem_bytes")
# (device, q, k, v, o, lse, B, Sq, Sk, H, KV, hd, causal, window[, block_m],
#  stream)
_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
_FLASH = build.Launcher(NAME, "rt_flash_attention", _ARGS + [ctypes.c_void_p])
_FLASH_ROWS = build.Launcher(NAME, "rt_flash_attention_rows",
                             _ARGS + [ctypes.c_int, ctypes.c_void_p])


def check_inputs(name: str, *tensors: torch.Tensor):
    """Raise ``ValueError`` unless q, k, v (and any further tensors shaped
    like q or k: o, dO) are what the kernels take: bf16, contiguous,
    16-byte aligned on q's device, hd in :data:`HEAD_DIMS`, H % KV == 0.
    ``tensors`` is (q, k, v, *like_q). Returns (B, Sq, Sk, H, KV, hd)."""
    q, k, v, *like_q = tensors
    for t, what in zip(tensors, ("q", "k", "v", "o", "do")):
        build.check_cuda(t, torch.bfloat16, 4, f"{name} {what}")
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{name} {what}: must be 16-byte aligned on "
                             f"q's device")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if (v.shape != k.shape or k.shape[0] != B or k.shape[3] != hd
            or any(t.shape != q.shape for t in like_q)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if KV == 0 or H % KV or Sk == 0:
        raise ValueError(f"{name}: needs H % KV == 0 and Sk >= 1 "
                         f"(H {H}, KV {KV}, Sk {Sk})")
    return B, Sq, Sk, H, KV, hd


def pairs(sq: int, sk: int, causal: bool,
          window: Optional[int] = None) -> int:
    """(query, key) pairs the mask admits: all Sq x Sk without
    ``causal``; top-left causal, query i seeing keys 0 .. min(i, Sk - 1);
    with a ``window`` W (causal only) keys max(0, i - W + 1) .. min(i,
    Sk - 1)."""
    if not causal:
        return sq * sk
    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int(np.maximum(0, np.minimum(i, sk - 1) - lo + 1).sum())


def flops(q_shape, k_shape, causal: bool,
          window: Optional[int] = None) -> int:
    """Operations of one forward: 4 hd per admitted pair (Q.K^T and P.V,
    a multiply and an add each) per query head, over the batch."""
    B, Sq, H, hd = q_shape
    return 4 * hd * B * H * pairs(Sq, k_shape[1], causal, window)


def _launch(q, k, v, causal, window, block_m, return_lse):
    """The kernel's launch on CUDA tensors: checks, outputs, one launch."""
    B, Sq, Sk, H, KV, hd = check_inputs(NAME, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq) if return_lse else (0,),
                      dtype=torch.float32, device=q.device)
    if Sq and B:
        sizes = (q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), lse.data_ptr() if return_lse else None,
                 B, Sq, Sk, H, KV, hd, int(causal),
                 min(int(window), 2**31 - 1)
                 if causal and window is not None else 0)
        if block_m is None:
            _FLASH(*sizes)
        else:
            _FLASH_ROWS(*sizes, block_m)
    return o, lse


#: the ops' registrations (this module's and ``flash_attention_bwd``'s)
LIB = torch.library.Library("repro_torch", "FRAGMENT")
LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
           "int? window, int block, int? block_m, bool return_lse) "
           "-> (Tensor, Tensor)")


def _flash_cuda(q, k, v, causal, window, block, block_m, return_lse):
    """(o, lse): the kernel on the card; lse is (0,) unless
    ``return_lse``."""
    return _launch(q, k, v, causal, window, block_m, return_lse)


def _flash_cpu(q, k, v, causal, window, block, block_m, return_lse):
    o, lse = ref.attention_lse(q, k, v, causal=causal, block=block,
                               window=window)
    return o, (lse if return_lse else lse.new_empty((0,)))


def _flash_fake(q, k, v, causal, window, block, block_m, return_lse):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty(
        (B, H, Sq) if return_lse else (0,), dtype=torch.float32)


LIB.impl("flash_attention", _flash_cuda, "CUDA")
LIB.impl("flash_attention", _flash_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_attention", _flash_fake,
                            lib=LIB)
_flash_op = torch.ops.repro_torch.flash_attention.default


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args,
                 out_shape=None, **kw) -> int:
    return flops(q_shape, k_shape, causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block: int = 256,
                    block_m: Optional[int] = None, return_lse: bool = False,
                    window: Optional[int] = None):
    """q: (B,Sq,H,hd); k/v: (B,Sk,KV,hd) with H % KV == 0 -> (B,Sq,H,hd).

    On the card: bf16, contiguous, hd in :data:`HEAD_DIMS`; anything else
    raises ``ValueError`` (no cast, no fallback). The kernel chooses its
    own tiles (:func:`config`) unless ``block_m`` (64 or 128 query rows
    per CTA) forces them, for timing that choice. ``block`` is the plain
    version's block size on the CPU, which changes only the order of
    float sums. ``return_lse`` also returns each row's natural-log sum of
    exponentials, (B,H,Sq) float32, which the backward reads
    (:func:`ref.attention_lse` on the CPU). ``window`` W (>= 1) is the
    causal sliding window: query i sees keys i - W + 1 .. i; it is ignored
    without ``causal``, as in the reference. A ``meta`` or fake tensor
    gives the outputs' shapes and launches nothing."""
    if block_m not in (None, 64, 128):
        raise ValueError(f"{NAME}: block_m {block_m} is not 64 or 128")
    if window is not None and window < 1:
        raise ValueError(f"{NAME}: window {window} is not >= 1")
    o, lse = _flash_op(q, k, v, causal, window if causal else None, block,
                       block_m, return_lse)
    return (o, lse) if return_lse else o


def config(b: int, sq: int, h: int, hd: int, device=None) -> dict:
    """The launch configuration the kernel takes for these sizes on a CUDA
    ``device``: the CTA tile (``block_m`` query rows, ``block_n`` keys),
    ring stages, threads, registers per thread (at launch, and after
    ``setmaxnreg`` for the producer and consumer warpgroups) and shared
    memory per CTA. Builds the kernel if needed; launches nothing."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {hd} not in {HEAD_DIMS}")
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    fn = build.c_function(NAME, "rt_flash_attention_config", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * len(CONFIG_FIELDS))()
    err = fn(index, b, sq, h, hd, out)
    if err:
        raise RuntimeError(f"{NAME} config query failed: CUDA error {err}")
    return dict(zip(CONFIG_FIELDS, out))
