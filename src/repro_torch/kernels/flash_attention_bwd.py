"""flash_attention_bwd: the backward of flash attention.

Wrapper of the CUDA kernel ``csrc/flash_attention_bwd.cu``. The reference
has no Pallas kernel here: it trains through XLA's automatic
differentiation of ``repro/models/layers.py::block_causal_attention``. A
CUDA tensor launches the kernel (three launches a call, counted once: D,
the main kernel with dK, dV and dQ's parts, the dq conversion); a CPU
tensor runs the plain version, :func:`ref.attention_bwd`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref
from .flash_attention import HEAD_DIMS, check_inputs

NAME = "flash_attention_bwd"
#: fields of :func:`config`, in the order ``rt_flash_attention_bwd_config``
#: writes them
CONFIG_FIELDS = ("block_n", "block_m", "stages", "threads", "regs",
                 "producer_regs", "consumer_regs", "smem_bytes", "dot_regs",
                 "convert_regs")
#: the order in which the main kernel's CTAs take their tiles
TILE_ORDER = ("by a global atomic counter: (batch, KV head), then key tile "
              "from last to first")
#: query rows per tile of the main kernel (rowstats pads Sq to it)
BLOCK_M = 64
# (device, q, k, v, o, lse, do, dq, dk, dv, rowstats, dq_acc, counters, B,
#  Sq, Sk, H, KV, hd, causal, window, stream)
_BWD = build.Launcher(NAME, "rt_flash_attention_bwd",
                      [ctypes.c_int] + [ctypes.c_void_p] * 12
                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None):
    """Gradients (dq, dk, dv) of attention with respect to q (B,Sq,H,hd)
    and k, v (B,Sk,KV,hd), given the forward's output ``o``, its
    ``lse`` (B,H,Sq) float32 (``flash_attention(..., return_lse=True)``)
    and the output's gradient ``do``. Returned in q's, k's and v's dtypes.

    On the card the kernel takes what the forward takes (bf16, contiguous,
    16-byte aligned, hd in :data:`HEAD_DIMS`, H % KV == 0), and ``lse``
    contiguous float32; anything else raises ``ValueError``. Its result
    does not depend on the launch: dq's parts are summed in a fixed order.
    The scratch (row statistics, an fp32 dq accumulator, the counters) is
    allocated here and needs no zeroing. ``window`` W (>= 1) is the
    forward's causal sliding window (ignored without ``causal``); a query
    row that sees no key under it (past Sk + W - 1) gets dq = 0."""
    if window is not None and window < 1:
        raise ValueError(f"{NAME}: window {window} is not >= 1")
    if q.device.type == "cpu":
        dq, dk, dv = ref.attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    B, Sq, Sk, H, KV, hd = check_inputs(NAME, q, k, v, o, do)
    build.check_cuda(lse, torch.float32, 3, f"{NAME} lse")
    if lse.shape != (B, H, Sq) or lse.device != q.device:
        raise ValueError(f"{NAME}: lse {tuple(lse.shape)} is not (B, H, Sq) "
                         f"= {(B, H, Sq)} on q's device")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    win = min(int(window), 2**31 - 1) if causal and window is not None \
        else 0
    if Sq and B:
        n_qt = -(-Sq // BLOCK_M)
        if B * H * n_qt * BLOCK_M >= 2**31:
            # the dq accumulator's rows are a TMA coordinate (int32)
            raise ValueError(f"{NAME}: B * H * Sq = {B * H * Sq} rows is "
                             f"more than the kernel addresses")
        # lse * log2e and D = rowsum(dO * O) per row, padded to whole tiles
        rowstats = torch.empty((2, B, H, n_qt * BLOCK_M), dtype=torch.float32,
                               device=q.device)
        # dq's parts, summed in fp32 per (batch, head, query tile)
        dq_acc = torch.empty((B, H, n_qt * BLOCK_M, hd), dtype=torch.float32,
                             device=q.device)
        # one per (batch, head, query tile), then the tile-id counter
        counters = torch.empty(B * H * n_qt + 1, dtype=torch.int32,
                               device=q.device)
        _BWD(q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
             o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), rowstats.data_ptr(),
             dq_acc.data_ptr(), counters.data_ptr(), B, Sq, Sk, H, KV, hd,
             int(causal), win)
        if win and Sq > Sk + win - 1:
            dq[:, Sk + win - 1:] = 0     # rows that see no key
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def config(hd: int, device=None) -> dict:
    """The main kernel's launch configuration for head dim ``hd`` on a
    CUDA ``device``: its tile (``block_n`` keys, ``block_m`` query rows),
    ring stages, threads, registers per thread (at launch, and after
    ``setmaxnreg`` for the producer and consumer warpgroups), dynamic
    shared memory, the D pass's and the conversion's registers, and the
    order its CTAs take their tiles in. Builds the kernel if needed;
    launches nothing."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim {hd} not in {HEAD_DIMS}")
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    fn = build.c_function(NAME, "rt_flash_attention_bwd_config", [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * len(CONFIG_FIELDS))()
    err = fn(index, hd, out)
    if err:
        raise RuntimeError(f"{NAME} config query failed: CUDA error {err}")
    return {**dict(zip(CONFIG_FIELDS, out)), "tile_order": TILE_ORDER}
