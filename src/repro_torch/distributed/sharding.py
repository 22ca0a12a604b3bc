"""128-bit KEY-RANGE sharding for the VCS Δ/merge pipeline.

The key-cut half of ``repro.distributed.sharding`` (the model-parameter
partitioning half belongs to the model stack, which is not ported yet).
Sealed objects and Δ streams are sorted by 128-bit key signature, so
merge and diff aggregation are embarrassingly partitionable on key
ranges. ``plan_key_cuts`` picks boundary keys by rank-sum over the
presorted runs; ``kernels.ops`` executes the plan byte-identically to the
unsharded path. Shard plans are DERIVED state — a pure function of the
immutable lanes and the device count — and are never WAL-logged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..kernels import ops as _ops

#: shard sizing: one shard per ~object-capacity of stream rows
KEY_SHARD_TARGET_ROWS = 1 << 18
#: auto-sharding floor: below this, split/concat overhead beats the win
KEY_SHARD_MIN_ROWS = 1 << 20
#: cap on auto shard counts (plan cost is runs x cuts searchsorteds)
KEY_SHARD_MAX = 16

_FORCED_KEY_SHARDS: Optional[int] = None


def set_key_shards(n: Optional[int]) -> Optional[int]:
    """Force the shard count (tests / operators); ``None`` restores the
    auto policy. Returns the previous override so callers can restore."""
    global _FORCED_KEY_SHARDS
    prev = _FORCED_KEY_SHARDS
    _FORCED_KEY_SHARDS = n
    return prev


def key_shard_count(n_rows: int) -> int:
    """How many key-range shards an ``n_rows`` merge/aggregate should use.

    1 (off) below KEY_SHARD_MIN_ROWS; above it, a host with several CUDA
    devices splits one shard per device, and otherwise the stream splits
    into object-capacity-sized partitions. Outputs are byte-identical
    either way."""
    if _FORCED_KEY_SHARDS is not None:
        return max(1, int(_FORCED_KEY_SHARDS))
    if n_rows < KEY_SHARD_MIN_ROWS:
        return 1
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        return min(n_dev, KEY_SHARD_MAX)
    return int(min(KEY_SHARD_MAX, max(2, n_rows // KEY_SHARD_TARGET_ROWS)))


def plan_key_cuts(lo: torch.Tensor, hi: torch.Tensor, runs: np.ndarray,
                  shards: int):
    """Boundary keys splitting presorted runs into ``shards`` balanced
    key ranges, by rank-sum over the run starts.

    Candidates are each run's local quantile keys; a candidate's global
    rank is the sum over runs of its exact 128-bit lower bound, and the
    candidate nearest each target rank ``i*n/shards`` wins. Returns
    ``(cut_lo, cut_hi)`` word tensors — ascending, distinct, possibly
    fewer than ``shards - 1`` — or ``None`` when no usable interior
    boundary exists."""
    n = int(lo.shape[0])
    runs = np.asarray(runs, np.int64)
    k = runs.shape[0]
    if shards <= 1 or n == 0 or k <= 1:
        return None
    bounds = np.append(runs, n)
    cand_parts = []
    for r in range(k):
        a, b = int(bounds[r]), int(bounds[r + 1])
        if b > a:
            cand_parts.append(
                a + (np.arange(1, shards, dtype=np.int64) * (b - a)) // shards)
    if not cand_parts:
        return None
    cand_idx = torch.from_numpy(np.concatenate(cand_parts)).to(lo.device)
    c_lo, c_hi = lo[cand_idx], hi[cand_idx]
    ranks = torch.zeros((cand_idx.shape[0],), dtype=torch.int64,
                        device=lo.device)
    for r in range(k):
        a, b = int(bounds[r]), int(bounds[r + 1])
        ranks += _ops.searchsorted128(lo[a:b], hi[a:b], c_lo, c_hi,
                                      side="left")
    ranks = ranks.cpu().numpy()
    # candidate keys as unsigned python ints: the plan is host metadata
    keys_lo = c_lo.cpu().numpy().view(np.uint64)
    keys_hi = c_hi.cpu().numpy().view(np.uint64)
    chosen = []
    for j in range(1, shards):
        target = (j * n) // shards
        pick = int(np.argmin(np.abs(ranks - target)))
        rank = int(ranks[pick])
        key = (int(keys_lo[pick]), int(keys_hi[pick]))
        # degenerate cuts (empty first/last shard) and non-ascending picks
        # are dropped: fewer shards, never a wrong plan
        if rank <= 0 or rank >= n or (chosen and key <= chosen[-1]):
            continue
        chosen.append(key)
    if not chosen:
        return None
    cut = np.array(chosen, np.uint64).view(np.int64)
    cut = torch.from_numpy(np.ascontiguousarray(cut)).to(lo.device)
    return cut[:, 0].contiguous(), cut[:, 1].contiguous()


def maybe_key_cuts(lo: torch.Tensor, hi: torch.Tensor, runs):
    """The one-call shard plan: ``None`` (stay unsharded) unless the
    stream is big enough AND has real multi-run structure to merge."""
    if runs is None or runs.shape[0] <= 1:
        return None
    shards = key_shard_count(int(lo.shape[0]))
    if shards <= 1:
        return None
    return plan_key_cuts(lo, hi, runs, shards)
