"""The kernel contract the core engine calls, on torch tensors.

Counterpart of ``repro.kernels.ops``. Every op takes and returns tensors
and dispatches on the tensor's device: the six kernel wrappers
(``rowhash``, ``searchsorted``, ``segsum_diff``, ``probe``,
``flash_attention``, ``flash_attention_bwd``) launch their CUDA kernel
for a CUDA tensor and run their plain version for a CPU one.

Signature convention: a 64-bit word is an int64 tensor holding the uint64
bits; a row signature is two words (lo, hi) and sorts lexicographically
with lo primary, in unsigned order (``ref.flip`` maps it onto int64
order). Run-start offsets (``starts``/``runs``) are small host metadata
and stay numpy int64, like oids.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import ref
from .flash_attention import flash_attention as _flash_kernel
from .flash_attention_bwd import flash_attention_bwd as _flash_bwd_kernel
from .probe import probe as _probe_kernel
from .rowhash import signatures as _rowhash_kernel
from .searchsorted import searchsorted as _searchsorted_kernel
from .searchsorted import searchsorted_sides as _searchsorted_sides_kernel
from .segsum_diff import segsum as _segsum_kernel

flip = ref.flip
M32 = ref.M32


def _i64(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.int64, device=device)


# ---------------------------------------------------------------- packing

def pack64(hi32: torch.Tensor, lo32: torch.Tensor) -> torch.Tensor:
    """uint32 values (any int dtype) -> uint64 words as int64 bits."""
    return ((hi32.to(torch.int64) & M32) << 32) | (lo32.to(torch.int64) & M32)


def unpack64(w: torch.Tensor):
    """uint64 words (int64 bits) -> (hi32, lo32) as int64 in [0, 2**32)."""
    return (w >> 32) & M32, w & M32


# ---------------------------------------------------------------- rowhash

def rowhash(lanes: torch.Tensor) -> torch.Tensor:
    """(R, C) int32 lanes -> (R, 4) int32 signature words (uint32 bits)."""
    lo, hi = signatures_from_lanes(lanes)
    return torch.stack([lo, hi], dim=1).view(torch.int32)


def signatures_from_lanes(lanes: torch.Tensor):
    """(R, C) int32 lanes -> (sig_lo, sig_hi) (R,) int64 words."""
    return _rowhash_kernel(lanes.contiguous())


# ------------------------------------------------------------ lower bound

def lower_bound(sorted_w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """First index i with sorted[i] >= q (unsigned), per query; int64."""
    return _searchsorted_kernel(sorted_w.contiguous(), q.contiguous(),
                                "left")


def upper_bound(sorted_w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """First index i with sorted[i] > q (unsigned), per query; int64.
    The kernel takes the side directly: no ``q + 1`` trick, no guard for
    the maximum word."""
    return _searchsorted_kernel(sorted_w.contiguous(), q.contiguous(),
                                "right")


def lower_upper_bound(sorted_w: torch.Tensor, q: torch.Tensor,
                      n_left: int) -> torch.Tensor:
    """``lower_bound`` of ``q[:n_left]`` and ``upper_bound`` of
    ``q[n_left:]`` (unsigned), in one launch; int64."""
    return _searchsorted_sides_kernel(sorted_w.contiguous(), q.contiguous(),
                                      n_left)


def searchsorted128(t_lo: torch.Tensor, t_hi: torch.Tensor,
                    q_lo: torch.Tensor, q_hi: torch.Tensor,
                    side: str = "left") -> torch.Tensor:
    """Exact 128-bit searchsorted against a stream sorted by (lo, hi).

    Primary ranks come from the searchsorted kernel on the lo word.
    Queries whose lo word is in the table refine against the hi word in
    one gather + compare (runs of one row, the common case for hashed
    signatures); genuine lo64 collisions count the hi words below the
    query inside their lo run."""
    n = t_lo.shape[0]
    if q_lo.shape[0] == 0 or n == 0:
        return _i64(q_lo.shape[0], q_lo.device)
    lb = lower_bound(t_lo, q_lo)
    out = lb.clone()
    hit = (lb < n) & (t_lo[lb.clamp(max=n - 1)] == q_lo)
    # the matched run extends past lb only on a genuine lo64 collision
    multi = hit & (lb + 1 < n) & (t_lo[(lb + 1).clamp(max=n - 1)] == q_lo)
    one = hit & ~multi
    if bool(one.any()):
        idx = lb[one]
        th, qh = flip(t_hi[idx]), flip(q_hi[one])
        after = (th < qh) if side == "left" else (th <= qh)
        out[one] = idx + after.to(torch.int64)
    midx = torch.nonzero(multi).flatten()
    if midx.shape[0]:
        s = lb[midx]
        ub = upper_bound(t_lo, q_lo[midx])
        seg, base, flat = segment_expand(s, ub - s)
        th, qh = flip(t_hi[flat]), flip(q_hi[midx][seg])
        below = ((th < qh) if side == "left" else (th <= qh))
        out[midx] = s + _i64(midx.shape[0], s.device).index_add_(
            0, seg, below.to(torch.int64))
    return out


def probe128(t_lo: torch.Tensor, t_hi: torch.Tensor,
             q_lo: torch.Tensor, q_hi: torch.Tensor):
    """Fused probe of a (lo, hi)-key-sorted table: per query key the exact
    128-bit lower bound ``start`` (defined for misses too — where the key
    would insert) and the equal-key run length ``cnt`` (0 == absent), both
    from one fixed-depth descent of the probe kernel. Queries SHOULD arrive
    sorted by (lo, hi); correctness never depends on it."""
    return _probe_kernel(t_lo.contiguous(), t_hi.contiguous(),
                         q_lo.contiguous(), q_hi.contiguous())


def segment_expand(starts: torch.Tensor, lens: torch.Tensor):
    """Expand per-segment (start, len) pairs into flat element indices.

    Returns (seg, base, flat): ``seg[j]`` is the segment owning flat slot
    j, ``base[i]`` the first flat slot of segment i, and ``flat[j]`` the
    source index. Callers must pre-filter zero-length segments."""
    dev = starts.device
    total = int(lens.sum())
    seg = torch.repeat_interleave(
        torch.arange(lens.shape[0], device=dev), lens, output_size=total)
    base = torch.cumsum(lens, 0) - lens
    flat = starts[seg] + (torch.arange(total, dtype=torch.int64, device=dev)
                          - base[seg])
    return seg, base, flat


# --------------------------------------------------------- diff aggregate

class DiffAgg:
    """Result of diff aggregation over a sorted signed stream.

    Attributes:
      boundary:   (N,) bool  — new-run start flags.
      run_starts: (K,) int64 — index of each run's first element.
      run_lens:   (K,) int64
      run_sums:   (K,) int32 — net sign per run (0 == fully cancelled).
      run_ids:    (N,) int64 — run index per element (computed lazily).

    ``csum`` is the segsum kernel's inclusive cumulative sum of the signs;
    each run's net sign is a difference of two of its entries."""

    __slots__ = ("boundary", "run_starts", "_n", "_run_lens", "run_sums",
                 "_run_ids")

    def __init__(self, boundary: torch.Tensor, csum: torch.Tensor):
        self.boundary = boundary
        self.run_starts = torch.nonzero(boundary).flatten()
        n = boundary.shape[0]
        self._n = n
        if n:
            # gather two entries per run in int32, then widen: the same
            # bits as widening the whole stream first
            ends = torch.cat([self.run_starts[1:],
                              torch.tensor([n], device=csum.device)])
            sums = csum[ends - 1].to(torch.int64)
            sums[1:] -= csum[self.run_starts[1:] - 1].to(torch.int64)
            self.run_sums = sums.to(torch.int32)
        else:
            self.run_sums = torch.zeros((0,), dtype=torch.int32,
                                        device=boundary.device)
        self._run_lens = None
        self._run_ids = None

    @property
    def run_lens(self) -> torch.Tensor:
        if self._run_lens is None:
            ends = torch.cat([self.run_starts[1:], torch.tensor(
                [self._n], device=self.run_starts.device)])
            self._run_lens = ends - self.run_starts
        return self._run_lens

    @property
    def run_ids(self) -> torch.Tensor:
        if self._run_ids is None:
            self._run_ids = torch.cumsum(self.boundary, 0) - 1
        return self._run_ids


def _empty_agg(device):
    return (_i64(0, device),
            DiffAgg(torch.zeros((0,), dtype=torch.bool, device=device),
                    torch.zeros((0,), dtype=torch.int32, device=device)))


def _sort128(sig_lo: torch.Tensor, sig_hi: torch.Tensor) -> torch.Tensor:
    """Lexicographic argsort by (sig_lo, sig_hi), unsigned, stable:
    ``np.lexsort((sig_hi, sig_lo))``. Two stable passes, secondary word
    first."""
    # lint: sort-ok this IS the sort kernel — radix passes are its body
    order = torch.sort(flip(sig_hi), stable=True).indices
    lo = flip(sig_lo)[order]
    # lint: sort-ok this IS the sort kernel — radix passes are its body
    return order[torch.sort(lo, stable=True).indices]


def merge128_runs(lo: torch.Tensor, hi: torch.Tensor,
                  starts: np.ndarray, *, cuts=None) -> torch.Tensor:
    """Stable merge permutation for concatenated presorted runs.

    ``starts`` (k,) holds each run's first offset (``starts[0] == 0``);
    run i spans ``[starts[i], starts[i+1])`` and is sorted by (lo, hi).
    Returns ``order`` such that ``lo[order], hi[order]`` is the stable
    k-way merge — identical to ``np.lexsort((hi, lo))`` on the whole
    stream (ties resolved by run order, then in-run position).

    ``cuts`` (optional) is a key-range shard plan from
    ``distributed.sharding.plan_key_cuts``; the merge then runs per shard
    and concatenates, byte-identical to the unsharded merge. The merge
    itself is a stable 128-bit sort, which a GPU does in a few passes."""
    n = lo.shape[0]
    starts = np.asarray(starts, np.int64)
    if n == 0 or starts.shape[0] <= 1:
        return torch.arange(n, dtype=torch.int64, device=lo.device)
    if cuts is not None and cuts[0].shape[0]:
        return _merge128_sharded(lo, hi, starts, cuts)
    return _sort128(lo, hi)


def _merge128_sharded(lo: torch.Tensor, hi: torch.Tensor,
                      starts: np.ndarray, cuts) -> torch.Tensor:
    """Key-range-sharded stable k-way merge, byte-identical to unsharded.

    Every run is split at the exact 128-bit LOWER bound of each cut key —
    the same rule in every run — so equal keys never straddle shards, and
    per-shard stable merges concatenated in cut order reproduce the global
    stable merge permutation element for element."""
    cut_lo, cut_hi = cuts
    n = lo.shape[0]
    dev = lo.device
    k = starts.shape[0]
    s = cut_lo.shape[0] + 1
    bounds = np.append(starts, n)
    split = np.empty((k, s + 1), np.int64)
    for r in range(k):
        a, b = int(bounds[r]), int(bounds[r + 1])
        split[r, 0], split[r, s] = a, b
        split[r, 1:s] = a + searchsorted128(lo[a:b], hi[a:b], cut_lo,
                                            cut_hi, side="left").cpu().numpy()
    parts = []
    for j in range(s):
        gidx, run_starts, off = [], [], 0
        for r in range(k):
            a, b = int(split[r, j]), int(split[r, j + 1])
            if b > a:
                run_starts.append(off)
                off += b - a
                gidx.append(torch.arange(a, b, dtype=torch.int64,
                                         device=dev))
        if not gidx:
            continue
        piece = gidx[0] if len(gidx) == 1 else torch.cat(gidx)
        if len(run_starts) > 1:
            sub = merge128_runs(lo[piece], hi[piece],
                                np.asarray(run_starts, np.int64))
            piece = piece[sub]
        parts.append(piece)
    if not parts:
        return _i64(0, dev)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def diff_aggregate(sig_lo: torch.Tensor, sig_hi: torch.Tensor,
                   signs: torch.Tensor, *, presorted: bool = False):
    """Sort a signed stream by 128-bit signature and aggregate runs.

    Returns (order, DiffAgg): ``order`` is the permutation applied
    (identity if presorted). Runs are maximal groups of equal (sig_lo,
    sig_hi). The stream is scanned by one segsum call on either device:
    its flags and sums are byte-identical to the reference's key-range
    slices at any shard count."""
    n = sig_lo.shape[0]
    dev = sig_lo.device
    if n == 0:
        return _empty_agg(dev)
    signs = signs.to(torch.int32)
    if presorted:
        order = torch.arange(n, dtype=torch.int64, device=dev)
        s_lo, s_hi, s_sg = sig_lo, sig_hi, signs
    else:
        order = _sort128(sig_lo, sig_hi)
        s_lo, s_hi, s_sg = sig_lo[order], sig_hi[order], signs[order]
    return order, DiffAgg(*_segsum_kernel(s_lo.contiguous(),
                                          s_hi.contiguous(),
                                          s_sg.contiguous()))


def diff_aggregate_rows(key_lo: torch.Tensor, key_hi: torch.Tensor,
                        row_lo: torch.Tensor, row_hi: torch.Tensor,
                        signs: torch.Tensor, *, presorted: bool = False):
    """Aggregate a signed stream into (key, row-signature) runs along KEY
    order — the sort-free execution of Listing-2 value grouping.

    The stream must be (or is stably made) sorted by (key_lo, key_hi);
    runs are maximal groups of equal (key, row). For NoPK streams the key
    IS the row signature (the same tensor), and the segsum kernel compares
    one word pair; otherwise it ORs the row pair's change flags in, in the
    same pass. The stream is scanned by one segsum call on either device:
    its flags and sums are byte-identical to the reference's slices aligned
    to KEY-run starts at any shard count. Returns (order, DiffAgg)."""
    n = key_lo.shape[0]
    dev = key_lo.device
    if n == 0:
        return _empty_agg(dev)
    signs = signs.to(torch.int32)
    if presorted:
        order = torch.arange(n, dtype=torch.int64, device=dev)
        k_lo, k_hi, r_lo, r_hi = key_lo, key_hi, row_lo, row_hi
        s_sg = signs
    else:
        order = _sort128(key_lo, key_hi)
        k_lo, k_hi = key_lo[order], key_hi[order]
        r_lo, r_hi = row_lo[order], row_hi[order]
        s_sg = signs[order]
    same = r_lo is k_lo and r_hi is k_hi  # NoPK: key IS the row signature
    return order, DiffAgg(*_segsum_kernel(
        k_lo.contiguous(), k_hi.contiguous(), s_sg.contiguous(),
        None if same else r_lo.contiguous(),
        None if same else r_hi.contiguous()))


# --------------------------------------------------------- attention entry

class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the flash kernel forward, which also
    keeps each row's log-sum-exp, and the backward kernel from it (on a
    CPU tensor their plain versions, ``ref.attention_lse`` and
    ``ref.attention_bwd``), both with the causal sliding window when one
    is given. A build or launch error raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block: int,
                window: Optional[int] = None):
        o, lse = _flash_kernel(q, k, v, causal=causal, block=block,
                               return_lse=True, window=window)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_kernel(q, k, v, o, lse, do.contiguous(),
                                       causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, block_q: int = 256,
              block_k: int = 256,
              window: Optional[int] = None) -> torch.Tensor:
    """Attention of the model stack (counterpart of the reference's
    ``ops.attention``). q: (B,S,H,hd); k/v: (B,Sk,KV,hd), H % KV == 0.

    A CUDA tensor runs the flash kernel (query heads read their KV head in
    place; tiles fixed by the kernel); a CPU tensor runs the plain
    version over ``block_q``-sized block pairs, as the reference's XLA
    path does. Where autograd records (a tensor that requires grad), the
    call goes through :class:`FlashAttention`, so its gradient is the
    backward kernel's; without it the forward alone runs. A causal
    ``window`` W restricts query i to keys i - W + 1 .. i, in both kernels
    on the card and both plain versions on the CPU. ``block_k`` is
    kept for the reference's signature: neither path reads it (the
    reference's XLA path does not either)."""
    del block_k
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, block_q, window)
    return _flash_kernel(q, k, v, causal=causal, block=block_q,
                         window=window)
