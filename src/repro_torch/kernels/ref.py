"""Plain PyTorch oracles for the hand-written CUDA kernels.

These are the semantic ground truth of the port, written with ordinary
tensor operations so they run on any device: the CPU path of every kernel
wrapper, and the version each CUDA kernel is held against on the card.
They are bit-identical to ``repro.kernels.ref`` (integer math only).

Word conventions (ROADMAP "Unsigned words"): a uint64 word is carried as
an int64 tensor with the same bits, and a uint32 lane as an int32 tensor
with the same bits. Order-sensitive work flips the sign bit
(:func:`flip`), which maps unsigned order onto signed order. 32-bit hash
arithmetic runs in int64 masked to 32 bits.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
#: the int64 sign bit; ``x ^ SIGN`` maps uint64 order onto int64 order
SIGN = -(1 << 63)

_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35
_LANE_C1 = 0x9E3779B1
_LANE_C2 = 0x95D0BE4F
_SALT_S = 0x7F4A7C15
SEEDS = (0x2545F491, 0x8C2E1B6D, 0x64E6D3A5, 0x5851F42D)


def flip(x: torch.Tensor) -> torch.Tensor:
    """uint64 bits (as int64) -> int64 keys with the same order."""
    return x ^ SIGN


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit avalanche finalizer on int64 holding uint32."""
    h = h ^ (h >> 16)
    h = (h * _FMIX_C1) & M32
    h = h ^ (h >> 13)
    h = (h * _FMIX_C2) & M32
    return h ^ (h >> 16)


def rowhash(lanes: torch.Tensor) -> torch.Tensor:
    """(R, C) int32 lanes -> (R, 4) int32 signature words [lo.lo, lo.hi,
    hi.lo, hi.hi] (uint32 bits). The four seeded chains run side by side
    as the columns of one (R, 4) tensor."""
    r, c = lanes.shape
    dev = lanes.device
    x = lanes.to(torch.int64) & M32
    s = torch.arange(4, dtype=torch.int64, device=dev)
    h = torch.tensor(SEEDS, dtype=torch.int64, device=dev).expand(r, 4)
    for j in range(c):
        # lane-position salt keeps permuted columns distinct
        salt = ((j * 2 + 1) * _LANE_C1 + s * _SALT_S) & M32
        h = fmix32(h ^ ((x[:, j:j + 1] * _LANE_C1 + salt) & M32))
        h = (h * _LANE_C2 + 1) & M32
    return fmix32(h ^ c).to(torch.int32)


def signatures(lanes: torch.Tensor):
    """(R, C) int32 lanes -> (sig_lo, sig_hi) int64 words, packed as
    ``lo = w1 << 32 | w0`` and ``hi = w3 << 32 | w2``."""
    w = rowhash(lanes).to(torch.int64) & M32
    return (w[:, 1] << 32) | w[:, 0], (w[:, 3] << 32) | w[:, 2]


def lower_bound(tab: torch.Tensor, q: torch.Tensor,
                side: str = "left") -> torch.Tensor:
    """Branchless fixed-depth bound of uint64 queries in an ascending
    uint64 table (both int64 bits): numpy ``searchsorted(tab, q, side)``.
    The same descent the CUDA kernel runs, one query per element."""
    n = tab.shape[0]
    if n == 0 or q.shape[0] == 0:
        return torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    t, k = flip(tab), flip(q)
    right = side == "right"
    base = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    length = n
    while length > 1:
        half = length >> 1
        v = t[base + half]
        go = (v <= k) if right else (v < k)
        base = base + go.to(torch.int64) * half
        length -= half
    v = t[base]
    return base + ((v <= k) if right else (v < k)).to(torch.int64)


def _less128(a_lo, a_hi, b_lo, b_hi):
    """(a_lo, a_hi) < (b_lo, b_hi), lo primary, on sign-flipped words."""
    return (a_lo < b_lo) | ((a_lo == b_lo) & (a_hi < b_hi))


def probe(t_lo: torch.Tensor, t_hi: torch.Tensor, q_lo: torch.Tensor,
          q_hi: torch.Tensor):
    """Fused 128-bit probe of a (lo, hi)-sorted table: per query the exact
    lower bound ``start`` and the equal-key run length ``cnt`` (int64).
    Both descents share one fixed-depth loop, as in the CUDA kernel."""
    n = t_lo.shape[0]
    nq = q_lo.shape[0]
    dev = q_lo.device
    if n == 0 or nq == 0:
        z = torch.zeros((nq,), dtype=torch.int64, device=dev)
        return z, z.clone()
    tl, th = flip(t_lo), flip(t_hi)
    kl, kh = flip(q_lo), flip(q_hi)
    bl = torch.zeros((nq,), dtype=torch.int64, device=dev)
    bu = torch.zeros((nq,), dtype=torch.int64, device=dev)
    length = n
    while length > 1:
        half = length >> 1
        ml, mu = bl + half, bu + half
        gl = _less128(tl[ml], th[ml], kl, kh)
        gu = ~_less128(kl, kh, tl[mu], th[mu])
        bl = bl + gl.to(torch.int64) * half
        bu = bu + gu.to(torch.int64) * half
        length -= half
    lb = bl + _less128(tl[bl], th[bl], kl, kh).to(torch.int64)
    ub = bu + (~_less128(kl, kh, tl[bu], th[bu])).to(torch.int64)
    return lb, ub - lb


def segsum(lo: torch.Tensor, hi: torch.Tensor, signs: torch.Tensor,
           r_lo=None, r_hi=None):
    """Diff aggregation scan over a key-sorted signed stream: new-run
    boundary flags (row 0 always starts a run; an optional second word
    pair ORs its change flags in) and the inclusive int32 cumsum of the
    signs over the whole stream."""
    n = lo.shape[0]
    bnd = torch.empty((n,), dtype=torch.bool, device=lo.device)
    if n:
        bnd[0] = True
        neq = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        if r_lo is not None:
            neq |= (r_lo[1:] != r_lo[:-1]) | (r_hi[1:] != r_hi[:-1])
        bnd[1:] = neq
    csum = torch.cumsum(signs.to(torch.int32), 0, dtype=torch.int32)
    return bnd, csum
