"""Plain PyTorch oracles for the hand-written CUDA kernels.

These are the semantic ground truth of the port, written with ordinary
tensor operations so they run on any device: the CPU path of every kernel
wrapper, and the version each CUDA kernel is held against on the card.
The integer ones are bit-identical to ``repro.kernels.ref``; the
attention one follows ``repro.models.layers.block_causal_attention``
(float math, held to it by a tolerance).

Word conventions (ROADMAP "Unsigned words"): a uint64 word is carried as
an int64 tensor with the same bits, and a uint32 lane as an int32 tensor
with the same bits. Order-sensitive work flips the sign bit
(:func:`flip`), which maps unsigned order onto signed order. 32-bit hash
arithmetic runs in int64 masked to 32 bits.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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
    return lower_bound_sides(tab, q, 0 if side == "right" else q.shape[0])


def lower_bound_sides(tab: torch.Tensor, q: torch.Tensor,
                      n_left: int) -> torch.Tensor:
    """:func:`lower_bound` with a side per query: "left" for
    ``q[:n_left]``, "right" for the rest (the kernel's second entry)."""
    n = tab.shape[0]
    if n == 0 or q.shape[0] == 0:
        return torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    t, k = flip(tab), flip(q)
    right = torch.arange(q.shape[0], device=q.device) >= n_left
    base = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    length = n
    while length > 1:
        half = length >> 1
        v = t[base + half]
        go = (v < k) | (right & (v == k))
        base = base + go.to(torch.int64) * half
        length -= half
    v = t[base]
    return base + ((v < k) | (right & (v == k))).to(torch.int64)


def _less128(a_lo, a_hi, b_lo, b_hi):
    """(a_lo, a_hi) < (b_lo, b_hi), lo primary, on sign-flipped words."""
    return (a_lo < b_lo) | ((a_lo == b_lo) & (a_hi < b_hi))


def probe(t_lo: torch.Tensor, t_hi: torch.Tensor, q_lo: torch.Tensor,
          q_hi: torch.Tensor):
    """Fused 128-bit probe of a (lo, hi)-sorted table: per query the exact
    lower bound ``start`` and the equal-key run length ``cnt`` (int64).
    A lower- and an upper-bound descent share one fixed-depth loop; the
    CUDA kernel reaches the same two numbers by other paths (a tile's
    shared-memory sample, a forward scan for the run)."""
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


# ------------------------------------------------------------- attention

#: the masked score: finite, so a row that is masked so far keeps a finite
#: running max (as the reference kernels have it)
NEG = -1e30


def attn_qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B,bq,H,hd) x (B,bk,KV,hd) -> (B,H,bq,bk) float32 scores, query
    heads grouped onto their KV head (GQA). The product runs in float32,
    as the reference's ``preferred_element_type=F32``."""
    B, bq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, bq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    return s.reshape(B, H, bq, k.shape[1])


def attn_sv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,H,bq,bk) x (B,bk,KV,hd) -> (B,bq,H,hd) in v's dtype: ``p`` is
    cast to v's dtype first, as in the reference."""
    B, H, bq, bk = p.shape
    KV = v.shape[2]
    pg = p.reshape(B, KV, H // KV, bq, bk)
    o = torch.einsum("bkgqs,bskh->bqkgh", pg.to(v.dtype), v)
    return o.reshape(B, bq, H, v.shape[3])


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, block: int = 1024,
              window: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention over block pairs: the algorithm of the
    reference's ``block_causal_attention``.

    q: (B,S,H,hd); k/v: (B,Sk,KV,hd), H % KV == 0. Causal masking is
    top-left (query i sees keys <= i); keys are padded to the block and
    masked. Block pairs run in qi-major order with float32 running max,
    denominator and numerator; block pairs above the diagonal are skipped.
    A causal ``window`` W also masks keys with i - j >= W (query i sees
    keys i - W + 1 .. i) and skips the block pairs wholly below it, as the
    reference does; without ``causal`` the window is ignored, as there.
    Returns (B,S,H,hd) in q's dtype.
    """
    return attention_lse(q, k, v, causal=causal, block=block,
                         window=window)[0]


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, block: int = 1024,
                  window: Optional[int] = None):
    """:func:`attention` and the natural-log sum of exponentials of each
    query row's scaled, masked scores (the softmax's log-normalizer):
    returns (out (B,S,H,hd) in q's dtype, lse (B,H,S) float32). ``out``
    is :func:`attention`'s, bit for bit."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    block = min(block, S, Sk)
    while S % block:        # largest q-block size that tiles the sequence
        block -= 1
    pad_k = (-Sk) % block
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    n_k = (Sk + pad_k) // block
    windowed = causal and window is not None
    scale = 1.0 / math.sqrt(hd)
    row = torch.arange(block, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), device=q.device)
    for qi in range(S // block):
        qs = q[:, qi * block:(qi + 1) * block]
        m = torch.full((B, H, block), -math.inf, device=q.device)
        l = torch.zeros((B, H, block), device=q.device)
        acc = torch.zeros((B, H, block, hd), device=q.device)
        for ki in range(min(qi + 1, n_k) if causal else n_k):
            if windowed and qi * block - (ki * block + block - 1) >= window:
                continue            # the pair lies wholly below the window
            ks = k[:, ki * block:(ki + 1) * block]
            vs = v[:, ki * block:(ki + 1) * block]
            s = attn_qk(qs, ks) * scale                     # (B,H,bq,bk)
            kpos = ki * block + row[None, :]
            mask = kpos < Sk
            if causal:
                qpos = qi * block + row[:, None]
                mask = mask & (qpos >= kpos)
                if windowed:
                    mask = mask & (qpos - kpos < window)
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + \
                attn_sv(p, vs).float().transpose(1, 2)
            m = m_new
        l = torch.clamp(l, min=1e-30)
        o = acc / l[..., None]
        out[:, qi * block:(qi + 1) * block] = o.transpose(1, 2).to(q.dtype)
        lse[:, :, qi * block:(qi + 1) * block] = m + torch.log(l)
    return out, lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None):
    """Gradients of :func:`attention` with respect to q, k and v: the
    textbook recompute backward, all in float32.

    With scores S = q.k^T * scale (masked as the forward masks them:
    top-left causal, within the sliding ``window`` W when given, which is
    ignored without ``causal``; or all pairs) and the forward's ``lse``
    (B,H,Sq): D = rowsum(dO * O), P = exp(S - lse) (0 where masked),
    dV = P^T.dO, dS = P * (dO.V^T - D), dQ = dS.K * scale,
    dK = dS^T.Q * scale. dK and dV of a KV head sum over its H / KV query
    heads. A query row that sees no key (only under a window, past
    Sk + W - 1) gets dQ = 0. Returns (dq, dk, dv) float32, shaped like q,
    k and v."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, KV, G, hd)
    dof = do.float().reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) * scale
    p = torch.exp(s - lse.float().reshape(B, KV, G, Sq)[..., None])
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        keep = qpos >= kpos
        if window is not None:
            keep = keep & (qpos - kpos < window)
        p = torch.where(keep, p, 0.0)
    d = (dof * o.float().reshape(B, Sq, KV, G, hd)).sum(-1)  # (B,Sq,KV,G)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf).reshape(B, Sq, H, hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf)
    return dq * scale, dk * scale, dv
