"""Transformer building blocks of the port (dense attention + gated MLP).

Counterpart of ``repro.models.layers``, with the reference's dtypes: the
datapath stays in the model dtype (bf16), softmax state and the Q.K^T
product run in float32, and ``p`` is cast to v's dtype before P.V.
Prefill attention goes through ``kernels.ops.attention``: the flash
kernel on the card, its plain block-pair version on the CPU. Decode
attention is plain PyTorch, as the reference has no kernel for it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..kernels import ops
from ..kernels.ref import NEG, attn_qk, attn_sv

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    # f32 only inside the variance reduction; the product stays in x's dtype
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding, half-split form. x: (..., S, H, hd); positions:
    (..., S) integer."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32,
                                          device=x.device) / half))
    ang = positions[..., :, None, None].to(F32) * freqs   # (...,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def block_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, window: Optional[int] = None,
                           block: int = 1024,
                           causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,Sk,KV,hd) -> (B,S,H,hd): self (causal) or
    all-pairs (``causal=False``) attention through ``ops.attention``."""
    if window is not None:
        raise NotImplementedError(
            "sliding-window attention is not ported yet (ROADMAP Queue 1)")
    return ops.attention(q, k, v, causal=causal, block_q=block)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-position attention against a (possibly ring-buffered) cache.

    q: (B,1,H,hd); k/v_cache: (B,Sc,KV,hd); ``cache_len`` valid positions.
    With ``window`` the cache is a ring buffer of size Sc == window and all
    slots < min(cache_len, window) are valid."""
    hd = q.shape[-1]
    Sc = k_cache.shape[1]
    s = attn_qk(q, k_cache) / math.sqrt(hd)               # (B,H,1,Sc)
    n_valid = min(cache_len, Sc) if window is not None else cache_len
    valid = torch.arange(Sc, device=q.device) < n_valid
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    return attn_sv(p, v_cache)


def gated_mlp(params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    h = x @ params["w1"]
    g = x @ params["w3"]
    return (g * torch.sigmoid(g) * h) @ params["w2"]
