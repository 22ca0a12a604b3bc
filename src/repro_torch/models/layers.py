"""Transformer building blocks of the port: attention (dense or in a
sliding window), the gated MLP and the top-k MoE FFN.

Counterpart of ``repro.models.layers``, with the reference's dtypes: the
datapath stays in the model dtype (bf16), softmax state and the Q.K^T
product run in float32, and ``p`` is cast to v's dtype before P.V.
Prefill attention goes through ``kernels.ops.attention``: the flash
kernel on the card, its plain block-pair version on the CPU. Decode
attention and the MoE FFN are plain PyTorch, as the reference computes
them outside any kernel.

On DTensors (the sharded path of ``models.lm``) both attentions run their
one-device code on local tensors through ``local_map``: the batch over
the mesh's data-parallel axes, the heads over 'model' where both H and KV
divide it, else replicated over 'model' (so the flash kernels and
``FlashAttention`` see plain tensors). ``rope`` mixes its plain tables in
under ``implicit_replication``. The MoE FFN runs its one-device code
through ``local_map`` too, each rank on its own batch rows and its own
experts (or its own columns of every expert's FFN dim, where the experts
do not divide 'model'), its output a partial sum over 'model'
(:func:`moe_ffn`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import is_dtensor
from ..kernels import ops
from ..kernels.ref import NEG, attn_qk, attn_sv

F32 = torch.float32


def row_dims(mesh, B: int) -> Tuple[int, ...]:
    """The mesh dims that split a batch of ``B`` rows: the data-parallel
    axes ('pod', 'data') where B divides their product, else none."""
    dp = [i for i, a in enumerate(mesh.mesh_dim_names)
          if a in ("pod", "data")]
    return tuple(dp) if B % math.prod(mesh.size(i) for i in dp) == 0 \
        else ()


def _head_placements(mesh, B: int, H: int, KV: int):
    """Placements of a (B, S, heads, hd) attention operand: the batch over
    the data-parallel axes where it divides them, the heads over 'model'
    where both H and KV divide it; else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    rows = row_dims(mesh, B)
    out = []
    for i, a in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if i in rows:
            out.append(Shard(0))
        elif a == "model" and H % n == 0 and KV % n == 0:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def _local_heads(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` on DTensors through ``local_map`` at
    :func:`_head_placements` (q's layout for the output)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    pl = _head_placements(mesh, q.shape[0], q.shape[2], k.shape[2])
    run = local_map(functools.partial(fn, **kw), out_placements=(pl,),
                    in_placements=(pl, pl, pl), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(q, k, v)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    # f32 only inside the variance reduction; the product stays in x's dtype
    var = x.float().square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding, half-split form. x: (..., S, H, hd); positions:
    (..., S) integer."""
    if is_dtensor(x):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return _rope(x, positions, theta)
    return _rope(x, positions, theta)


def _rope(x, positions, theta):
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
    """q: (B,S,H,hd), k/v: (B,Sk,KV,hd) -> (B,S,H,hd): self (causal, in a
    sliding ``window`` when given) or all-pairs (``causal=False``)
    attention through ``ops.attention`` (on DTensors through
    ``local_map``, module docstring)."""
    if is_dtensor(q):
        return _local_heads(block_causal_attention, q, k, v, window=window,
                            block=block, causal=causal)
    return ops.attention(q, k, v, causal=causal, block_q=block,
                         window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-position attention against a (possibly ring-buffered) cache.

    q: (B,1,H,hd); k/v_cache: (B,Sc,KV,hd); ``cache_len`` valid positions.
    With ``window`` the cache is a ring buffer of size Sc == window and all
    slots < min(cache_len, window) are valid."""
    if is_dtensor(q):
        return _local_heads(decode_attention, q, k_cache, v_cache,
                            cache_len=cache_len, window=window)
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


# ------------------------------------------------------------------- MoE

class Route(NamedTuple):
    """Where each token's ``k`` choices go, per batch row: expert, slot in
    that expert's capacity, whether it fits (a choice past the capacity is
    dropped), and its gate (renormalised over the top k, float32); all
    (B, sc, k). ``aux`` is the load-balance loss (float32 scalar), n_experts
    x sum(``me`` x ``ce``): ``me`` the router probabilities' mean over the
    chunk's tokens, ``ce`` the share of first choices each expert took,
    both (E,) float32 (None where a route is served, not computed)."""
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor
    me: Optional[torch.Tensor] = None
    ce: Optional[torch.Tensor] = None


def moe_capacity(sc: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots per expert and batch row for a chunk of ``sc`` tokens."""
    return int(math.ceil(capacity_factor * sc * top_k / n_experts / 4) * 4)


def moe_route(router: torch.Tensor, x: torch.Tensor, *, top_k: int,
              capacity: int,
              expert: Optional[torch.Tensor] = None) -> Route:
    """The reference's routing of one chunk x (B, sc, d): router logits in
    x's dtype then float32 softmax, top k (ties to the lower expert, as
    ``lax.top_k``), renormalised gates, and slots from the j-major
    position cumsum: the j-th choices of a batch row queue behind all of
    its earlier choices (``offset``). ``expert`` (B, sc, k), when given,
    replaces the top k: the gates are then those experts' probabilities,
    renormalised, and slots and aux follow from them (a replay of another
    run's choices, with this run's gradients: ``models.routes``)."""
    n_experts = router.shape[-1]
    logits = (x @ router).float()
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)                       # (B,sc,E)
    if expert is None:
        gate, expert = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        gate, expert = gate[..., :top_k], expert[..., :top_k]
    else:
        gate = torch.gather(probs, -1, expert)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert[..., 0], n_experts).float().mean(dim=(0, 1))
    aux = n_experts * torch.sum(me * ce)
    offset = torch.zeros((x.shape[0], n_experts), dtype=torch.int64,
                         device=x.device)
    slots = []
    for j in range(top_k):
        oh = F.one_hot(expert[..., j], n_experts)              # (B,sc,E)
        pos = torch.cumsum(oh, dim=1) - 1 + offset[:, None, :]
        slots.append((pos * oh).sum(-1))                       # (B,sc)
        offset = offset + oh.sum(dim=1)
    slot = torch.stack(slots, dim=-1)
    return Route(expert, slot, slot < capacity, gate, aux, me, ce)


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
            n_experts: int, top_k: int, capacity_factor: float,
            seq_chunk: int = 4096):
    """Top-k MoE with per-batch-row capacity: the reference's ``moe_ffn``.

    x: (B,S,d); params ``router`` (d,E), ``w1``/``w3`` (E,d,f), ``w2``
    (E,f,d). The sequence runs in chunks of ``sc`` tokens (the largest
    divisor of S up to ``seq_chunk``), each with C slots per expert and
    batch row. Dispatch and combine gather and scatter by index where the
    reference multiplies one-hot tensors: each kept choice puts its token
    in its (expert, slot), every expert runs its gated MLP over all C
    slots (empty ones hold zeros), and a token sums its kept choices'
    outputs times their gates in float32, cast to x's dtype as the
    reference casts its combine tensor. Returns (out (B,S,d), aux),
    ``aux`` averaged over the chunks.

    On DTensors (:func:`_moe_on_mesh`) each rank routes its own batch rows
    (the capacity is per row) and runs the experts, or the FFN columns,
    that its weights hold; the float32 sum of the picked outputs is a
    partial sum over 'model', reduced before the cast, and the aux loss's
    two means are reduced over the data-parallel axes before their
    product."""
    if is_dtensor(x):
        return _moe_on_mesh(params, x, n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor,
                            seq_chunk=seq_chunk)
    outs, auxs = [], []
    for out, r in _moe_chunks(params, x, n_experts=n_experts, top_k=top_k,
                              capacity_factor=capacity_factor,
                              seq_chunk=seq_chunk):
        outs.append(out.to(x.dtype))
        auxs.append(r.aux)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    aux = auxs[0] if len(auxs) == 1 else torch.stack(auxs).mean()
    return out, aux


def _moe_chunks(params, x, *, n_experts: int, top_k: int,
                capacity_factor: float, seq_chunk: int, first: int = 0):
    """Per chunk of x (B,S,d): (the float32 sum over its top-k choices of
    the picked outputs times their gates (B,sc,d), its :class:`Route`),
    for the experts ``first`` .. ``first`` + w1.shape[0] - 1 that
    ``params``' w1, w3 and w2 hold: all of them, or one rank's share. A
    choice of any other expert, or one dropped, goes to one spare row
    past the end, which nothing reads."""
    B, S, d = x.shape
    held = params["w1"].shape[0]
    sc = min(S, seq_chunk)
    while S % sc:
        sc -= 1
    C = moe_capacity(sc, n_experts, top_k, capacity_factor)
    rows = torch.arange(B, device=x.device)[:, None, None]
    spare = B * held * C
    for c0 in range(0, S, sc):
        xc = x[:, c0:c0 + sc]
        r = moe_route(params["router"], xc, top_k=top_k, capacity=C)
        own = r.expert - first
        keep = r.keep if held == n_experts else \
            r.keep & (own >= 0) & (own < held)
        # flat (batch row, expert, slot) index
        flat = torch.where(keep, (rows * held + own) * C + r.slot,
                           spare).reshape(-1)
        xe = xc.new_zeros((spare + 1, d))
        xe[flat] = xc[:, :, None, :].expand(B, sc, top_k, d).reshape(-1, d)
        xe = xe[:-1].view(B, held, C, d)
        h = torch.einsum("becd,edf->becf", xe, params["w1"])
        g = torch.einsum("becd,edf->becf", xe, params["w3"])
        ye = torch.einsum("becf,efd->becd", g * torch.sigmoid(g) * h,
                          params["w2"])
        ye = torch.cat([ye.reshape(-1, d), ye.new_zeros((1, d))])
        picked = ye[flat].view(B, sc, top_k, d).float()
        w = torch.where(r.keep, r.gate, 0.0).to(x.dtype).float()
        yield (picked * w[..., None]).sum(2), r


def _moe_on_mesh(params, x, **kw):
    """:func:`moe_ffn` on DTensors through ``local_map``, at the weights'
    at-use placements (``ModelSharding.pslice``: the reference's specs,
    'data' gathered). Over each mesh dim: a data-parallel axis that the
    batch divides splits the rows; 'model', where the weights are split
    over it, holds E/m experts on each rank (expert parallelism, w1, w3
    and w2 split on E) or every expert's f/m FFN columns (the reference's
    fallback where E does not divide: w1 and w3 split by columns, w2 by
    rows); any other dim replicates. The router is whole everywhere. Each
    rank dispatches its rows' kept choices of its experts into the
    one-device path's (row, expert, slot) positions, less its first
    expert. The float32 combine is then a partial sum over 'model'. The
    aux loss's means come back scaled by this rank's share of the rows,
    partial sums over the row dims, and over 'model' held by its first
    rank alone (every model rank routes alike), so that both are reduced
    before the product, as the one-device means are taken over the whole
    batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import local_shape_and_offset
    mesh = x.device_mesh
    w1 = params["w1"]
    rows = row_dims(mesh, x.shape[0])
    split = tuple(i for i, a in enumerate(mesh.mesh_dim_names)
                  if a == "model" and w1.placements[i].is_shard())
    ep = any(w1.placements[i].is_shard(0) for i in split)
    rep, part = Replicate(), Partial()

    def pl(on_rows, on_split):
        return tuple(on_rows if i in rows else on_split if i in split
                     else rep for i in range(mesh.ndim))
    w13_on, w2_on = (Shard(0), Shard(0)) if ep else (Shard(2), Shard(1))
    whole = pl(rep, rep)
    first = local_shape_and_offset(w1.shape, mesh, pl(rep, w13_on))[1][0] \
        if ep else 0
    coord = mesh.get_coordinate()
    share = (1.0 / math.prod(mesh.size(i) for i in rows)
             if all(coord[i] == 0 for i in split) else 0.0)

    def local(x, router, w1, w3, w2):
        outs, me, ce = [], [], []
        for out, r in _moe_chunks({"router": router, "w1": w1, "w3": w3,
                                   "w2": w2}, x, first=first, **kw):
            outs.append(out)
            me.append(r.me * share)
            ce.append(r.ce * share)
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        return out, torch.stack(me), torch.stack(ce)

    run = local_map(local, device_mesh=mesh, redistribute_inputs=True,
                    out_placements=(pl(Shard(0), part), pl(part, part),
                                    pl(part, part)),
                    in_placements=(pl(Shard(0), rep), whole,
                                   pl(rep, w13_on), pl(rep, w13_on),
                                   pl(rep, w2_on)),
                    in_grad_placements=(pl(Shard(0), part), pl(part, part),
                                        pl(part, w13_on), pl(part, w13_on),
                                        pl(part, w2_on)))
    out, me, ce = run(x, params["router"], params["w1"], params["w3"],
                      params["w2"])
    out = out.redistribute(mesh, pl(Shard(0), rep)).to(x.dtype)
    me, ce = me.redistribute(mesh, whole), ce.redistribute(mesh, whole)
    n_experts = kw["n_experts"]
    auxs = [n_experts * torch.sum(me[c] * ce[c]) for c in range(me.shape[0])]
    aux = auxs[0] if len(auxs) == 1 else torch.stack(auxs).mean()
    return out, aux
