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
one-device code on local tensors through ``local_map`` (so the flash
kernels and ``FlashAttention`` see plain tensors): the batch over the
mesh's data-parallel axes, the query heads over 'model' where H divides
it, each rank with the KV heads its query heads read (split alike where
KV divides 'model' too; else taken from k and v whole, their gradient a
partial sum over 'model'), and everything whole over 'model' only where H
does not divide it. Decode attention over a cache whose sequence is split
(over 'model' under ``cache_seq_model``, over 'data' under
``seq_shard_cache``) scores each rank's own slots and reduces a two-pass
softmax across the shards (:func:`_decode_on_mesh`); no rank gathers the
cache. ``rope`` mixes its plain tables in
under ``implicit_replication``. The MoE FFN runs its one-device code
through ``local_map`` too, each rank on its own batch rows and its own
experts (or its own columns of every expert's FFN dim, where the experts
do not divide 'model'), its output a partial sum over 'model'
(:func:`moe_ffn`).
"""
from __future__ import annotations

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
    """Placements of a (B, S, heads, hd) attention's q (and its output)
    and of its k and v: the batch over the data-parallel axes where it
    divides them; over 'model', where H divides it, q's heads split (each
    rank its H / m query heads) and k's and v's alike where KV divides it
    too, else whole (each rank then takes the KV heads that its query
    heads read: :func:`_on_ranks`); where H does not divide 'model', all
    whole over it (the reference's spec leaves q whole there too)."""
    from torch.distributed.tensor import Replicate, Shard
    rows = row_dims(mesh, B)
    q_pl, kv_pl = [], []
    for i, a in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if i in rows:
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
        elif a == "model" and H % n == 0:
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2) if KV % n == 0 else Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    return tuple(q_pl), tuple(kv_pl)


def _cache_placements(mesh, H: int, pls):
    """Decode attention's placements from its cache's ``pls`` (a (B, Sc,
    KV, hd) cache: :func:`sharding.cache_spec`): (q's and the output's,
    the mesh dims of more than one rank that split the cache's
    sequence). Over each mesh dim: q's rows split where the
    cache splits its rows, and its heads where the cache splits its KV
    heads; q whole where the cache splits its sequence; q's heads split
    over a 'model' axis that H divides and over which the cache holds its
    KV heads whole (:func:`_head_placements`)."""
    from torch.distributed.tensor import Replicate, Shard
    q_pl, seq = [], []
    for i, p in enumerate(pls):
        n = mesh.size(i)
        if p.is_shard(1):
            q_pl.append(Replicate())
            if n > 1:
                seq.append(i)
        elif p.is_shard(0) or p.is_shard(2):
            q_pl.append(p)
        elif n > 1 and mesh.mesh_dim_names[i] == "model" and H % n == 0:
            q_pl.append(Shard(2))
        else:
            q_pl.append(Replicate())
    return tuple(q_pl), tuple(seq)


def _kv_for_heads(mesh, q_pl, kv_pl, H: int, KV: int):
    """The mesh dims over which q's heads are split and k's and v's are
    whole, and, where there is one ('model'), the KV heads that this
    rank's query heads read: query head h reads KV head h // (H / KV).
    Returns (those dims, a function of a (B, S, KV, hd) tensor or None):
    its heads that hold whole groups of this rank's query heads (one, or
    several), so that the local GQA ratio stays whole; where the rank's
    heads straddle two groups, one KV head per query head."""
    sel = tuple(i for i in range(mesh.ndim)
                if q_pl[i].is_shard(2) and not kv_pl[i].is_shard(2))
    if not sel:
        return sel, None
    dim = sel[0]
    hl, g = H // mesh.size(dim), H // KV
    h0 = mesh.get_coordinate()[dim] * hl
    heads = [h // g for h in range(h0, h0 + hl)]
    if hl % g == 0 or g % hl == 0:
        a, b = heads[0], heads[-1] + 1
        return sel, lambda t: t[:, :, a:b].contiguous()
    return sel, lambda t: torch.cat([t[:, :, j:j + 1] for j in heads],
                                    dim=2)


def _on_ranks(fn, q, k, v, q_pl, kv_pl, **kw):
    """``fn(q, k, v, **kw)`` on this rank's local tensors through
    ``local_map``: q (and the output) at ``q_pl``, k and v at ``kv_pl``.
    Where q's heads are split over a mesh dim over which k and v are
    whole, the rank takes the KV heads its query heads read
    (:func:`_kv_for_heads`), and the gradient of k and v is a partial
    sum over that dim: each rank's query heads give their share."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    sel, take = _kv_for_heads(mesh, q_pl, kv_pl, q.shape[2], k.shape[2])
    grad_pl = tuple(Partial() if i in sel else p
                    for i, p in enumerate(kv_pl))

    def local(q, k, v):
        if take is not None:
            k, v = take(k), take(v)
        return fn(q, k, v, **kw)
    run = local_map(local, out_placements=(q_pl,),
                    in_placements=(q_pl, kv_pl, kv_pl),
                    in_grad_placements=(q_pl, grad_pl, grad_pl),
                    device_mesh=mesh, redistribute_inputs=True)
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
        q_pl, kv_pl = _head_placements(q.device_mesh, q.shape[0],
                                       q.shape[2], k.shape[2])
        return _on_ranks(block_causal_attention, q, k, v, q_pl, kv_pl,
                         window=window, block=block, causal=causal)
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
        return _decode_on_mesh(q, k_cache, v_cache, cache_len, window)
    s = _decode_scores(q, k_cache, cache_len, window, k_cache.shape[1])
    p = torch.softmax(s, dim=-1)
    return attn_sv(p, v_cache)


def _decode_scores(q, k, cache_len: int, window: Optional[int], Sc: int,
                   first: int = 0):
    """q's float32 scores (B,H,1,Sk) over the cache slots ``first`` ..
    ``first`` + Sk - 1 of a cache of ``Sc`` (k: (B,Sk,KV,hd)), NEG at
    the slots past ``cache_len`` (past min(``cache_len``, Sc) in the ring
    of a ``window``)."""
    s = attn_qk(q, k) / math.sqrt(q.shape[-1])
    n_valid = min(cache_len, Sc) if window is not None else cache_len
    valid = torch.arange(first, first + k.shape[1], device=q.device) \
        < n_valid
    return torch.where(valid, s, NEG)


def _decode_on_mesh(q, k_cache, v_cache, cache_len: int,
                    window: Optional[int]):
    """:func:`decode_attention` on DTensors, at the cache's placements
    (:func:`_cache_placements`). Where no mesh dim splits the cache's
    sequence, each rank runs the one-device code on its rows and heads
    (:func:`_on_ranks`). Where one does, q is whole over it and each rank
    scores every head of its rows over its own slots, masked by their
    global indices; the softmax is then taken in two passes over the
    sequence shards, as the one-device softmax takes it: the rows' max
    (reduced by max), the sum of exp(s - max) (a partial sum, reduced),
    p = exp(s - max) / sum cast to v's dtype as ``attn_sv`` casts it,
    and each rank's products p v in float32, a partial sum over the
    shards, reduced before the cast to v's dtype. No rank gathers the
    cache; what moves is (B, H) maxima and sums and the (B, H, hd)
    products (the reference's "partial softmax per shard + psum")."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import local_shape_and_offset
    mesh = q.device_mesh
    H, KV, Sc = q.shape[2], k_cache.shape[2], k_cache.shape[1]
    kv_pl = tuple(k_cache.placements)
    q_pl, seq = _cache_placements(mesh, H, kv_pl)
    if not seq:
        return _on_ranks(decode_attention, q, k_cache, v_cache, q_pl, kv_pl,
                         cache_len=cache_len, window=window)
    take = _kv_for_heads(mesh, q_pl, kv_pl, H, KV)[1] or (lambda t: t)
    first = local_shape_and_offset(k_cache.shape, mesh, kv_pl)[1][1]
    rep = Replicate()

    def pl(heads_at, on_seq):
        """Placements of a tensor with rows at dim 0 and heads at
        ``heads_at``, ``on_seq`` over the sequence's mesh dims."""
        return tuple(on_seq if i in seq else Shard(heads_at) if p.is_shard(2)
                     else p for i, p in enumerate(q_pl))
    s_pl, o_pl = pl(1, Shard(3)), pl(2, rep)

    def scores(q, k):
        s = _decode_scores(q, take(k), cache_len, window, Sc, first)
        return s, s.amax(-1)

    def exps(s, mx):
        e = torch.exp(s - mx[..., None])
        return e, e.sum(-1)

    def products(e, total, v):
        p = e / total[..., None]
        return attn_sv(p.to(v.dtype).float(), take(v).float())

    run = local_map(scores, out_placements=(s_pl, pl(1, Partial("max"))),
                    in_placements=(q_pl, kv_pl), device_mesh=mesh,
                    redistribute_inputs=True)
    s, mx = run(q, k_cache)
    run = local_map(exps, out_placements=(s_pl, pl(1, Partial())),
                    in_placements=(s_pl, pl(1, rep)), device_mesh=mesh,
                    redistribute_inputs=True)
    e, total = run(s, mx.redistribute(mesh, pl(1, rep)))
    run = local_map(products, out_placements=(pl(2, Partial()),),
                    in_placements=(s_pl, pl(1, rep), kv_pl),
                    device_mesh=mesh, redistribute_inputs=True)
    out = run(e, total.redistribute(mesh, pl(1, rep)), v_cache)
    return out.redistribute(mesh, o_pl).to(v_cache.dtype)


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
