"""State-space mixers of the port: Mamba (SSD, chunked form) and RWKV6
(Finch), plain functions on tensors.

Counterpart of ``repro.models.ssm``, step for step and dtype for dtype.
The scans are written as the reference writes them: intra-chunk terms as
batched products, the state carried from chunk to chunk by a loop over
S / chunk steps (the reference's ``lax.scan``), whose (B, c, c, heads)
decay tensor lives for one step only. A prompt whose length is not a
multiple of ``CHUNK`` runs the largest chunk that divides it, as the
reference does, which changes the rounding but not the result.

Dtypes, as in the reference: decay, state and ``u`` math in float32; the
mamba matmul stream (``v`` and each chunk's ``y``) in the model dtype,
with the q.k product upcast (the reference's ``preferred_element_type``);
rwkv6's r/k/v heads in float32. The mamba decode step computes ``v`` in
float32 where the chunked form keeps it in the model dtype: in bf16 the
two forms differ by that rounding (the reference's design, ROADMAP
Queue 3); in float32 they agree.

Shapes: x (B, S, d). Each mixer has a prefill form (the whole sequence,
returning the final state) and a one-token decode form.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

F32 = torch.float32
CHUNK = 64
_LOGW_MIN = -0.5        # mamba per-token log-decay clamp
_LOGW_MIN_RWKV = -0.25  # rwkv: exp(-cumsum) appears; tighter bound for f32

Params = Dict[str, torch.Tensor]


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus switches to x past a
    # threshold
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo), the reference's ``jnp.maximum`` against a scalar: the
    same values as ``torch.clamp(x, min=lo)``, and at a tie (x == lo) the
    gradient split in half between x and the bound, as JAX splits it
    (``clamp`` would pass all of it to x)."""
    return torch.maximum(x, x.new_full((), lo))


def _chunk(S: int, chunk: int) -> int:
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    return chunk


def _split_bcdt(x: torch.Tensor, p: Params, d_state: int):
    xi, z = (x @ p["w_in"]).chunk(2, dim=-1)                 # (B,S,di)
    bcdt = x @ p["w_bcdt"]
    return (xi, z, bcdt[..., :d_state], bcdt[..., d_state:2 * d_state],
            bcdt[..., 2 * d_state:])


def _conv(xi_p: torch.Tensor, conv_w: torch.Tensor, S: int) -> torch.Tensor:
    """The causal conv: taps k = 0..d_conv-1 summed in that order."""
    return sum(xi_p[:, k:k + S, :] * conv_w[k][None, None]
               for k in range(conv_w.shape[0]))


# =========================================================== Mamba (SSD)

def mamba_mix(p: Params, x: torch.Tensor, state: Optional[Tuple] = None, *,
              d_state: int, head_dim: int, d_conv: int, chunk: int = CHUNK):
    """Chunked SSD mixer. x (B,S,d); state (conv (B, d_conv-1, di), ssm
    (B, nh, ds, hp) float32) or None. Returns (y (B,S,d), new state)."""
    B, S, d = x.shape
    di = p["w_in"].shape[1] // 2
    nh = di // head_dim
    xi, z, B_, C_, dt = _split_bcdt(x, p, d_state)
    pad = xi.new_zeros((B, d_conv - 1, di)) if state is None else state[0]
    xi_p = torch.cat([pad, xi], dim=1)
    new_conv = xi_p[:, -(d_conv - 1):, :] if d_conv > 1 else pad
    xi = _silu(_conv(xi_p, p["conv"], S))

    dt = _softplus(dt.float() + p["dt_bias"])                 # (B,S,nh)
    a_log = -torch.exp(p["a_log"].float())                     # (nh,) < 0
    logw = _floor(dt * a_log[None, None], _LOGW_MIN)          # (B,S,nh)
    # the matmul stream stays in the model dtype; decay/state math in f32
    v = xi.reshape(B, S, nh, head_dim) * dt[..., None].to(xi.dtype)
    y, new_ssm = _chunked_decay_attn(
        C_, B_, v, logw, chunk=chunk, state=None if state is None
        else state[1])
    y = y + xi.reshape(B, S, nh, head_dim) \
        * p["d_skip"].to(xi.dtype)[None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype) * _silu(z)
    return y @ p["w_out"], (new_conv, new_ssm)


def _chunked_decay_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logw: torch.Tensor, *, chunk: int = CHUNK,
                        state: Optional[torch.Tensor] = None):
    """Linear attention with a scalar decay per head (the SSD identity):
    h_t = exp(logw_t) h_{t-1} + k_t (x) v_t, y_t = q_t . h_t.

    q, k (B,S,ds); v (B,S,nh,hp); logw (B,S,nh) float32. Returns (y
    (B,S,nh,hp) in v's dtype, final state (B,nh,ds,hp) float32)."""
    B, S, ds = q.shape
    nh, hp = v.shape[2], v.shape[3]
    c = _chunk(S, chunk)
    h = q.new_zeros((B, nh, ds, hp), dtype=F32) if state is None else state
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    ys = []
    for t0 in range(0, S, c):
        qt, kt, vt = q[:, t0:t0 + c], k[:, t0:t0 + c], v[:, t0:t0 + c]
        lwt = torch.cumsum(logw[:, t0:t0 + c], dim=1)          # (B,c,nh)
        qf, kf, vf = qt.float(), kt.float(), vt.float()
        att = qf @ kf.transpose(1, 2)                          # (B,i,j) f32
        ddec = lwt[:, :, None, :] - lwt[:, None, :, :]         # (B,i,j,nh)
        w_ij = torch.where(mask[None, :, :, None], torch.exp(ddec), 0.0)
        # att (x) w_ij first: the (B,c,c,nh,hp) product never exists
        aw = (att[..., None] * w_ij).permute(0, 3, 1, 2)       # (B,nh,i,j)
        y = (aw @ vf.transpose(1, 2)).transpose(1, 2)          # (B,i,nh,hp)
        y = y + torch.exp(lwt)[..., None] * torch.einsum(
            "bis,bhsp->bihp", qf, h)
        kdec = torch.exp(lwt[:, -1:, :] - lwt)                 # (B,c,nh)
        h = h * torch.exp(lwt[:, -1, :])[:, :, None, None] \
            + torch.einsum("bjs,bjhp->bhsp", kf, kdec[..., None] * vf)
        ys.append(y.to(v.dtype))
    return torch.cat(ys, dim=1) if len(ys) > 1 else ys[0], h


def mamba_decode(p: Params, x: torch.Tensor, state: Tuple, *, d_state: int,
                 head_dim: int, d_conv: int):
    """One token. x (B,1,d); state (conv, ssm) as :func:`mamba_mix`'s."""
    B, _, d = x.shape
    di = p["w_in"].shape[1] // 2
    nh = di // head_dim
    xi, z, B_, C_, dt = _split_bcdt(x, p, d_state)
    conv_state, h = state
    xi_p = torch.cat([conv_state, xi], dim=1)                  # (B,d_conv,di)
    new_conv = xi_p[:, 1:, :]
    xi = _silu(_conv(xi_p, p["conv"], 1))
    dt = _softplus(dt.float() + p["dt_bias"])
    a_log = -torch.exp(p["a_log"].float())
    w = torch.exp(_floor(dt * a_log[None, None], _LOGW_MIN))
    v = xi.reshape(B, 1, nh, head_dim).float() * dt[..., None]
    h = h * w[:, 0, :, None, None] \
        + B_[:, 0].float()[:, None, :, None] * v[:, 0][:, :, None, :]
    y = torch.einsum("bs,bhsp->bhp", C_[:, 0].float(), h)[:, None]
    y = y + xi.reshape(B, 1, nh, head_dim).float() \
        * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype) * _silu(z)
    return y @ p["w_out"], (new_conv, h)


# ================================================================ RWKV6

def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B,S,d); prev (B,1,d), the last token of the previous segment."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_proj(p: Params, x: torch.Tensor, xs: torch.Tensor):
    """r, k, v, g (model dtype) and the decay's float32 argument, each from
    x mixed with its shifted self."""
    def mix(mu):
        return x + (xs - x) * mu[None, None]

    r = mix(p["mu_r"]) @ p["w_r"]
    k = mix(p["mu_k"]) @ p["w_k"]
    v = mix(p["mu_v"]) @ p["w_v"]
    g = mix(p["mu_g"]) @ p["w_g"]
    wr = mix(p["mu_w"]) @ p["w_dec"] + p["dec_bias"]
    return r, k, v, g, wr


def _rwkv_out(p: Params, y: torch.Tensor, g: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Per-head group norm of y (B,S,H,dv) float32, gated by silu(g)."""
    B, S, H, dv = y.shape
    mu2 = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(mu2 + 1e-5)
         * p["ln_x"].reshape(H, dv)[None, None]).reshape(B, S, H * dv)
    return (y.to(x.dtype) * _silu(g)) @ p["w_o"]


def rwkv6_mix(p: Params, x: torch.Tensor, state: Optional[Tuple] = None, *,
              head_dim: int, chunk: int = CHUNK):
    """Chunked WKV6: linear attention with a data-dependent decay per
    channel. x (B,S,d); state (shift (B,1,d), wkv (B,H,dk,dv) float32) or
    None. Returns (y, new state)."""
    B, S, d = x.shape
    H = p["w_r"].shape[1] // head_dim       # the heads whose columns p holds
    dk = dv = head_dim
    prev = x.new_zeros((B, 1, d)) if state is None else state[0]
    h = x.new_zeros((B, H, dk, dv), dtype=F32) if state is None \
        else state[1]
    r, k, v, g, wr = _rwkv_proj(p, x, _token_shift(x, prev))
    # data-dependent decay w in (0,1): log w = -exp(wr), clamped
    logw = _floor(-torch.exp(wr.float()), _LOGW_MIN_RWKV)
    rh = r.reshape(B, S, H, dk).float()
    kh = k.reshape(B, S, H, dk).float()
    vh = v.reshape(B, S, H, dv).float()
    lwh = logw.reshape(B, S, H, dk)
    u = p["u"].float()                                         # (H,dk)

    c = _chunk(S, chunk)
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril(-1)
    ys = []
    for t0 in range(0, S, c):
        rt, kt, vt = rh[:, t0:t0 + c], kh[:, t0:t0 + c], vh[:, t0:t0 + c]
        lwt_tok = lwh[:, t0:t0 + c]
        lw = torch.cumsum(lwt_tok, dim=1)                      # (B,c,H,dk)
        # the decay applies strictly between j and i:
        # w(j,i) = exp(lw_{i-1} - lw_j) = exp((lw_i - logw_i) - lw_j)
        r_dec = rt * torch.exp(lw - lwt_tok)
        k_dec = kt * torch.exp(-lw)
        att = torch.einsum("bihk,bjhk->bijh", r_dec, k_dec)
        att = torch.where(mask[None, :, :, None], att, 0.0)
        diag = (rt * u * kt).sum(-1)                           # (B,c,H)
        y = torch.einsum("bijh,bjhv->bihv", att, vt) + diag[..., None] * vt
        y = y + torch.einsum("bihk,bhkv->bihv", r_dec, h)
        kdec = kt * torch.exp(lw[:, -1:] - lw)
        h = h * torch.exp(lw[:, -1])[..., None] \
            + torch.einsum("bjhk,bjhv->bhkv", kdec, vt)
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return _rwkv_out(p, y, g, x), (x[:, -1:, :], h)


def rwkv6_decode(p: Params, x: torch.Tensor, state: Tuple, *,
                 head_dim: int):
    """One WKV6 token. x (B,1,d); state as :func:`rwkv6_mix`'s."""
    B = x.shape[0]
    H = p["w_r"].shape[1] // head_dim
    dk = dv = head_dim
    prev, h = state
    r, k, v, g, wr = _rwkv_proj(p, x, prev)
    w = torch.exp(_floor(-torch.exp(wr.float()), _LOGW_MIN_RWKV))
    rh = r.reshape(B, H, dk).float()
    kh = k.reshape(B, H, dk).float()
    vh = v.reshape(B, H, dv).float()
    wh = w.reshape(B, H, dk)
    u = p["u"].float()
    kv = kh[..., :, None] * vh[..., None, :]                   # (B,H,dk,dv)
    y = torch.einsum("bhk,bhkv->bhv", rh, h + u[None, :, :, None] * kv)
    h = h * wh[..., None] + kv
    return _rwkv_out(p, y.reshape(B, 1, H, dv), g, x), (x, h)


# ====================================================== on a device mesh

#: each mixer weight's dim of heads, split over 'model' where the heads
#: are (None: whole on every rank). mamba's ``w_in`` is viewed (d, 2, di)
#: so that its split takes each head's ``xi`` and ``z`` columns together,
#: and ``w_bcdt`` is cut into B and C (``bc``, shared by every head) and
#: the per-head ``dt`` columns. rwkv's ``w_o`` is row-parallel at use.
_HEAD_DIM = {
    "mamba": {"w_in": 2, "bc": None, "dt": 1, "conv": 1, "a_log": 0,
              "dt_bias": 0, "d_skip": 0, "w_out": 0},
    "rwkv": {"mu_r": None, "mu_k": None, "mu_v": None, "mu_g": None,
             "mu_w": None, "w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1,
             "w_dec": 1, "dec_bias": 0, "u": 0, "ln_x": 0, "w_o": 0}}
#: each recurrent state's dim of heads: mamba (conv, ssm), rwkv (shift,
#: wkv); rwkv's token shift holds the whole (B, 1, d) input row
_STATE_HEAD_DIM = {"mamba": (2, 1), "rwkv": (None, 1)}


def mix_on_mesh(kind: str, fn, p: Params, x: torch.Tensor,
                state: Optional[Tuple] = None, **kw):
    """``fn``, a mixer of ``kind`` ("mamba" or "rwkv"): its prefill form
    (:func:`mamba_mix`, :func:`rwkv6_mix`) or its one-token form
    (:func:`mamba_decode`, :func:`rwkv6_decode`), over x on DTensors, run
    by each rank on local tensors through ``local_map``. Over each mesh
    dim: a data-parallel axis that the batch divides splits the rows, and
    'model' splits the heads where the reference's specs split the
    mixer's projections over it (mamba's ``w_out`` rows, rwkv's ``w_r``
    columns) and the heads divide it; any other dim replicates. A head's
    chunk loop and decode step need nothing of the other heads. The
    weights go from their at-use placements to :data:`_HEAD_DIM`'s:
    mamba's ``w_in`` and ``w_bcdt`` are gathered whole over 'model'
    (mamba's split of ``w_in``'s 2 di columns gives one rank all of
    ``xi`` on a 2-wide axis), rwkv's ``w_o`` goes from column- to
    row-parallel (an all-to-all of its shards). The output is then a
    partial sum over 'model' (a row-parallel projection), the state
    placed by :data:`_STATE_HEAD_DIM` (``state`` taken there from the
    cache's placements at use). Returns (y, new state), as ``fn``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .layers import row_dims
    mesh, rep, part = x.device_mesh, Replicate(), Partial()
    whole = (rep,) * mesh.ndim
    if kind == "mamba":
        d, two_di = p["w_in"].shape
        bcdt = p["w_bcdt"].redistribute(mesh, whole)
        ns = 2 * kw["d_state"]
        w = {"w_in": p["w_in"].redistribute(mesh, whole)
             .reshape(d, 2, two_di // 2),
             "bc": bcdt[:, :ns], "dt": bcdt[:, ns:]}
        w.update((n, p[n]) for n in ("conv", "a_log", "dt_bias", "d_skip",
                                     "w_out"))
        marker, at, n_heads = p["w_out"], 0, p["w_out"].shape[0]
    else:
        w = {n: p[n] for n in _HEAD_DIM["rwkv"]}
        marker, at, n_heads = p["w_r"], 1, p["w_r"].shape[1]
    n_heads //= kw["head_dim"]
    rows = row_dims(mesh, x.shape[0])
    heads = tuple(i for i, a in enumerate(mesh.mesh_dim_names)
                  if a == "model" and marker.placements[i].is_shard(at)
                  and n_heads % mesh.size(i) == 0)

    def pl(on_rows, on_heads):
        return tuple(on_rows if i in rows else on_heads if i in heads
                     else rep for i in range(mesh.ndim))

    def on(dim):
        return rep if dim is None else Shard(dim)
    names = list(w)
    head_dim = _HEAD_DIM[kind]
    st_dims = _STATE_HEAD_DIM[kind]
    st = tuple(state) if state is not None else ()
    in_pl = ((pl(Shard(0), rep),)
             + tuple(pl(rep, on(head_dim[n])) for n in names)
             + tuple(pl(Shard(0), on(s)) for s in st_dims[:len(st)]))
    grad_pl = ((pl(Shard(0), part),)
               + tuple(pl(part, part if head_dim[n] is None
                          else Shard(head_dim[n])) for n in names)
               + in_pl[1 + len(names):])
    out_pl = (pl(Shard(0), part),) + tuple(pl(Shard(0), on(s))
                                           for s in st_dims)

    def local(x, *ts):
        lw = dict(zip(names, ts))
        if kind == "mamba":
            lw["w_in"] = lw["w_in"].reshape(lw["w_in"].shape[0], -1)
            lw["w_bcdt"] = torch.cat([lw.pop("bc"), lw.pop("dt")], dim=1)
        y, new = fn(lw, x, ts[len(names):] or None, **kw)
        return (y, *new)

    run = local_map(local, out_placements=out_pl, in_placements=in_pl,
                    in_grad_placements=grad_pl, device_mesh=mesh,
                    redistribute_inputs=True)
    y, *new = run(x, *w.values(), *st)
    return y, tuple(new)
