"""The LM of the port: a decoder of attention, cross-attention, Mamba or
RWKV6 mixers, each with a gated-MLP or top-k MoE FFN, attention dense or
in a sliding window; and, for an encoder-decoder config (whisper), a
non-causal encoder whose output every decoder layer attends.

Counterpart of ``repro.models.lm`` for every slot kind it has: ``attn``,
``cross``, ``mamba`` and ``rwkv``, with learned absolute positions where
the config asks. Layers are a ``ModuleList`` run in a Python loop in
place of the reference's ``lax.scan`` over stacked periods; layer ``l``
is period ``l // period``, slot ``l % period`` of the reference's
parameter tree, and encoder layer ``e`` is row ``e`` of its stacked
``encoder`` tree. The mixers of the state-space slots are
``models.ssm``'s.

Entry points (the reference's, as methods):
  LM(cfg, device=None, generator=None)   -> weights drawn from a seed
  forward(tokens, ctx=None, remat=False) -> logits (B, S, V)
  loss_fn(model, batch, remat=False)     -> scalar loss (a function)
  init_cache(B, seq_cap, ctx_len=0)      -> zero decode cache (also a
                                            function of the config)
  prefill(tokens, ctx=None, seq_cap=...) -> (last_logits (B, V), cache)
  decode_step(token, cache)              -> (logits (B, V), cache)
  encode(frames)                         -> the encoder's output

``ctx`` (B, L, d_model) is the stub frontend's output, as in the
reference: whisper's frame embeddings, which the encoder runs over, or
the patch embeddings a ``cross`` slot attends. A config with either
raises ``ValueError`` without one. The context is cast to the model's
dtype first (the reference's einsums promote a bf16 context against
float32 weights, which is the same values; ``torch.matmul`` takes one
dtype).

The cache has the reference's layout: ``{"len": n, "slot<i>": ...}``. An
attention slot holds ``{"k", "v"}`` of shape (P, B, cap, KV, hd) in the
model dtype, ``cap`` being ``seq_cap``, or min(``seq_cap``, W) under a
sliding window W, where the cache is a ring; in an encoder-decoder
config also the cross sublayer's ``{"xk", "xv"}``, (P, B, L, KV, hd). A
``cross`` slot holds ``{"ck", "cv"}``, (P, B, L, KV, hd). The cross K/V
are filled at prefill from the context and only read by decode. A
state-space slot holds
the tuple of its layers' final states, stacked over the periods: mamba
(conv (P, B, d_conv-1, di) in the model dtype, ssm (P, B, nh, ds, hp)
float32), rwkv (shift (P, B, 1, d) in the model dtype, wkv (P, B, H, hd,
hd) float32). ``len`` is a Python int here (the reference keeps an int32
scalar). ``decode_step`` writes the new position's k/v and the new
recurrent states into the cache tensors in place (the reference returns
updated copies) and returns the cache with ``len + 1``; without a window
the k/v slot it writes is past the old ``len``, so an attention-only
cache still reads the same, while a state-space slot's old state is
gone.

Under a window, a prefill of S > W positions keeps the last W in slots
0..W-1 and decode writes position ``pos`` at slot ``pos % cap``, as the
reference does (``repro/models/lm.py`` ``forward`` and
``_run_slot_decode``). When S is not a multiple of W the two disagree, so
decode then evicts an in-window position and keeps a stale one: a fault
of the reference that the port keeps for parity (ROADMAP Queue 3).

The weights are created frozen, for serving. The forward is
differentiable: a trainer turns gradients on with ``requires_grad_()``,
and attention then runs through the flash kernel's autograd function
(``kernels.ops.FlashAttention``), whose backward is a kernel too.

Sharded: ``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take
``shd``, a ``distributed.sharding.ModelSharding``, at the reference's
sites: each encoder layer's weights (``encslice``) and input (``act``),
the embedding (``embed``, then ``act``), each layer's weights
(``pslice``) and input (``act``), the head (``head``). The weights,
tokens, context and cache are then DTensors on its mesh (``launch.steps``
places them), and every op computes the global function, as the
reference's partitioner does. ``shd=None`` is the one-device path,
unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distributed.sharding import is_dtensor, split_heads, write
from . import ssm
from .layers import (block_causal_attention, decode_attention, gated_mlp,
                     moe_ffn, rms_norm, rope)

F32 = torch.float32
BF16 = torch.bfloat16
#: the mixers with a recurrent state in place of a KV cache
SSM_KINDS = ("mamba", "rwkv")
#: an rwkv layer's token-shift mixing coefficients
RWKV_MU = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")
#: a cache's cross K/V entries, (K, V) pairs: an encoder-decoder
#: attention slot's, a cross slot's
CROSS_KV = (("xk", "xv"), ("ck", "cv"))


def _check_supported(cfg: ArchConfig) -> None:
    """Raise unless the port's LM runs ``cfg``: attention (dense or
    windowed), cross-attention, mamba and rwkv slots with MLP or MoE
    FFNs."""
    if (not set(cfg.slot_kinds()) <= {"attn", "cross", *SSM_KINDS}
            or not set(cfg.ffn_kinds()) <= {"mlp", "moe"}):
        raise NotImplementedError(
            f"{cfg.name}: the port's LM runs attn, cross, mamba and rwkv "
            f"layers with MLP or MoE FFNs only (slots {cfg.slot_kinds()}, "
            f"ffn {cfg.ffn_kinds()})")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.Module):
    """One mixer + FFN layer: the mixer ``kind`` "attn", "cross", "mamba"
    or "rwkv", the FFN ``ffn`` "mlp" or "moe". Its weights carry the
    reference's slot key names and shapes (``wq`` is (d, H*hd):
    activations multiply from the left, as in the reference's einsums;
    a "cross" layer's ``wk``/``wv`` project the context; an "attn" layer
    of an encoder-decoder config also holds the cross sublayer's
    ``ln_x`` (d,) and ``xq``/``xk``/``xv`` (d, H*hd or KV*hd), ``xo``
    (H*hd, d), unless it is an ``encoder`` layer, which has no biases
    either;
    the MoE's ``router`` is (d, E), ``moe_w1``/``moe_w3`` (E, d, d_ff),
    ``moe_w2`` (E, d_ff, d)). A mamba layer holds ``w_in`` (d, 2 di),
    ``w_bcdt`` (d, 2 ds + nh), ``w_out`` (di, d), ``conv`` (d_conv, di)
    and, in float32 whatever the model dtype, ``a_log``, ``dt_bias`` and
    ``d_skip`` (nh,); an rwkv layer ``mu_*`` (d,), ``w_r``/``w_k``/
    ``w_v``/``w_g``/``w_dec``/``w_o`` (d, d), ``ln_x`` (d,) and, in
    float32, ``dec_bias`` (d,) and ``u`` (H, hd)."""

    def __init__(self, cfg: ArchConfig, kind: str, ffn: str, dense, full,
                 encoder: bool = False):
        super().__init__()
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.kind = kind
        self.ssm = cfg.ssm
        self.shape = (H, KV, hd)
        self.moe = cfg.moe if ffn == "moe" else None
        self.ln1, self.ln2 = full(d, 1.0), full(d, 1.0)
        self.qkv_bias = False
        self.cross_sublayer = False
        if kind in ("attn", "cross"):
            self.wq = dense((d, H * hd))
            self.wk = dense((d, KV * hd))
            self.wv = dense((d, KV * hd))
            self.wo = dense((H * hd, d))
            self.qkv_bias = cfg.qkv_bias and not encoder
            if self.qkv_bias:
                self.bq, self.bk, self.bv = (full(H * hd, 0.0),
                                             full(KV * hd, 0.0),
                                             full(KV * hd, 0.0))
            self.cross_sublayer = (kind == "attn" and cfg.is_encdec
                                   and not encoder)
            if self.cross_sublayer:
                self.ln_x = full(d, 1.0)
                self.xq = dense((d, H * hd))
                self.xk = dense((d, KV * hd))
                self.xv = dense((d, KV * hd))
                self.xo = dense((H * hd, d))
        elif kind == "mamba":
            s = cfg.ssm
            di = s.expand * d
            nh = di // s.head_dim
            self.w_in = dense((d, 2 * di))
            self.w_bcdt = dense((d, 2 * s.d_state + nh))
            self.w_out = dense((di, d))
            self.conv = dense((s.d_conv, di), 0.5)
            self.a_log = full(nh, 0.0, F32)
            self.dt_bias = full(nh, -1.0, F32)
            self.d_skip = full(nh, 1.0, F32)
        else:
            for n in RWKV_MU:
                setattr(self, n, full(d, 0.5))
            for n in ("w_r", "w_k", "w_v", "w_g"):
                setattr(self, n, dense((d, d)))
            self.w_dec = dense((d, d), 0.01)
            self.dec_bias = full(d, 0.5, F32)
            self.u = full((d // cfg.ssm.head_dim, cfg.ssm.head_dim), 0.0,
                          F32)
            self.ln_x = full(d, 1.0)
            self.w_o = dense((d, d))
        if self.moe is not None:
            E = self.moe.n_experts
            self.router = dense((d, E), 0.02)
            self.moe_w1 = dense((E, d, cfg.d_ff))
            self.moe_w3 = dense((E, d, cfg.d_ff))
            self.moe_w2 = dense((E, cfg.d_ff, d))
        else:
            self.w1 = dense((d, cfg.d_ff))
            self.w3 = dense((d, cfg.d_ff))
            self.w2 = dense((cfg.d_ff, d))

    def weights(self) -> Dict[str, torch.Tensor]:
        """The layer's own parameters by name (what ``ModelSharding``
        puts at their at-use placements)."""
        return dict(self.named_parameters(recurse=False))

    def _w(self, w: Optional[Dict], name: str) -> torch.Tensor:
        """Weight ``name``: from ``w`` (at-use weights) when given, else
        the layer's own."""
        return getattr(self, name) if w is None else w[name]

    def q(self, h: torch.Tensor, cross: bool = False, w=None):
        """(B,S,d) -> q (B,S,H,hd): ``wq`` and its bias, or the cross
        sublayer's ``xq`` (no bias, as in the reference). ``w``: the
        weights to use in place of the layer's (:meth:`weights`' keys),
        here and in the methods below."""
        H, _, hd = self.shape
        if cross:
            return split_heads(h @ self._w(w, "xq"), H, hd)
        q = h @ self._w(w, "wq")
        if self.qkv_bias:
            q = q + self._w(w, "bq")
        return split_heads(q, H, hd)

    def kv(self, src: torch.Tensor, cross: bool = False, w=None):
        """(B,L,d) -> k and v (B,L,KV,hd): ``wk``/``wv`` and their
        biases, or the cross sublayer's ``xk``/``xv``."""
        _, KV, hd = self.shape
        if cross:
            k, v = src @ self._w(w, "xk"), src @ self._w(w, "xv")
        else:
            k, v = src @ self._w(w, "wk"), src @ self._w(w, "wv")
            if self.qkv_bias:
                k, v = k + self._w(w, "bk"), v + self._w(w, "bv")
        return split_heads(k, KV, hd), split_heads(v, KV, hd)

    def qkv(self, h: torch.Tensor, w=None):
        """(B,S,d) -> q (B,S,H,hd), k and v (B,S,KV,hd)."""
        return (self.q(h, w=w), *self.kv(h, w=w))

    def mix(self, h: torch.Tensor, state=None, *, decode: bool = False,
            w=None):
        """A state-space layer's mixer over h (B,S,d) from ``state`` (None:
        zero), or over one token (``decode``). Returns (y, new state). On
        DTensors each rank runs the mixer on its own batch rows and heads
        (``ssm.mix_on_mesh``), y a partial sum over 'model' where the
        heads are split over it."""
        p = self.weights() if w is None else w
        s = self.ssm
        if self.kind == "mamba":
            kw = {"d_state": s.d_state, "head_dim": s.head_dim,
                  "d_conv": s.d_conv}
            fn = ssm.mamba_decode if decode else ssm.mamba_mix
        else:
            kw = {"head_dim": s.head_dim}
            fn = ssm.rwkv6_decode if decode else ssm.rwkv6_mix
        if is_dtensor(h):
            return ssm.mix_on_mesh(self.kind, fn, p, h, state, **kw)
        return fn(p, h, state, **kw)

    def ffn(self, h: torch.Tensor, w=None):
        """(B,S,d) -> (out (B,S,d), the MoE's aux loss or None)."""
        if self.moe is None:
            return gated_mlp({"w1": self._w(w, "w1"), "w3": self._w(w, "w3"),
                              "w2": self._w(w, "w2")}, h), None
        return moe_ffn({"router": self._w(w, "router"),
                        "w1": self._w(w, "moe_w1"),
                        "w3": self._w(w, "moe_w3"),
                        "w2": self._w(w, "moe_w2")}, h,
                       n_experts=self.moe.n_experts, top_k=self.moe.top_k,
                       capacity_factor=self.moe.capacity_factor)


class LM(nn.Module):
    """LM on ``device`` (``None``: the card, which must be there;
    ``"cpu"`` only when asked).

    Weights have the reference's shapes and scales (``init_params``):
    embed, head, MoE router and the learned position tables ``pos`` and
    ``enc_pos`` (max_seq, d) N(0, 0.02²), norms one, QKV biases zero, a
    mamba conv N(0, 0.5²), an rwkv decay matrix N(0, 0.01²), every other
    layer matrix (the experts' and the cross sublayer's too) N(0, 1/P)
    with P = ``cfg.n_periods`` (the reference's ``_dense`` takes the
    leading, stacked period axis as its fan-in), the encoder's N(0, 1/E)
    with E = ``cfg.encoder_layers`` (its stacked axis), rounded to bf16
    and then cast to ``cfg.dtype``; the state-space constants as the
    reference sets them (mamba ``a_log`` 0, ``dt_bias`` -1, ``d_skip`` 1;
    rwkv ``mu_*`` 0.5, ``dec_bias`` 0.5, ``u`` 0), float32 where the
    reference keeps them in float32. Random leaves are drawn on
    ``generator``'s device (default: a generator on ``device`` seeded 0),
    one after another: embed, head, the layers in order, ``pos``, the
    encoder's layers, ``enc_pos``; so a CPU generator gives the same
    weights on every device. The reference keys some leaves alike, and
    the port draws each apart (ROADMAP Queue 3): rwkv's r/k/v/g matrices
    by ``hash(name) % 20``, which Python salts per process; and in the
    encoder wq and wk from one key, wv and wo from another, w1, w3 and
    w2 from a third, and ``pos`` and ``enc_pos`` from one key, so that
    ``w1 == w3`` and ``pos == enc_pos`` there (and ``wk == wq``, ``wo ==
    wv`` where KV = H and d = H * hd). On the ``meta`` device nothing is
    drawn: the leaves have their shapes and dtypes only.
    """

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        meta = dev.type == "meta"   # shapes and dtypes only, nothing drawn
        gen = generator if generator is not None or meta else \
            torch.Generator(device=dev).manual_seed(0)
        w_scale = 1.0 / math.sqrt(cfg.n_periods)

        def dense(shape, scale=w_scale):
            if meta:
                return _frozen(torch.empty(shape, dtype=self.dtype,
                                           device=dev))
            t = torch.randn(shape, generator=gen, dtype=F32,
                            device=gen.device) * scale
            return _frozen(t.to(BF16).to(device=dev, dtype=self.dtype))

        def full(shape, value, dtype=None):
            return _frozen(torch.full(
                shape if isinstance(shape, tuple) else (shape,), value,
                dtype=dtype or self.dtype, device=dev))

        self.embed = dense((cfg.vocab, cfg.d_model), 0.02)
        self.final_norm = full(cfg.d_model, 1.0)
        self.lm_head = dense((cfg.d_model, cfg.vocab), 0.02)
        kinds, ffns = cfg.slot_kinds(), cfg.ffn_kinds()
        self.layers = nn.ModuleList(
            Layer(cfg, kinds[i % cfg.period], ffns[i % cfg.period], dense,
                  full)
            for i in range(cfg.n_layers))
        if cfg.learned_pos:
            self.pos = dense((cfg.max_seq, cfg.d_model), 0.02)
        if cfg.is_encdec:
            enc_scale = 1.0 / math.sqrt(cfg.encoder_layers)

            def enc_dense(shape):
                return dense(shape, enc_scale)
            self.encoder = nn.ModuleList(
                Layer(cfg, "attn", "mlp", enc_dense, full, encoder=True)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = full(cfg.d_model, 1.0)
            self.enc_pos = dense((cfg.max_seq, cfg.d_model), 0.02)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def needs_context(self) -> bool:
        """Whether the forward reads a context: an encoder or a cross
        slot."""
        return self.cfg.is_encdec or "cross" in self.cfg.slot_kinds()

    def encode(self, frames: torch.Tensor, shd=None) -> torch.Tensor:
        """The reference's ``_encoder``: frames (B, S, d) plus ``enc_pos``,
        then per encoder layer a norm, all-pairs self-attention (the
        kernel's block default, 1024, as the reference passes none), a
        norm and the gated MLP; then ``enc_norm``."""
        cfg = self.cfg
        B, S, _ = frames.shape
        x = frames.to(self.dtype) + self.enc_pos[:S]
        for layer in self.encoder:
            w = None
            if shd is not None:
                w = shd.encslice(layer.weights())
                x = shd.act(x)
            q, k, v = layer.qkv(
                rms_norm(x, layer._w(w, "ln1"), cfg.norm_eps), w=w)
            a = block_causal_attention(q, k, v, causal=False)
            x = _settle(x + a.reshape(B, S, -1) @ layer._w(w, "wo"), shd)
            x = x + layer.ffn(rms_norm(x, layer._w(w, "ln2"), cfg.norm_eps),
                              w=w)[0]
        return rms_norm(_settle(x, shd), self.enc_norm, cfg.norm_eps)

    def _context(self, ctx: Optional[torch.Tensor], batch: int, shd=None):
        """What the cross layers attend: None for a config without them;
        else ``ctx`` (B, L, d) in the model dtype, through the encoder for
        an encoder-decoder config. Raises ``ValueError`` on a missing
        context or one of another batch or width."""
        cfg = self.cfg
        if not self.needs_context:
            return None
        if ctx is None:
            raise ValueError(f"{cfg.name}: its cross-attention needs a "
                             f"context (B, L, {cfg.d_model}): frame or "
                             f"patch embeddings")
        if ctx.dim() != 3 or ctx.shape[0] != batch \
                or ctx.shape[2] != cfg.d_model:
            raise ValueError(f"{cfg.name}: context {tuple(ctx.shape)} is "
                             f"not ({batch}, L, {cfg.d_model})")
        ctx = ctx.to(self.dtype)
        return self.encode(ctx, shd) if cfg.is_encdec else ctx

    def _period(self, x: torch.Tensor, aux: torch.Tensor, layers,
                positions: torch.Tensor, attn_block: int,
                ctx: Optional[torch.Tensor] = None,
                states: Optional[list] = None, shd=None):
        """One period's ``layers`` over the full sequence (the body of the
        reference's ``period``): returns x and aux with its layers added.
        ``ctx`` is what the cross layers attend (:meth:`_context`).
        ``states``, when given, gets each layer's cache entry in order: an
        attention layer's dict of k, v (and the cross sublayer's xk, xv),
        a cross layer's ck, cv, a state-space layer's final state (each
        layer starts from a zero state, as in the reference). ``shd``: each
        layer's weights at their at-use placements and x constrained at
        its start (module docstring)."""
        cfg = self.cfg
        B, S, _ = x.shape
        for i, layer in enumerate(layers):
            w = None
            if shd is not None:
                w = shd.pslice(f"slot{i}", layer.weights())
                x = shd.act(x)
            h = rms_norm(x, layer._w(w, "ln1"), cfg.norm_eps)
            if layer.kind == "attn":
                q, k, v = layer.qkv(h, w=w)
                if cfg.rope:
                    q = rope(q, positions, cfg.rope_theta)
                    k = rope(k, positions, cfg.rope_theta)
                a = block_causal_attention(q, k, v,
                                           window=cfg.sliding_window,
                                           block=attn_block)
                x = x + a.reshape(B, S, -1) @ layer._w(w, "wo")
                state = {"k": k, "v": v}
                if layer.cross_sublayer:  # after self-attention, normed
                    x = _settle(x, shd)
                    hx = rms_norm(x, layer._w(w, "ln_x"), cfg.norm_eps)
                    kx, vx = layer.kv(ctx, cross=True, w=w)
                    a = block_causal_attention(layer.q(hx, cross=True, w=w),
                                               kx, vx, causal=False,
                                               block=attn_block)
                    x = x + a.reshape(B, S, -1) @ layer._w(w, "xo")
                    state.update(xk=kx, xv=vx)
            elif layer.kind == "cross":
                # k/v from the raw context: no norm, no rope
                k, v = layer.kv(ctx, w=w)
                a = block_causal_attention(layer.q(h, w=w), k, v,
                                           causal=False, block=attn_block)
                x = x + a.reshape(B, S, -1) @ layer._w(w, "wo")
                state = {"ck": k, "cv": v}
            else:
                y, state = layer.mix(h, w=w)
                x = x + y
            if states is not None:
                states.append(state)
            x = _settle(x, shd)
            y, a_loss = layer.ffn(rms_norm(x, layer._w(w, "ln2"),
                                           cfg.norm_eps), w=w)
            x = x + y
            if a_loss is not None:
                aux = aux + a_loss
        return _settle(x, shd), aux

    def _trunk(self, tokens: torch.Tensor, attn_block: int,
               states: Optional[list] = None, remat: bool = False,
               ctx: Optional[torch.Tensor] = None, shd=None):
        """Embed (plus the learned positions), the context
        (:meth:`_context`), every period over the full sequence, final
        norm. Returns the hidden states and the sum of the MoE layers' aux
        losses (float32, 0 without MoE). ``remat`` keeps only each
        period's input and recomputes its layers in the backward, as the
        reference's ``jax.checkpoint(period)``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed(tokens, shd)
        if cfg.learned_pos:
            x = x + self.pos[:S]
        ctx = self._context(ctx, B, shd)
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=F32, device=x.device)
        if shd is not None:
            positions, aux = shd.replicate(positions), shd.replicate(aux)
        for p0 in range(0, len(self.layers), cfg.period):
            layers = self.layers[p0:p0 + cfg.period]
            if remat:
                x, aux = checkpoint(self._period, x, aux, layers, positions,
                                    attn_block, ctx, None, shd,
                                    use_reentrant=False)
            else:
                x, aux = self._period(x, aux, layers, positions, attn_block,
                                      ctx, states, shd)
        return rms_norm(x, self.final_norm, cfg.norm_eps), aux

    def _embed(self, tokens: torch.Tensor, shd=None) -> torch.Tensor:
        """The tokens' embedding rows in the model dtype. Sharded: the
        at-use embedding (vocab over 'model') looked up shard by shard
        (``ModelSharding.lookup``), then constrained by ``act``."""
        if shd is None:
            return self.embed[tokens].to(self.dtype)
        return shd.act(shd.lookup(tokens, shd.embed(self.embed))
                       ).to(self.dtype)

    def _head(self, shd=None) -> torch.Tensor:
        return self.lm_head if shd is None else shd.head(self.lm_head)

    def forward(self, tokens: torch.Tensor,
                ctx: Optional[torch.Tensor] = None, *,
                attn_block: int = 1024, return_aux: bool = False,
                remat: bool = False, shd=None):
        """tokens (B, S) integer -> logits (B, S, V); with ``return_aux``
        (logits, aux), ``aux`` the MoE load-balance loss summed over the
        layers (float32 scalar), as the reference's ``forward`` returns.
        ``ctx`` (B, L, d): the context of a config with an encoder or
        cross slots (module docstring). ``remat`` recomputes each
        period's layers in the backward instead of keeping their
        activations (the reference's ``remat``): the same loss and
        gradients, bit for bit, for less memory. ``shd``: the sharded
        path (module docstring)."""
        x, aux = self._trunk(tokens, attn_block, remat=remat, ctx=ctx,
                             shd=shd)
        logits = x @ self._head(shd)
        return (logits, aux) if return_aux else logits

    def init_cache(self, B: int, seq_cap: int, ctx_len: int = 0,
                   shd=None) -> Dict:
        """A zero cache of the reference's layout (module docstring), its
        cross K/V for a context of ``ctx_len`` positions, on the model's
        device (:func:`init_cache`); placed on ``shd``'s mesh by the
        cache specs when given, each rank making only its shards."""
        if shd is None:
            return init_cache(self.cfg, B, seq_cap, ctx_len,
                              device=self.device)
        return shd.zero_cache(init_cache(self.cfg, B, seq_cap, ctx_len,
                                         device="meta"), self.device)

    def prefill(self, tokens: torch.Tensor,
                ctx: Optional[torch.Tensor] = None, *, seq_cap: int,
                attn_block: int = 1024, shd=None):
        """Full forward that fills a fresh cache of ``seq_cap`` positions
        (and the cross K/V of ``ctx``'s positions). Returns the logits of
        the last position (B, V) and the cache (placed by the cache specs
        under ``shd``)."""
        B, S = tokens.shape
        if S > seq_cap:
            raise ValueError(f"prefill of {S} positions into a cache of "
                             f"{seq_cap}")
        states: list = []
        x, _ = self._trunk(tokens, attn_block, states, ctx=ctx, shd=shd)
        cache = self.init_cache(
            B, seq_cap, ctx.shape[1] if self.needs_context else 0, shd)
        cache["len"] = S
        period, W = self.cfg.period, self.cfg.sliding_window
        n = min(S, _cache_cap(self.cfg, seq_cap))
        for layer_idx, (layer, state) in enumerate(zip(self.layers, states)):
            c, p = cache[f"slot{layer_idx % period}"], layer_idx // period
            if isinstance(state, tuple):        # a state-space layer
                for stack, t in zip(c, state):
                    write(stack, (p,), t)
                continue
            for key, t in state.items():
                if key not in ("k", "v"):       # the context's K/V, whole
                    write(c[key], (p,), t)
                    continue
                if W and S > W:  # the last W positions, into slots 0..W-1
                    t = t[:, -W:]
                write(c[key], (p, slice(None), slice(0, n)), t[:, :n])
        return x[:, -1] @ self._head(shd), cache

    def decode_step(self, token: torch.Tensor, cache: Dict, shd=None):
        """One serving step: token (B, 1) + cache -> (logits (B, V), cache
        with ``len + 1``). Position ``pos`` goes to k/v slot ``pos``, or to
        ``pos % cap`` in the ring of a sliding window, and takes the
        learned position row ``pos % max_seq``; the cross layers read the
        context's K/V that the prefill cached; a state-space layer steps
        its state once. ``shd``: the sharded path (module docstring), the
        cache placed by the cache specs."""
        cfg = self.cfg
        B = token.shape[0]
        pos = cache["len"]
        W = cfg.sliding_window
        attn = [i for i, kind in enumerate(cfg.slot_kinds())
                if kind == "attn"]
        slot = None
        if attn:            # a model without attention needs no capacity
            cap = cache[f"slot{attn[0]}"]["k"].shape[2]
            if not W and pos >= cap:
                raise ValueError(f"decode at position {pos}: the cache "
                                 f"holds {cap}")
            slot = pos % cap if W else pos
        x = self._embed(token[:, 0], shd)[:, None]
        if cfg.learned_pos:
            x = x + self.pos[pos % self.pos.shape[0]]
        pvec = torch.full((B, 1), pos, device=x.device)
        for layer_idx, layer in enumerate(self.layers):
            c = cache[f"slot{layer_idx % cfg.period}"]
            p = layer_idx // cfg.period
            w = None
            if shd is not None:
                w = shd.pslice(f"slot{layer_idx % cfg.period}",
                               layer.weights())
            x = _settle(x, shd)
            h = rms_norm(x, layer._w(w, "ln1"), cfg.norm_eps)
            if layer.kind == "attn":
                q, k, v = layer.qkv(h, w=w)
                if cfg.rope:
                    q = rope(q, pvec, cfg.rope_theta)
                    k = rope(k, pvec, cfg.rope_theta)
                write(c["k"], (p, slice(None), slot), k[:, 0])
                write(c["v"], (p, slice(None), slot), v[:, 0])
                kc, vc = c["k"][p], c["v"][p]
                a = decode_attention(q, kc, vc, pos + 1, window=W)
                x = x + a.reshape(B, 1, -1).to(x.dtype) @ layer._w(w, "wo")
                if layer.cross_sublayer:
                    x = _settle(x, shd)
                    hx = rms_norm(x, layer._w(w, "ln_x"), cfg.norm_eps)
                    kx = c["xk"][p]
                    a = decode_attention(layer.q(hx, cross=True, w=w), kx,
                                         c["xv"][p], kx.shape[1])
                    x = x + a.reshape(B, 1, -1).to(x.dtype) \
                        @ layer._w(w, "xo")
            elif layer.kind == "cross":
                kx = c["ck"][p]
                a = decode_attention(layer.q(h, w=w), kx, c["cv"][p],
                                     kx.shape[1])
                x = x + a.reshape(B, 1, -1).to(x.dtype) @ layer._w(w, "wo")
            else:
                y, state = layer.mix(h, tuple(t[p] for t in c), decode=True,
                                     w=w)
                for stack, t in zip(c, state):
                    write(stack, (p,), t)
                x = x + y
            x = _settle(x, shd)
            x = x + layer.ffn(rms_norm(x, layer._w(w, "ln2"), cfg.norm_eps),
                              w=w)[0]
        x = rms_norm(_settle(x, shd), self.final_norm, cfg.norm_eps)
        return x[:, 0] @ self._head(shd), {**cache, "len": pos + 1}



def _settle(x: torch.Tensor, shd) -> torch.Tensor:
    """The residual ``x`` after a row-parallel projection (attention's
    output, an FFN's, a mixer's), placed as at a layer's start on the
    sharded path (``shd.act``): DTensor would keep it a partial sum over
    'model' through the next norm and multiply the partial sums by the
    next projection's whole gathered weight on every 'model' rank (the
    FFN's gate and up, the head), where the reference's GSPMD reduces it
    first. ``shd=None``: ``x`` as it is."""
    return x if shd is None else shd.act(x)


def _cache_cap(cfg: ArchConfig, seq_cap: int) -> int:
    """Positions a cache of ``seq_cap`` holds: min(seq_cap, W) under a
    sliding window W (a ring), else ``seq_cap``."""
    W = cfg.sliding_window
    return min(seq_cap, W) if W else seq_cap


def init_cache(cfg: ArchConfig, B: int, seq_cap: int, ctx_len: int = 0,
               device=None) -> Dict:
    """A zero decode cache of ``cfg`` (the module docstring's layout) on
    ``device`` (``None``: the card; ``"cpu"`` only when asked; ``"meta"``
    gives shapes and dtypes alone, as the reference's ``eval_shape`` of
    its ``init_cache``): the attention caches of ``seq_cap`` positions
    (min(``seq_cap``, W) under a sliding window W), cross K/V for a
    context of ``ctx_len``."""
    device = resolve_device(device)
    P = cfg.n_periods
    dtype = getattr(torch, cfg.dtype)
    ctx_kv = (ctx_len, cfg.n_kv_heads, cfg.hd)
    cap = _cache_cap(cfg, seq_cap)

    def zeros(*shape, dtype=dtype):
        return torch.zeros((P, B) + shape, dtype=dtype, device=device)
    cache: Dict = {"len": 0}
    for i, kind in enumerate(cfg.slot_kinds()):
        if kind == "attn":
            shape = (cap, cfg.n_kv_heads, cfg.hd)
            cache[f"slot{i}"] = {"k": zeros(*shape), "v": zeros(*shape)}
            if cfg.is_encdec:
                cache[f"slot{i}"].update(xk=zeros(*ctx_kv),
                                         xv=zeros(*ctx_kv))
        elif kind == "cross":
            cache[f"slot{i}"] = {"ck": zeros(*ctx_kv),
                                 "cv": zeros(*ctx_kv)}
        elif kind == "mamba":
            s = cfg.ssm
            di = s.expand * cfg.d_model
            cache[f"slot{i}"] = (
                zeros(s.d_conv - 1, di),
                zeros(di // s.head_dim, s.d_state, s.head_dim,
                      dtype=F32))
        else:
            hd = cfg.ssm.head_dim
            cache[f"slot{i}"] = (
                zeros(1, cfg.d_model),
                zeros(cfg.d_model // hd, hd, hd, dtype=F32))
    return cache


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], *,
            attn_block: int = 1024, aux_coef: float = 0.01,
            remat: bool = False, shd=None, params=None) -> torch.Tensor:
    """Causal LM loss, the reference's ``loss_fn``: next-token cross
    entropy over float32 logits, averaged over the targets >= 0 (a target
    < 0 is masked), plus ``aux_coef`` times the MoE load-balance loss
    (0 for dense configs). ``batch`` holds ``tokens`` and ``targets``,
    (B, S) integer tensors on the model's device, and for a config with
    an encoder or cross slots its context ``ctx`` (B, L, d), which goes to
    the forward as the reference's ``batch.get("ctx")`` does. ``remat`` as
    in :meth:`LM.forward`. ``shd``: the sharded path (module docstring;
    the logits stay as the head makes them, rows over the data-parallel
    axes and vocab over 'model', and the cross entropy is vocab-parallel:
    ``ModelSharding.nll_sums``). ``params``: tensors
    that stand in for the model's parameters of those names in this call
    (``torch.func.functional_call``), such as the sharded step's embed and
    head taken to their at-use placements once per step."""
    targets = batch["targets"]
    args = (batch["tokens"], batch.get("ctx"))
    kw = dict(attn_block=attn_block, return_aux=True, remat=remat, shd=shd)
    if params:
        logits, aux = torch.func.functional_call(model, params, args, kw)
    else:
        logits, aux = model(*args, **kw)
    total, count = _nll_sums(logits, targets) if shd is None \
        else shd.nll_sums(logits, targets)
    nll = total / torch.clamp(count, min=1.0)
    return nll + aux_coef * aux


def _nll_sums(logits: torch.Tensor, targets: torch.Tensor):
    """(the next-token cross entropy summed over the targets >= 0, their
    count), over float32 logits."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        targets.clamp(min=0)[..., None].long())[..., 0]
    mask = (targets >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()
