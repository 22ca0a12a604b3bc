"""Decoder LM of the port: attention, Mamba or RWKV6 mixers, each with a
gated-MLP or top-k MoE FFN, attention dense or in a sliding window.

Counterpart of ``repro.models.lm`` for configs whose slots are ``attn``,
``mamba`` or ``rwkv`` (cross-attention, an encoder and learned positions
raise ``NotImplementedError``). Layers are a ``ModuleList`` run in a
Python loop in place of the reference's ``lax.scan`` over stacked
periods; layer ``l`` is period ``l // period``, slot ``l % period`` of the
reference's parameter tree. The mixers of the state-space slots are
``models.ssm``'s.

Entry points (the reference's, as methods):
  LM(cfg, device=None, generator=None)   -> weights drawn from a seed
  forward(tokens, remat=False)           -> logits (B, S, V)
  loss_fn(model, batch, remat=False)     -> scalar loss (a function)
  init_cache(B, seq_cap)                 -> zero decode cache
  prefill(tokens, seq_cap=...)           -> (last_logits (B, V), cache)
  decode_step(token, cache)              -> (logits (B, V), cache)

The cache has the reference's layout: ``{"len": n, "slot<i>": ...}``. An
attention slot holds ``{"k", "v"}`` of shape (P, B, cap, KV, hd) in the
model dtype, ``cap`` being ``seq_cap``, or min(``seq_cap``, W) under a
sliding window W, where the cache is a ring. A state-space slot holds
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
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import ssm
from .layers import (block_causal_attention, decode_attention, gated_mlp,
                     moe_ffn, rms_norm, rope)

F32 = torch.float32
BF16 = torch.bfloat16
#: the mixers with a recurrent state in place of a KV cache
SSM_KINDS = ("mamba", "rwkv")
#: an rwkv layer's token-shift mixing coefficients
RWKV_MU = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")


def _check_supported(cfg: ArchConfig) -> None:
    """Raise unless the port's LM runs ``cfg``: attention (dense or
    windowed), mamba and rwkv slots with MLP or MoE FFNs, rotary or no
    positions."""
    if (not set(cfg.slot_kinds()) <= {"attn", *SSM_KINDS}
            or not set(cfg.ffn_kinds()) <= {"mlp", "moe"}
            or cfg.is_encdec or cfg.cross_len or cfg.learned_pos):
        raise NotImplementedError(
            f"{cfg.name}: the port's LM runs attention, mamba and rwkv "
            f"layers with MLP or MoE FFNs only (slots {cfg.slot_kinds()}, "
            f"ffn {cfg.ffn_kinds()}, encoder layers {cfg.encoder_layers}, "
            f"cross {cfg.cross_len}, learned positions {cfg.learned_pos}); "
            f"see ROADMAP Queue 1")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.Module):
    """One mixer + FFN layer: the mixer ``kind`` "attn", "mamba" or
    "rwkv", the FFN ``ffn`` "mlp" or "moe". Its weights carry the
    reference's slot key names and shapes (``wq`` is (d, H*hd):
    activations multiply from the left, as in the reference's einsums;
    the MoE's ``router`` is (d, E), ``moe_w1``/``moe_w3`` (E, d, d_ff),
    ``moe_w2`` (E, d_ff, d)). A mamba layer holds ``w_in`` (d, 2 di),
    ``w_bcdt`` (d, 2 ds + nh), ``w_out`` (di, d), ``conv`` (d_conv, di)
    and, in float32 whatever the model dtype, ``a_log``, ``dt_bias`` and
    ``d_skip`` (nh,); an rwkv layer ``mu_*`` (d,), ``w_r``/``w_k``/
    ``w_v``/``w_g``/``w_dec``/``w_o`` (d, d), ``ln_x`` (d,) and, in
    float32, ``dec_bias`` (d,) and ``u`` (H, hd)."""

    def __init__(self, cfg: ArchConfig, kind: str, ffn: str, dense, full):
        super().__init__()
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.kind = kind
        self.ssm = cfg.ssm
        self.shape = (H, KV, hd)
        self.moe = cfg.moe if ffn == "moe" else None
        self.ln1, self.ln2 = full(d, 1.0), full(d, 1.0)
        self.qkv_bias = False
        if kind == "attn":
            self.wq = dense((d, H * hd))
            self.wk = dense((d, KV * hd))
            self.wv = dense((d, KV * hd))
            self.wo = dense((H * hd, d))
            self.qkv_bias = cfg.qkv_bias
            if cfg.qkv_bias:
                self.bq, self.bk, self.bv = (full(H * hd, 0.0),
                                             full(KV * hd, 0.0),
                                             full(KV * hd, 0.0))
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

    def qkv(self, h: torch.Tensor):
        """(B,S,d) -> q (B,S,H,hd), k and v (B,S,KV,hd)."""
        B, S, _ = h.shape
        H, KV, hd = self.shape
        q, k, v = h @ self.wq, h @ self.wk, h @ self.wv
        if self.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
                v.reshape(B, S, KV, hd))

    def mix(self, h: torch.Tensor, state=None, *, decode: bool = False):
        """A state-space layer's mixer over h (B,S,d) from ``state`` (None:
        zero), or over one token (``decode``). Returns (y, new state)."""
        p = dict(self.named_parameters(recurse=False))
        s = self.ssm
        if self.kind == "mamba":
            kw = {"d_state": s.d_state, "head_dim": s.head_dim,
                  "d_conv": s.d_conv}
            if decode:
                return ssm.mamba_decode(p, h, state, **kw)
            return ssm.mamba_mix(p, h, state, **kw)
        if decode:
            return ssm.rwkv6_decode(p, h, state, head_dim=s.head_dim)
        return ssm.rwkv6_mix(p, h, state, head_dim=s.head_dim)

    def ffn(self, h: torch.Tensor):
        """(B,S,d) -> (out (B,S,d), the MoE's aux loss or None)."""
        if self.moe is None:
            return gated_mlp({"w1": self.w1, "w3": self.w3, "w2": self.w2},
                             h), None
        return moe_ffn({"router": self.router, "w1": self.moe_w1,
                        "w3": self.moe_w3, "w2": self.moe_w2}, h,
                       n_experts=self.moe.n_experts, top_k=self.moe.top_k,
                       capacity_factor=self.moe.capacity_factor)


class LM(nn.Module):
    """Decoder LM on ``device`` (``None``: the card, which must be there;
    ``"cpu"`` only when asked).

    Weights have the reference's shapes and scales (``init_params``):
    embed, head and MoE router N(0, 0.02²), norms one, QKV biases zero,
    a mamba conv N(0, 0.5²), an rwkv decay matrix N(0, 0.01²), every
    other matrix (the experts' too) N(0, 1/P) with P = ``cfg.n_periods``
    (the reference's ``_dense`` takes the leading, stacked period axis as
    its fan-in), rounded to bf16 and then cast to ``cfg.dtype``; the
    state-space constants as the reference sets them (mamba ``a_log`` 0,
    ``dt_bias`` -1, ``d_skip`` 1; rwkv ``mu_*`` 0.5, ``dec_bias`` 0.5, ``u``
    0), float32 where the reference keeps them in float32. Random leaves
    are drawn on ``generator``'s device (default: a generator on
    ``device`` seeded 0), one after another in the layers' order, so a
    CPU generator gives the same weights on every device (the reference
    keys rwkv's r/k/v/g matrices by ``hash(name) % 20``, which Python
    salts per process: ROADMAP Queue 3).
    """

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        gen = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        w_scale = 1.0 / math.sqrt(cfg.n_periods)

        def dense(shape, scale=w_scale):
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

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _period(self, x: torch.Tensor, aux: torch.Tensor, layers,
                positions: torch.Tensor, attn_block: int,
                states: Optional[list] = None):
        """One period's ``layers`` over the full sequence (the body of the
        reference's ``period``): returns x and aux with its layers added.
        ``states``, when given, gets each layer's cache entry in order: an
        attention layer's (k, v), a state-space layer's final state (each
        layer starts from a zero state, as in the reference)."""
        cfg = self.cfg
        B, S, _ = x.shape
        for layer in layers:
            h = rms_norm(x, layer.ln1, cfg.norm_eps)
            if layer.kind == "attn":
                q, k, v = layer.qkv(h)
                if cfg.rope:
                    q = rope(q, positions, cfg.rope_theta)
                    k = rope(k, positions, cfg.rope_theta)
                a = block_causal_attention(q, k, v,
                                           window=cfg.sliding_window,
                                           block=attn_block)
                x = x + a.reshape(B, S, -1) @ layer.wo
                state = (k, v)
            else:
                y, state = layer.mix(h)
                x = x + y
            if states is not None:
                states.append(state)
            y, a_loss = layer.ffn(rms_norm(x, layer.ln2, cfg.norm_eps))
            x = x + y
            if a_loss is not None:
                aux = aux + a_loss
        return x, aux

    def _trunk(self, tokens: torch.Tensor, attn_block: int,
               states: Optional[list] = None, remat: bool = False):
        """Embed, every period over the full sequence, final norm. Returns
        the hidden states and the sum of the MoE layers' aux losses
        (float32, 0 without MoE). ``remat`` keeps only each period's
        input and recomputes its layers in the backward, as the
        reference's ``jax.checkpoint(period)``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed[tokens].to(self.dtype)
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for p0 in range(0, len(self.layers), cfg.period):
            layers = self.layers[p0:p0 + cfg.period]
            if remat:
                x, aux = checkpoint(self._period, x, aux, layers, positions,
                                    attn_block, use_reentrant=False)
            else:
                x, aux = self._period(x, aux, layers, positions, attn_block,
                                      states)
        return rms_norm(x, self.final_norm, cfg.norm_eps), aux

    def forward(self, tokens: torch.Tensor, *, attn_block: int = 1024,
                return_aux: bool = False, remat: bool = False):
        """tokens (B, S) integer -> logits (B, S, V); with ``return_aux``
        (logits, aux), ``aux`` the MoE load-balance loss summed over the
        layers (float32 scalar), as the reference's ``forward`` returns.
        ``remat`` recomputes each period's layers in the backward instead
        of keeping their activations (the reference's ``remat``): the
        same loss and gradients, bit for bit, for less memory."""
        x, aux = self._trunk(tokens, attn_block, remat=remat)
        logits = x @ self.lm_head
        return (logits, aux) if return_aux else logits

    def _cache_cap(self, seq_cap: int) -> int:
        """Positions a cache of ``seq_cap`` holds: min(seq_cap, W) under a
        sliding window W (a ring), else ``seq_cap``."""
        W = self.cfg.sliding_window
        return min(seq_cap, W) if W else seq_cap

    def init_cache(self, B: int, seq_cap: int) -> Dict:
        """A zero cache of the reference's layout (module docstring)."""
        cfg = self.cfg
        P = cfg.n_periods

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros((P, B) + shape, dtype=dtype,
                               device=self.device)
        cache: Dict = {"len": 0}
        for i, kind in enumerate(cfg.slot_kinds()):
            if kind == "attn":
                shape = (self._cache_cap(seq_cap), cfg.n_kv_heads, cfg.hd)
                cache[f"slot{i}"] = {"k": zeros(*shape), "v": zeros(*shape)}
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

    def prefill(self, tokens: torch.Tensor, *, seq_cap: int,
                attn_block: int = 1024):
        """Full forward that fills a fresh cache of ``seq_cap`` positions.
        Returns the logits of the last position (B, V) and the cache."""
        B, S = tokens.shape
        if S > seq_cap:
            raise ValueError(f"prefill of {S} positions into a cache of "
                             f"{seq_cap}")
        states: list = []
        x, _ = self._trunk(tokens, attn_block, states)
        cache = self.init_cache(B, seq_cap)
        cache["len"] = S
        period, W = self.cfg.period, self.cfg.sliding_window
        n = min(S, self._cache_cap(seq_cap))
        for layer_idx, (layer, state) in enumerate(zip(self.layers, states)):
            c, p = cache[f"slot{layer_idx % period}"], layer_idx // period
            if layer.kind != "attn":
                for stack, t in zip(c, state):
                    stack[p] = t
                continue
            k, v = state
            if W and S > W:      # the last W positions, into slots 0..W-1
                k, v = k[:, -W:], v[:, -W:]
            c["k"][p, :, :n] = k[:, :n]
            c["v"][p, :, :n] = v[:, :n]
        return x[:, -1] @ self.lm_head, cache

    def decode_step(self, token: torch.Tensor, cache: Dict):
        """One serving step: token (B, 1) + cache -> (logits (B, V), cache
        with ``len + 1``). Position ``pos`` goes to k/v slot ``pos``, or to
        ``pos % cap`` in the ring of a sliding window; a state-space layer
        steps its state once."""
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
        x = self.embed[token[:, 0]][:, None].to(self.dtype)
        pvec = torch.full((B, 1), pos, device=x.device)
        for layer_idx, layer in enumerate(self.layers):
            c = cache[f"slot{layer_idx % cfg.period}"]
            p = layer_idx // cfg.period
            h = rms_norm(x, layer.ln1, cfg.norm_eps)
            if layer.kind == "attn":
                kc, vc = c["k"][p], c["v"][p]
                q, k, v = layer.qkv(h)
                if cfg.rope:
                    q = rope(q, pvec, cfg.rope_theta)
                    k = rope(k, pvec, cfg.rope_theta)
                kc[:, slot] = k[:, 0]
                vc[:, slot] = v[:, 0]
                a = decode_attention(q, kc, vc, pos + 1, window=W)
                x = x + a.reshape(B, 1, -1).to(x.dtype) @ layer.wo
            else:
                y, state = layer.mix(h, tuple(t[p] for t in c), decode=True)
                for stack, t in zip(c, state):
                    stack[p] = t
                x = x + y
            x = x + layer.ffn(rms_norm(x, layer.ln2, cfg.norm_eps))[0]
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return x[:, 0] @ self.lm_head, {**cache, "len": pos + 1}


def loss_fn(model: LM, batch: Dict[str, torch.Tensor], *,
            attn_block: int = 1024, aux_coef: float = 0.01,
            remat: bool = False) -> torch.Tensor:
    """Causal LM loss, the reference's ``loss_fn``: next-token cross
    entropy over float32 logits, averaged over the targets >= 0 (a target
    < 0 is masked), plus ``aux_coef`` times the MoE load-balance loss
    (0 for dense configs). ``batch`` holds ``tokens`` and ``targets``,
    (B, S) integer tensors on the model's device. ``remat`` as in
    :meth:`LM.forward`."""
    targets = batch["targets"]
    logits, aux = model(batch["tokens"], attn_block=attn_block,
                        return_aux=True, remat=remat)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        targets.clamp(min=0)[..., None].long())[..., 0]
    mask = (targets >= 0).float()
    nll = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + aux_coef * aux
