"""Decoder LM of the port: attention layers with a gated-MLP or top-k
MoE FFN, attention dense or in a sliding window.

Counterpart of ``repro.models.lm`` for configs whose every slot is
``attn`` (SSM slots, cross-attention, an encoder and learned positions
raise ``NotImplementedError``). Layers are a ``ModuleList`` run in a
Python loop in place of the reference's ``lax.scan`` over stacked
periods; layer ``l`` is period ``l // period``, slot ``l % period`` of the
reference's parameter tree.

Entry points (the reference's, as methods):
  LM(cfg, device=None, generator=None)   -> weights drawn from a seed
  forward(tokens, remat=False)           -> logits (B, S, V)
  loss_fn(model, batch, remat=False)     -> scalar loss (a function)
  init_cache(B, seq_cap)                 -> zero decode cache
  prefill(tokens, seq_cap=...)           -> (last_logits (B, V), cache)
  decode_step(token, cache)              -> (logits (B, V), cache)

The cache has the reference's layout: ``{"len": n, "slot<i>": {"k", "v"}}``
with k/v of shape (P, B, cap, KV, hd) in the model dtype, ``cap`` being
``seq_cap``, or min(``seq_cap``, W) under a sliding window W, where the
cache is a ring. ``len`` is a Python int here (the reference keeps an
int32 scalar). ``decode_step`` writes the new position into the cache
tensors in place (the reference returns updated copies) and returns the
cache with ``len + 1``; without a window the slot it writes is past the
old ``len``, so the old cache still reads the same.

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
from .layers import (block_causal_attention, decode_attention, gated_mlp,
                     moe_ffn, rms_norm, rope)

F32 = torch.float32
BF16 = torch.bfloat16


def _check_supported(cfg: ArchConfig) -> None:
    """Raise unless the port's LM runs ``cfg``: attention slots (dense or
    windowed) with MLP or MoE FFNs, rotary or no positions."""
    if (set(cfg.slot_kinds()) != {"attn"}
            or not set(cfg.ffn_kinds()) <= {"mlp", "moe"}
            or cfg.is_encdec or cfg.cross_len or cfg.learned_pos):
        raise NotImplementedError(
            f"{cfg.name}: the port's LM runs attention layers with MLP or "
            f"MoE FFNs only (slots {cfg.slot_kinds()}, ffn "
            f"{cfg.ffn_kinds()}, encoder layers {cfg.encoder_layers}, "
            f"cross {cfg.cross_len}, learned positions {cfg.learned_pos}); "
            f"see ROADMAP Queue 1")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Layer(nn.Module):
    """One attention + FFN layer (``ffn`` "mlp" or "moe"); its weights
    carry the reference's slot key names (``wq`` is (d, H*hd): activations
    multiply from the left, as in the reference's einsums; the MoE's
    ``router`` is (d, E), ``moe_w1``/``moe_w3`` (E, d, d_ff), ``moe_w2``
    (E, d_ff, d))."""

    def __init__(self, cfg: ArchConfig, ffn: str, dense, ones, zeros):
        super().__init__()
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        self.shape = (H, KV, hd)
        self.moe = cfg.moe if ffn == "moe" else None
        self.ln1, self.ln2 = ones(d), ones(d)
        self.wq = dense((d, H * hd))
        self.wk = dense((d, KV * hd))
        self.wv = dense((d, KV * hd))
        self.wo = dense((H * hd, d))
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = zeros(H * hd), zeros(KV * hd), \
                zeros(KV * hd)
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
    every other matrix (the experts' too) N(0, 1/P) with P =
    ``cfg.n_periods`` (the reference's ``_dense``
    takes the leading, stacked period axis as its fan-in), rounded to bf16
    and then cast to ``cfg.dtype``. They are drawn on ``generator``'s device
    (default: a generator on ``device`` seeded 0), so a CPU generator gives
    the same weights on every device.
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

        def ones(n):
            return _frozen(torch.ones(n, dtype=self.dtype, device=dev))

        def zeros(n):
            return _frozen(torch.zeros(n, dtype=self.dtype, device=dev))

        self.embed = dense((cfg.vocab, cfg.d_model), 0.02)
        self.final_norm = ones(cfg.d_model)
        self.lm_head = dense((cfg.d_model, cfg.vocab), 0.02)
        ffns = cfg.ffn_kinds()
        self.layers = nn.ModuleList(
            Layer(cfg, ffns[i % cfg.period], dense, ones, zeros)
            for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _period(self, x: torch.Tensor, aux: torch.Tensor, layers,
                positions: torch.Tensor, attn_block: int,
                kv_out: Optional[list] = None):
        """One period's ``layers`` over the full sequence (the body of the
        reference's ``period``): returns x and aux with its layers added."""
        cfg = self.cfg
        B, S, _ = x.shape
        for layer in layers:
            h = rms_norm(x, layer.ln1, cfg.norm_eps)
            q, k, v = layer.qkv(h)
            if cfg.rope:
                q = rope(q, positions, cfg.rope_theta)
                k = rope(k, positions, cfg.rope_theta)
            a = block_causal_attention(q, k, v, window=cfg.sliding_window,
                                       block=attn_block)
            x = x + a.reshape(B, S, -1) @ layer.wo
            if kv_out is not None:
                kv_out.append((k, v))
            y, a_loss = layer.ffn(rms_norm(x, layer.ln2, cfg.norm_eps))
            x = x + y
            if a_loss is not None:
                aux = aux + a_loss
        return x, aux

    def _trunk(self, tokens: torch.Tensor, attn_block: int,
               kv_out: Optional[list] = None, remat: bool = False):
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
                                      kv_out)
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
        cfg = self.cfg
        shape = (cfg.n_periods, B, self._cache_cap(seq_cap), cfg.n_kv_heads,
                 cfg.hd)
        cache: Dict = {"len": 0}
        for i in range(cfg.period):
            cache[f"slot{i}"] = {
                "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}
        return cache

    def prefill(self, tokens: torch.Tensor, *, seq_cap: int,
                attn_block: int = 1024):
        """Full forward that fills a fresh cache of ``seq_cap`` positions.
        Returns the logits of the last position (B, V) and the cache."""
        B, S = tokens.shape
        if S > seq_cap:
            raise ValueError(f"prefill of {S} positions into a cache of "
                             f"{seq_cap}")
        kv: list = []
        x, _ = self._trunk(tokens, attn_block, kv)
        cache = self.init_cache(B, seq_cap)
        cache["len"] = S
        period, W = self.cfg.period, self.cfg.sliding_window
        n = min(S, self._cache_cap(seq_cap))
        for layer_idx, (k, v) in enumerate(kv):
            if W and S > W:      # the last W positions, into slots 0..W-1
                k, v = k[:, -W:], v[:, -W:]
            c = cache[f"slot{layer_idx % period}"]
            c["k"][layer_idx // period, :, :n] = k[:, :n]
            c["v"][layer_idx // period, :, :n] = v[:, :n]
        return x[:, -1] @ self.lm_head, cache

    def decode_step(self, token: torch.Tensor, cache: Dict):
        """One serving step: token (B, 1) + cache -> (logits (B, V), cache
        with ``len + 1``). Position ``pos`` goes to slot ``pos``, or to
        ``pos % cap`` in the ring of a sliding window."""
        cfg = self.cfg
        B = token.shape[0]
        pos = cache["len"]
        cap = cache["slot0"]["k"].shape[2]
        W = cfg.sliding_window
        if not W and pos >= cap:
            raise ValueError(f"decode at position {pos}: the cache holds "
                             f"{cap}")
        slot = pos % cap if W else pos
        x = self.embed[token[:, 0]][:, None].to(self.dtype)
        pvec = torch.full((B, 1), pos, device=x.device)
        for layer_idx, layer in enumerate(self.layers):
            c = cache[f"slot{layer_idx % cfg.period}"]
            kc = c["k"][layer_idx // cfg.period]
            vc = c["v"][layer_idx // cfg.period]
            q, k, v = layer.qkv(rms_norm(x, layer.ln1, cfg.norm_eps))
            if cfg.rope:
                q = rope(q, pvec, cfg.rope_theta)
                k = rope(k, pvec, cfg.rope_theta)
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
            a = decode_attention(q, kc, vc, pos + 1, window=W)
            x = x + a.reshape(B, 1, -1).to(x.dtype) @ layer.wo
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
