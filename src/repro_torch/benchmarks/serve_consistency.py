"""Prefill-vs-decode consistency of the serving path's last logits.

One prompt is prefilled whole (L1, prefill attention: the flash kernel on
the card), and again without its last ``TAIL`` tokens, which are then
decoded one at a time (L2, plain decode attention). Both are the logits of
the same position under the same weights. In float32 they agree to
rounding; in bf16 their gap ``||L1 - L2|| / ||L1||`` is the model's
rounding noise, which ``chip_smoke.py``'s serve check is held against.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_consistency \\
        [--device cpu]

prints the gap for three seeds (weights and prompt), without a fault and
with each of ``FAULTS`` planted in the decode's cache: on the card for
qwen1.5-0.5b at full width and a 2048-token prompt in bf16 (the shape of
``chip_smoke.py``'s check), on the CPU for its reduced widths at 24 layers
and a 256-token prompt in float32 and bf16.

An MoE model does not give the same logits both ways, whatever the
cache: the reference's capacity routing makes a token's FFN output depend
on the other tokens of its chunk (a later token can push an earlier
one's choice past capacity), decode never drops, and a routing choice
that rounding flips changes a token's output wholesale. So for MoE
configs ``prefill_decode_logits(..., fixed_routes=True)`` records every
layer's routes in the whole prefill (L1) and replays them, position by
position, in the shorter prefill and the decode steps (L2), through
``models.routes.calls`` and ``models.routes.served``: both sides
then compute one function, and the gap reads the attention and cache
path alone, as it does for a dense model. Only the MoE layers route, so
the recorded routings split over those (jamba: one layer in two).

A state-space slot (mamba, rwkv) keeps a recurrent state that ignores
``len``, so ``FAULTS``' ``ahead`` and ``behind`` cannot touch it and
``lost_slot`` touches attention slots only; ``ssm_faults`` plants in
the state itself (zeroed, or the conv/shift state one token stale). A
recurrent state forgets: with random weights rwkv6's decay sits at its
clamp, exp(-0.25) = 0.78 a position, and mamba's near exp(-0.3), so a
fault planted TAIL positions before the compared logits has faded (to
0.78^32 = 3.5e-4 of its size); ``chip_smoke.py`` holds these faults one
decoded position after the prefill.

A config with an encoder or cross slots (whisper, llama-vision) takes a
context in both prefills (``ctx``); its decode reads the cross K/V that
the prefill cached and never the context. ``cross_faults`` plant in
those: one layer's zeroed, or every layer's from another context's
prefill, which only a decode that reads the cache its prefill filled
can tell apart (the Server's zero context cannot: a context of zeros
gives K = V = 0 in a cross slot without biases).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np
import torch

from ..configs import get_config
from ..models import routes as route_hooks
from ..models.lm import CROSS_KV, LM

ARCH = "qwen1.5-0.5b"
TAIL = 32
SEEDS = 3


def _attn_slots(cache):
    # self-attention entries: a cross slot's ck/cv hold no positions
    return [kv for key, kv in cache.items()
            if key.startswith("slot") and isinstance(kv, dict)
            and "k" in kv]


def _lose_last_slot(cache):
    # the prefill's last position: its slot, or the ring's last after a
    # prefill longer than a sliding window (the last W sit in 0..W-1);
    # attention slots only (a state-space slot holds no positions)
    kvs = _attn_slots(cache)
    if not kvs:
        return
    slot = min(cache["len"], kvs[0]["k"].shape[2]) - 1
    for kv in kvs:
        kv["k"][:, :, slot] = 0
        kv["v"][:, :, slot] = 0


# Faults planted in the cache of the shorter prefill before it is decoded:
# decoding one position ahead (past an empty slot) or one behind (over the
# last prefilled token), and the last prefilled position's k/v lost.
FAULTS = {
    "ahead": lambda cache: cache.update(len=cache["len"] + 1),
    "behind": lambda cache: cache.update(len=cache["len"] - 1),
    "lost_slot": _lose_last_slot,
}


def _ssm_states(cache):
    return {key: st for key, st in cache.items()
            if key.startswith("slot") and isinstance(st, tuple)}


def zero_states(cache):
    """Every state-space layer's recurrent state (mamba's ssm, rwkv's wkv)
    zeroed: the decode starts as if nothing had been prefilled."""
    for _, state in _ssm_states(cache).values():
        state.zero_()


def stale_shift(model: LM, prefix: torch.Tensor, attn_block: int = 32):
    """A plant for a cache of ``prefix.shape[1] + 1`` prefilled positions:
    every state-space layer's conv/shift state one token stale, as a
    prefill of ``prefix`` (one position fewer) leaves it; the recurrent
    states are kept. The prefix's prefill runs here, before any route
    replay starts."""
    _, older = model.prefill(prefix, seq_cap=prefix.shape[1],
                             attn_block=attn_block)

    def plant(cache):
        for key, (shift, _) in _ssm_states(cache).items():
            shift.copy_(older[key][0])
    return plant


def ssm_faults(model: LM, prompt: torch.Tensor, prefilled: int,
               attn_block: int = 32):
    """Faults that a state-space slot's cache can hold, for a prefill of
    ``prefilled`` positions of ``prompt``. ``FAULTS``' ``ahead`` and
    ``behind`` move only ``len``, which a recurrent state never reads."""
    return {"state_zeroed": zero_states,
            "stale_shift": stale_shift(model, prompt[:, :prefilled - 1],
                                       attn_block)}


def _cross_kv(cache):
    """(slot, k name, v name) of every cross K/V entry of a cache, in slot
    order: an encoder-decoder attention slot's xk/xv, a cross slot's
    ck/cv."""
    return [(key, k, v) for key, entry in cache.items()
            if key.startswith("slot") and isinstance(entry, dict)
            for k, v in CROSS_KV if k in entry]


def cross_faults(model: LM, prompt: torch.Tensor, prefilled: int,
                 other_ctx: torch.Tensor, attn_block: int = 32):
    """Faults that a cache's cross K/V can hold, for a prefill of
    ``prefilled`` positions of ``prompt``: ``cross_zeroed``, the first
    cross layer's K and V zeroed (the first period of the first slot
    that holds them); ``cross_swapped``, every layer's cross K/V those of
    the same prefill with ``other_ctx``, which runs here, before any
    route replay starts."""
    _, other = model.prefill(prompt[:, :prefilled], other_ctx,
                             seq_cap=prefilled, attn_block=attn_block)

    def zero(cache):
        key, k, v = _cross_kv(cache)[0]
        cache[key][k][0].zero_()
        cache[key][v][0].zero_()

    def swap(cache):
        for key, k, v in _cross_kv(cache):
            cache[key][k].copy_(other[key][k])
            cache[key][v].copy_(other[key][v])
    return {"cross_zeroed": zero, "cross_swapped": swap}


def prefill_decode_logits(model: LM, prompt: torch.Tensor, tail: int,
                          attn_block: int = 32, plant=None,
                          fixed_routes: bool = False, ctx=None):
    """(L1, L2) float32 last logits of ``prompt`` (1, n): whole prefill,
    and prefill of n - tail positions plus ``tail`` decode steps, with
    ``plant(cache)`` applied to that prefill's cache first when given.
    ``fixed_routes`` (MoE models): L2 replays the routes of L1's prefill
    (see the module's docstring). ``ctx``: the context of a config with
    an encoder or cross slots, given to both prefills."""
    n = prompt.shape[1]
    routes: list = []
    with route_hooks.calls(routes) if fixed_routes \
            else contextlib.nullcontext():
        l1, _ = model.prefill(prompt, ctx, seq_cap=n, attn_block=attn_block)
    replay = contextlib.nullcontext()
    if fixed_routes:
        # calls run MoE layer by MoE layer, each over its chunks in order
        n_layers = sum(layer.moe is not None for layer in model.layers)
        per = len(routes) // n_layers
        routes = [tuple(torch.cat([getattr(r, f) for r in
                                   routes[i * per:(i + 1) * per]], dim=1)
                        for f in ("expert", "keep", "gate"))
                  for i in range(n_layers)]
        replay = route_hooks.served(routes, n_layers, n - tail)
    with replay:
        l2, cache = model.prefill(prompt[:, :n - tail], ctx, seq_cap=n + 1,
                                  attn_block=attn_block)
        if plant is not None:
            plant(cache)
        for i in range(n - tail, n):
            l2, cache = model.decode_step(prompt[:, i:i + 1], cache)
    return l1.float(), l2.float()


def rel_gap(l1: torch.Tensor, l2: torch.Tensor) -> float:
    return float((l1 - l2).norm() / l1.norm())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    on_card = args.device is None or torch.device(args.device).type == "cuda"
    if on_card:
        cfg, n, dtypes = get_config(ARCH), 2048, ("bfloat16",)
    else:
        cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=24)
        n, dtypes = 256, ("float32", "bfloat16")
    for dtype in dtypes:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        for seed in range(SEEDS):
            model = LM(cfg, device=args.device,
                       generator=torch.Generator().manual_seed(seed))
            toks = np.random.default_rng(seed).integers(2, cfg.vocab, n)
            prompt = torch.as_tensor(toks, device=model.device)[None]
            gaps = {name: rel_gap(*prefill_decode_logits(
                model, prompt, TAIL, plant=plant))
                for name, plant in {"none": None, **FAULTS}.items()}
            print(f"{cfg.name} d {cfg.d_model}, {cfg.n_layers} layers, "
                  f"{dtype}, prompt {n}, seed {seed}: ||L1 - L2|| / ||L1|| "
                  + ", ".join(f"{k} {g:.4e}" for k, g in gaps.items()),
                  flush=True)
            del model


if __name__ == "__main__":
    main()
