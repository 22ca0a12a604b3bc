"""MoE routing recorded in one run and replayed in another: the hooks on
``layers.moe_route`` that the port's checks share.

Training (:func:`recorded`, :func:`replayed`). A training step on the
card and the same step on the CPU compute one function only while every
token takes the same experts: bf16 rounding that flips a near-tie of the
router's probabilities, or pushes a choice past its expert's capacity,
changes that token's FFN output wholesale. So the card's step records
each chunk's top-k choices and the CPU's step replays them; the CPU still
computes its own probabilities, gates and aux loss from them, so its
gradients are its own, through the replayed choices.

A chunk is keyed by its layer (the order in which the forward first
routes through each router) and its first position. The chunks of a
sequence route in order, in the forward and again when remat's backward
recomputes a period, so a chunk's first position is the number of tokens
its router routed before it, modulo the step's sequence length
(``RouteLog.seq_len``). Recording compares a recompute's choices with
the forward's and counts any that differ (``RouteLog.recompute_flips``);
replaying serves the recompute the same choices as the forward.

Serving (:func:`calls`, :func:`served`). The prefill-vs-decode check of
``benchmarks.serve_consistency`` keeps every routing of the whole prefill
in call order and serves its expert, keep and gate, position by
position, to the shorter prefill and the decode steps.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from . import layers


@contextlib.contextmanager
def _patched(route_fn):
    route = layers.moe_route
    layers.moe_route = route_fn
    try:
        yield
    finally:
        layers.moe_route = route


@contextlib.contextmanager
def calls(store: list):
    """Keep every ``layers.moe_route`` result, in call order."""
    route = layers.moe_route

    def record(router, x, **kw):
        r = route(router, x, **kw)
        store.append(r)
        return r
    with _patched(record):
        yield store


# ------------------------------------------------------------ training

class RouteLog:
    """Each chunk's expert choices (B, sc, k) on the CPU, by (layer,
    start), for steps over sequences of ``seq_len`` tokens, and the
    choices a recompute routed differently."""

    def __init__(self, seq_len: int):
        self.seq_len = seq_len
        self.choices: Dict[Tuple[int, int], torch.Tensor] = {}
        self.recompute_flips = 0


def _chunk_keys(seq_len: int):
    """A function giving a call's (layer, first position): the router's
    place among the routers in the order they first route, and the tokens
    it routed before this call, modulo ``seq_len``."""
    routers: List[torch.Tensor] = []
    routed: List[int] = []

    def key(router, x) -> Tuple[int, int]:
        for i, r in enumerate(routers):
            if r is router:
                break
        else:
            routers.append(router)
            routed.append(0)
            i = len(routers) - 1
        start = routed[i] % seq_len
        routed[i] += x.shape[1]
        return i, start
    return key


@contextlib.contextmanager
def recorded(log: RouteLog):
    """Route as usual and keep every chunk's choices in ``log``."""
    route, key_of = layers.moe_route, _chunk_keys(log.seq_len)

    def record(router, x, **kw):
        r = route(router, x, **kw)
        key = key_of(router, x)
        choice = r.expert.detach().cpu()
        if key in log.choices:            # a recompute under remat
            log.recompute_flips += int((log.choices[key] != choice).sum())
        else:
            log.choices[key] = choice
        return r
    with _patched(record):
        yield log


@contextlib.contextmanager
def replayed(log: RouteLog):
    """Route every chunk with the choices ``log`` holds for it."""
    route, key_of = layers.moe_route, _chunk_keys(log.seq_len)

    def replay(router, x, **kw):
        choice = log.choices[key_of(router, x)]
        return route(router, x, expert=choice.to(x.device), **kw)
    with _patched(replay):
        yield log


# ------------------------------------------------------------- serving

@contextlib.contextmanager
def served(routes, n_layers: int, first_pass: int):
    """Serve ``layers.moe_route`` from ``routes`` (per layer: expert, keep
    and gate over every position) for a prefill of ``first_pass``
    positions and then one position per decode step: each call takes the
    next positions of its layer. Slots are ranked again among the kept
    choices (j-major, as the reference ranks them), and the capacity of
    a chunk of ``sc`` tokens is the most kept choices of any expert in a
    layer, or ``sc`` if fewer (a token sends an expert one choice at
    most), so nothing more drops."""
    capacity = layers.moe_capacity
    cap = max(int(torch.bincount(e[k], minlength=1).max())
              for e, k, _ in routes)
    cur = {"layer": 0, "start": 0, "pos": 0, "end": first_pass}

    def replay(router, x, *, top_k, capacity):
        e, keep, gate = (t[:, cur["pos"]:cur["pos"] + x.shape[1]]
                         for t in routes[cur["layer"]])
        cur["pos"] += x.shape[1]
        if cur["pos"] == cur["end"]:             # this layer's pass done
            cur["layer"] += 1
            if cur["layer"] == n_layers:         # next: one decode step
                cur.update(layer=0, start=cur["end"], end=cur["end"] + 1)
            cur["pos"] = cur["start"]
        n_experts = router.shape[-1]
        offset = torch.zeros((x.shape[0], n_experts), dtype=torch.int64,
                             device=x.device)
        slots = []
        for j in range(top_k):
            oh = torch.nn.functional.one_hot(e[..., j], n_experts) \
                * keep[..., j, None]
            slots.append(((torch.cumsum(oh, 1) - 1 + offset[:, None])
                          * oh).sum(-1))
            offset = offset + oh.sum(1)
        return layers.Route(e, torch.stack(slots, -1), keep, gate,
                            torch.zeros((), device=x.device))
    layers.moe_capacity = lambda sc, *a: -(-min(cap, sc) // 4) * 4
    try:
        with _patched(replay):
            yield
    finally:
        layers.moe_capacity = capacity
