"""Batched serving: a continuous-batching decode loop.

Counterpart of ``repro.launch.serve``. Prefills requests into per-slot
caches (KV for attention layers, the recurrent state for mamba and rwkv
layers), then decodes in lockstep; a slot whose request finishes is
immediately refilled from the queue (continuous batching). Prefill
attention runs the flash kernel on the card.

A config with an encoder or cross slots (whisper-medium,
llama-3.2-vision-90b) gets the reference's stub context with every
request: ``cross_len`` zero patch embeddings, or 8 zero frames for
whisper, in bf16 (ROADMAP Queue 3: a served request attends zeros).

Usage, on the card at the published widths (``--layers`` cuts the depth
to the stack's first layers: jamba-1.5-large-398b does not fit one card
whole, ``--layers 5`` does; llama-3.2-vision-90b ``--layers 30``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --requests 8 --max-new 32
  ... --arch jamba-1.5-large-398b --layers 5
  ... --arch whisper-medium
and on the CPU at the reduced widths (``--device cpu``: the reduced
configs' head dim 16 has no kernel instance, so the card takes the
published widths only).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import first_layers, get_config
from ..device import resolve_device
from ..models.lm import LM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class Server:
    """Fixed-batch continuous-batching server (one cache per slot).

    ``arch``: a config name or an ``ArchConfig`` (``reduced`` shrinks
    either; pass ``reduced=False`` for a config already cut to size).
    ``params``: a state dict of :class:`LM` (e.g. from
    ``models.convert.params_from_numpy``) in place of the seeded weights.
    ``timings`` holds, after :meth:`run`, the host seconds of each prefill
    and of each lockstep decode step (each ends in a device-to-host read of
    the argmax, so it covers the device work)."""

    def __init__(self, arch, *, reduced: bool = True, batch: int = 4,
                 seq_cap: int = 256, attn_block: int = 32,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device=None):
        cfg = get_config(arch) if isinstance(arch, str) else arch
        self.cfg = cfg.reduced() if reduced else cfg
        self.device = resolve_device(device)
        self.batch = batch
        self.seq_cap = seq_cap
        self.attn_block = attn_block
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model = LM(self.cfg, device=self.device, generator=gen)
        if params is not None:
            self.model.load_state_dict(params)
        self.slots: List[Optional[Request]] = [None] * batch
        self.caches: List = [None] * batch
        self.timings: Dict[str, List[float]] = {"prefill_s": [],
                                                "decode_step_s": []}

    def _prefill_one(self, req: Request):
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                               device=self.device)[None]
        ctx = None
        if self.model.needs_context:
            # the reference's stub: zeros, bf16, cross_len positions or 8
            ctx = torch.zeros((1, self.cfg.cross_len or 8,
                               self.cfg.d_model), dtype=torch.bfloat16,
                              device=self.device)
        # The reference pads with token 0 and returns the logits of the
        # last (pad) position; parity keeps that (ROADMAP Queue 3). A
        # mamba or rwkv layer's state then holds the pad tokens too, and
        # decode continues from it: the reference's fault, kept as well.
        pad = (-toks.shape[1]) % self.attn_block
        if pad:
            toks = F.pad(toks, (0, pad))
        logits, cache = self.model.prefill(toks, ctx, seq_cap=self.seq_cap,
                                           attn_block=self.attn_block)
        if pad:  # position counter must reflect the unpadded prompt
            cache["len"] -= pad
        return logits, cache

    def run(self, requests: List[Request], greedy: bool = True):
        queue = list(requests)
        self.timings = {"prefill_s": [], "decode_step_s": []}
        t0 = time.perf_counter()  # monotonic: a wall-clock step breaks dt
        steps = 0
        while any(s is not None for s in self.slots) or queue:
            # fill empty slots (continuous batching)
            for i in range(self.batch):
                if self.slots[i] is None and queue:
                    t1 = time.perf_counter()
                    req = queue.pop(0)
                    logits, cache = self._prefill_one(req)
                    req.out.append(int(torch.argmax(logits[0])))
                    self.slots[i] = req
                    self.caches[i] = cache
                    self.timings["prefill_s"].append(time.perf_counter() - t1)
            if all(s is None for s in self.slots):
                break
            # lockstep decode over active slots
            t1 = time.perf_counter()
            for i in range(self.batch):
                req = self.slots[i]
                if req is None or req.done:
                    continue
                tok = torch.tensor([[req.out[-1]]], device=self.device)
                logits, self.caches[i] = self.model.decode_step(
                    tok, self.caches[i])
                req.out.append(int(torch.argmax(logits[0])))
            self.timings["decode_step_s"].append(time.perf_counter() - t1)
            steps += 1
            for i in range(self.batch):
                if self.slots[i] is not None and self.slots[i].done:
                    self.slots[i] = None
                    self.caches[i] = None
        dt = time.perf_counter() - t0
        return requests, dt, steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the stack's first N layers only")
    ap.add_argument("--device", default=None,
                    help="default: the card at the published widths; "
                         "'cpu' for the reduced widths on the CPU")
    args = ap.parse_args(argv)
    on_cpu = args.device is not None and \
        torch.device(args.device).type == "cpu"
    cfg = get_config(args.arch)
    cfg = cfg.reduced() if on_cpu else cfg
    if args.layers is not None:
        cfg = first_layers(cfg, args.layers)
    srv = Server(cfg, reduced=False, batch=args.batch, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, srv.cfg.vocab, size=16).astype(np.int32),
                    args.max_new) for i in range(args.requests)]
    done, dt, steps = srv.run(reqs)
    tput = sum(len(r.out) for r in done) / dt
    print(f"served {len(done)} requests, {steps} decode steps, "
          f"{tput:.1f} tok/s")


if __name__ == "__main__":
    main()
