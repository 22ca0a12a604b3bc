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
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_config
from ..models.lm import LM

ARCH = "qwen1.5-0.5b"
TAIL = 32
SEEDS = 3


def _lose_last_slot(cache):
    pos = cache["len"] - 1
    for key, kv in cache.items():
        if key.startswith("slot"):
            kv["k"][:, :, pos] = 0
            kv["v"][:, :, pos] = 0


# Faults planted in the cache of the shorter prefill before it is decoded:
# decoding one position ahead (past an empty slot) or one behind (over the
# last prefilled token), and the last prefilled position's k/v lost.
FAULTS = {
    "ahead": lambda cache: cache.update(len=cache["len"] + 1),
    "behind": lambda cache: cache.update(len=cache["len"] - 1),
    "lost_slot": _lose_last_slot,
}


def prefill_decode_logits(model: LM, prompt: torch.Tensor, tail: int,
                          attn_block: int = 32, plant=None):
    """(L1, L2) float32 last logits of ``prompt`` (1, n): whole prefill,
    and prefill of n - tail positions plus ``tail`` decode steps, with
    ``plant(cache)`` applied to that prefill's cache first when given."""
    n = prompt.shape[1]
    l1, _ = model.prefill(prompt, seq_cap=n, attn_block=attn_block)
    l2, cache = model.prefill(prompt[:, :n - tail], seq_cap=n + 1,
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
