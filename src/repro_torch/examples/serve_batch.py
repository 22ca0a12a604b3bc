"""Batched serving with continuous batching: reduced mixtral, with its MoE
FFN and its sliding window (the port of ``examples/serve_batch.py``), or
another reduced config (``--arch``: rwkv6-7b's recurrent layers,
jamba-1.5-large-398b's mamba, attention and MoE layers, whisper-medium's
encoder and cross sublayers, llama-3.2-vision-90b's cross layers, the
last two over the server's stub context).

Ten requests of 8-31 prompt tokens and 24 new tokens each through a
4-slot server; prompts are padded to the 16-token attention block, so
the longer ones prefill past the reduced window of 16 positions. The
reduced config's head dim is widened from 16 to 64, the smallest the
flash kernel is built for, so the same model runs on both devices.

  PYTHONPATH=src python -m repro_torch.examples.serve_batch --device cpu
  ... --arch rwkv6-7b --device cpu

Without ``--device`` it runs on the card.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..configs import get_config
from ..launch.serve import Request, Server

ARCH = "mixtral-8x7b"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run on the CPU")
    ap.add_argument("--arch", default=ARCH)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(args.arch).reduced(), head_dim=64)
    srv = Server(cfg, reduced=False, batch=4, seq_cap=128, attn_block=16,
                 device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, cfg.vocab, size=int(
        rng.integers(8, 32))).astype(np.int32), max_new=24)
        for i in range(10)]
    done, dt, steps = srv.run(reqs)
    total = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.1f}s "
          f"({steps} lockstep decode rounds, continuous batching)")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}...")
    return done


if __name__ == "__main__":
    main()
