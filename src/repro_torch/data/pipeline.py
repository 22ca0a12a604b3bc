"""Deterministic, resumable, host-sharded batch pipeline (the counterpart
of ``repro.data.pipeline``).

Every global step is a pure function of (snapshot, seed, step): numpy's
``default_rng(SeedSequence([seed, step]))`` draws the step's samples, as
the reference does, so both packages build the same batches bit for bit
and a restarted worker regenerates exactly the batches it owes. Each host
materializes only its data-parallel slice of the global batch. Batches
are numpy on the host; :meth:`BatchPipeline.tensors_at` moves one to a
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from .tokens import PinnedDataset


@dataclass(frozen=True)
class PipelineCfg:
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


class BatchPipeline:
    def __init__(self, ds: PinnedDataset, cfg: PipelineCfg):
        if cfg.global_batch % cfg.host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.host_count} hosts")
        self.ds = ds
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count

    def _rng_for_step(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The local slice of the global batch for ``step`` (deterministic):
        ``tokens`` and ``targets`` (next tokens, -1 past a sample's end),
        (local_batch, seq_len) int32."""
        rng = self._rng_for_step(step)
        # one global draw per step; each host takes its slice
        idx = rng.integers(0, self.ds.n, size=self.cfg.global_batch)
        lo = self.cfg.host_index * self.local_batch
        idx = idx[lo:lo + self.local_batch]
        S = self.cfg.seq_len
        tokens = np.zeros((self.local_batch, S), np.int32)
        targets = np.full((self.local_batch, S), -1, np.int32)
        for r, i in enumerate(idx):
            t = self.ds.sample_tokens(int(i))
            if t.shape[0] < 2:
                continue
            take = min(S + 1, t.shape[0])
            tokens[r, :take - 1] = t[:take - 1]
            targets[r, :take - 1] = t[1:take]
        return {"tokens": tokens, "targets": targets}

    def tensors_at(self, step: int, device) -> Dict[str, torch.Tensor]:
        """:meth:`batch_at` as int64 tensors on ``device``."""
        return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
                for k, v in self.batch_at(step).items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
