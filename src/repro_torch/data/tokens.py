"""Versioned training-data tables: the port's engine as the data substrate
(the counterpart of ``repro.data.tokens``).

A token dataset is a versioned table ``(sample_id, split, n_tokens,
tokens LOB)``. Data engineers branch it, edit it, review the diff and
merge back, while a training job pins a *snapshot*, so every run reads
the same rows and no edit that lands after the pin reaches it. The rows,
their bytes and the snapshot semantics are the reference's, so one
corpus gives equal tables in both packages.
"""
from __future__ import annotations

import numpy as np

from ..core import Column, CType, Engine, Schema, Snapshot
from ..interop import to_numpy

TOKENS_SCHEMA = Schema(
    columns=(
        Column("sample_id", CType.I64),
        Column("split", CType.I32),          # 0=train 1=eval
        Column("n_tokens", CType.I32),
        Column("tokens", CType.LOB),         # uint32 token bytes
    ),
    primary_key=("sample_id",),
)


def create_token_table(engine: Engine, name: str) -> None:
    engine.create_table(name, TOKENS_SCHEMA)


def add_samples(engine: Engine, table: str, sample_ids: np.ndarray,
                token_arrays, split: int = 0) -> int:
    """Append tokenized samples; tokens stored as little-endian uint32 LOBs."""
    blobs = [np.asarray(t, np.uint32).tobytes() for t in token_arrays]
    return engine.insert(table, {
        "sample_id": np.asarray(sample_ids, np.int64),
        "split": np.full((len(blobs),), split, np.int32),
        "n_tokens": np.asarray([len(t) for t in token_arrays], np.int32),
        "tokens": blobs,
    })


def decode_tokens(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, np.uint32)


def synth_corpus(engine: Engine, table: str, n_samples: int,
                 sample_len: int, vocab: int, seed: int = 0) -> None:
    """Synthetic corpus with a learnable structure (k-gram repetition):
    the reference's samples, drawn from the same numpy generator."""
    rng = np.random.default_rng(seed)
    toks = []
    for _ in range(n_samples):
        base = rng.integers(2, vocab, size=max(4, sample_len // 4))
        arr = np.tile(base, 5)[:sample_len]
        toks.append(arr.astype(np.uint32))
    add_samples(engine, table, np.arange(n_samples), toks)


class PinnedDataset:
    """A snapshot-pinned view of a token table (training never sees edits
    that land after the pin). Rows are read once, in sample-id order, and
    kept on the host: a batch is a handful of LOB decodes."""

    def __init__(self, engine: Engine, snapshot: Snapshot):
        self.engine = engine
        self.snapshot = snapshot
        t = engine.table(snapshot.table)
        batch, _ = t.scan(snapshot.directory)
        ids = to_numpy(batch["sample_id"])
        order = np.argsort(ids, kind="stable")
        self.sample_ids = ids[order]
        self.blobs = batch["tokens"][order]
        self.n = int(self.sample_ids.shape[0])

    def sample_tokens(self, i: int) -> np.ndarray:
        return decode_tokens(self.blobs[i])
