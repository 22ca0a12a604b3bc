"""Versioned checkpointing: model and optimizer state stored in the port's
version-control engine (the counterpart of ``repro.checkpoint.vcs_ckpt``).

Each checkpoint writes the tensors of a training-state tree as fixed-size
shard rows of a versioned table ``(shard_id, data LOB)`` and tags a named
snapshot. Snapshots are metadata only, so keeping every N-step checkpoint
is free until GC, a fine-tune fork is a CLONE, NaN recovery is a RESTORE
to the last good tag, and SNAPSHOT DIFF counts the shards that changed
between two tags (an incremental upload's set).

The layout is the reference's, leaf for leaf: the tree is flattened as
``jax.tree_util.tree_flatten_with_path`` flattens it (dict keys sorted,
a NamedTuple's fields in order, named ``.field``; names joined by ``/``),
each leaf's raw little-endian bytes are cut into 4 MiB shards, and shard
ids run over the leaves in that order. One state (the reference's
stacked tree, ``models.convert.stack_tree``) gives byte-identical shard
rows in both packages, so a checkpoint written by one restores in the
other. Tensors leave the card once per save (one device-to-host copy per
leaf) and go back once per restore.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core import Column, CType, Engine, Schema, Snapshot, snapshot_diff
from ..interop import to_numpy

# No per-row step column: shard rows must be value-identical across
# checkpoints when the tensor bytes are unchanged, so SNAPSHOT DIFF counts
# only the shards that really changed.
CKPT_SCHEMA = Schema(
    columns=(
        Column("shard_id", CType.I64),
        Column("data", CType.LOB),
    ),
    primary_key=("shard_id",),
)

SHARD_BYTES = 4 << 20  # 4 MiB logical shards


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_state(state, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order and naming."""
    if isinstance(state, dict):
        out = []
        for key in sorted(state):
            out += _flatten_state(state[key], f"{prefix}{key}/")
        return out
    if _is_namedtuple(state):
        out = []
        for field in state._fields:
            out += _flatten_state(getattr(state, field),
                                  f"{prefix}.{field}/")
        return out
    return [(prefix[:-1], state)]


def _unflatten_like(like, leaves):
    """A tree shaped like ``like`` with its leaves taken from ``leaves``
    (an iterator, in :func:`_flatten_state` order)."""
    if isinstance(like, dict):
        return {key: _unflatten_like(like[key], leaves)
                for key in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten_like(getattr(like, f), leaves)
                            for f in like._fields))
    return next(leaves)


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name for the tensor's dtype (bfloat16 as the reference's
    ``ml_dtypes`` names it)."""
    return str(t.dtype).split(".")[-1]


def _raw(t: torch.Tensor) -> memoryview:
    """The tensor's bytes in memory order on the host (one copy off the
    card), little-endian as numpy's ``tobytes``."""
    host = t.detach().contiguous().cpu()
    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    return memoryview(host.numpy().reshape(-1).view(np.uint8))


def _shards(raw: memoryview):
    for off in range(0, max(len(raw), 1), SHARD_BYTES):
        yield bytes(raw[off:off + SHARD_BYTES])


class VcsCheckpointer:
    def __init__(self, engine: Engine, table: str = "ckpt"):
        self.engine = engine
        self.table = table
        if table not in engine.tables:
            engine.create_table(table, CKPT_SCHEMA)
        self._layout: Optional[List[Tuple[str, Tuple, str, int]]] = None

    # ------------------------------------------------------------- save
    def save(self, state, step: int, tag: Optional[str] = None) -> Snapshot:
        """Write state as shard rows (update_by_keys collapses history) and
        tag a named snapshot."""
        layout = []
        shard_ids, blobs = [], []
        sid = 0
        for name, leaf in _flatten_state(state):
            n_shards = 0
            for blob in _shards(_raw(leaf)):
                shard_ids.append(sid)
                blobs.append(blob)
                sid += 1
                n_shards += 1
            layout.append((name, tuple(leaf.shape), _dtype_name(leaf),
                           n_shards))
        self._layout = layout
        t = self.engine.table(self.table)
        tx = self.engine.begin()
        batch = {"shard_id": np.asarray(shard_ids, np.int64), "data": blobs}
        if t.count() == 0:
            tx.insert(self.table, batch)
        else:
            tx.update_by_keys(self.table, batch)
        tx.commit()
        return self.engine.create_snapshot(tag or f"step-{step}", self.table)

    # ---------------------------------------------------------- restore
    def restore(self, snapshot, like_state) -> Any:
        """Restore a tree like ``like_state`` from a checkpoint snapshot:
        each leaf a new tensor with the dtype, shape and device of
        ``like_state``'s."""
        # an exact tag wins before ref parsing, as clone/restore_table do
        snap = self.engine._snapshotish(snapshot, table=self.table)
        t = self.engine.table(self.table)
        batch, _ = t.scan(snap.directory)
        order = np.argsort(to_numpy(batch["shard_id"]), kind="stable")
        blobs = batch["data"][order]
        out = []
        cursor = 0
        for _, like in _flatten_state(like_state):
            need = like.numel() * like.element_size()
            parts, have = [], 0
            while have < max(need, 1) and cursor < len(blobs):
                parts.append(blobs[cursor])
                have += len(blobs[cursor])
                cursor += 1
                if need == 0:
                    break
            raw = bytearray().join(parts)      # one copy, writable
            del raw[need:]
            flat = (torch.frombuffer(raw, dtype=like.dtype) if need
                    else torch.empty((0,), dtype=like.dtype))
            out.append(flat.reshape(like.shape).to(like.device))
        return _unflatten_like(like_state, iter(out))

    # ------------------------------------------------------------ extras
    def rollback(self, tag: str) -> None:
        """Instant revert of the checkpoint table (the paper's RESTORE)."""
        self.engine.restore_table(self.table, tag)

    def fork(self, new_table: str, tag: str) -> "VcsCheckpointer":
        """Instant fine-tune fork: clone the checkpoint table at a tag."""
        self.engine.clone_table(new_table, tag)
        ck = VcsCheckpointer.__new__(VcsCheckpointer)
        ck.engine, ck.table, ck._layout = self.engine, new_table, self._layout
        return ck

    def changed_shards(self, tag_a: str, tag_b: str) -> int:
        """How many shard rows differ between two checkpoints (SNAPSHOT
        DIFF): the incremental-upload set."""
        d = snapshot_diff(self.engine.store, self.engine.snapshots[tag_a],
                          self.engine.snapshots[tag_b])
        return d.n_groups
