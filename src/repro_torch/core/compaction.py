"""Background compaction (paper §4, §5.4).

Compaction is a transaction that rewrites the *visible* rows of a set of
data objects into fresh, fully-sorted objects and drops the old data
objects together with every tombstone object that exclusively targets
them (a tombstone object never outlives its target data objects —
otherwise dropped tombstones would resurrect rows).

Rows keep their ORIGINAL commit timestamps, so MVCC reads at older
horizons remain correct through the PITR directory history; named
snapshots pin the pre-compaction objects against GC. Moves produced here
(same value, new position) are what §5.2's move-handling must absorb
during merge.

The rewrite rides the zero-rehash path: every signature lane is gathered
from the sealed objects, and the one global order is the stable 128-bit
key sort (``np.lexsort((key_hi, key_lo))`` of the reference), so the
sealed bytes equal the reference's.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import ops
from . import telemetry
from .faults import crash_point, register
from .objects import OBJECT_CAPACITY, DataObject, rowid_oid, seal_data_object
from .schema import concat_batches, take_batch
from .visibility import visibility_index

SP_COMPACTION = telemetry.register_span(
    "compaction", "rewrite the visible rows of a set of data objects "
    "into fresh fully-sorted objects")

# compaction policy: objects under SMALL_FRAC of capacity are rewritten,
# once at least MIN_OBJECTS qualify
MIN_OBJECTS = 2
SMALL_FRAC = 0.25

CP_TORCH_COMPACT_POST_SEAL = register(
    "torch.compaction.post_seal",
    "after the rewritten objects are sealed but before the compact record "
    "is logged or the directory swings — recovery must show the "
    "pre-compaction layout (logically identical content)")


def pick_compaction_sources(engine, table: str) -> Sequence[int]:
    """Deterministic policy: compact data objects that are small (< 25% of
    capacity) or carry any dead rows, once there are at least two of them."""
    t = engine.table(table)
    vi = visibility_index(engine.store, t.directory)
    picked = []
    for oid in t.directory.data_oids:
        obj: DataObject = engine.store.get(oid)
        if obj.nrows < OBJECT_CAPACITY * SMALL_FRAC:
            picked.append(oid)
            continue
        if vi.has_kills(obj):
            picked.append(oid)
    return picked if len(picked) >= MIN_OBJECTS else []


def compact_objects(engine, table: str, src_oids: Sequence[int],
                    *, _log: bool = True) -> int:
    """Rewrite the visible rows of ``src_oids`` into fresh objects.

    Returns the number of new data objects written."""
    with telemetry.span(SP_COMPACTION):
        return _compact_objects(engine, table, src_oids, _log=_log)


def _compact_objects(engine, table: str, src_oids: Sequence[int],
                     *, _log: bool) -> int:
    t = engine.table(table)
    live = set(t.directory.data_oids)
    src = [o for o in src_oids if o in live]
    if not src:
        return 0
    vi = visibility_index(engine.store, t.directory)
    batches, tss, rlo, rhi, klo, khi, lsigs = [], [], [], [], [], [], []
    for oid in src:
        obj: DataObject = engine.store.get(oid)
        idx = torch.nonzero(vi.visible_mask(obj)).flatten()
        if idx.shape[0] == 0:
            continue
        batches.append(take_batch(obj.cols, idx))
        tss.append(obj.commit_ts[idx])         # ORIGINAL commit ts preserved
        rlo.append(obj.row_lo[idx])
        rhi.append(obj.row_hi[idx])
        klo.append(obj.key_lo[idx])
        khi.append(obj.key_hi[idx])
        lsigs.append({k: v[idx] for k, v in obj.lob_sigs.items()})
    new_oids = []
    if batches:
        batch = concat_batches(t.schema, batches, engine.device)
        ts = torch.cat(tss)
        row_lo, row_hi = torch.cat(rlo), torch.cat(rhi)
        if t.schema.has_pk:
            key_lo, key_hi = torch.cat(klo), torch.cat(khi)
        else:
            key_lo, key_hi = row_lo, row_hi  # NoPK: key IS the row signature
        lob = {k: torch.cat([d[k] for d in lsigs]) for k in lsigs[0]}
        # the stable sort of the sign-flipped words: np.lexsort's order,
        # ties broken by position
        order = ops._sort128(key_lo, key_hi)
        for s in range(0, order.shape[0], OBJECT_CAPACITY):
            idx = order[s:s + OBJECT_CAPACITY]
            rl, rh = row_lo[idx], row_hi[idx]
            kl = rl if key_lo is row_lo else key_lo[idx]
            kh = rh if key_hi is row_hi else key_hi[idx]
            # lint: runs-ok the global key sort above already ordered every
            # capacity slice
            obj = seal_data_object(
                engine.store.new_oid(), t.schema, take_batch(batch, idx),
                ts[idx], rl, rh, kl, kh,
                {k: v[idx] for k, v in lob.items()}, presorted=True)
            engine.store.put(obj)
            new_oids.append(obj.oid)

    # drop tombstone objects that only target compacted data objects
    src_set = set(src)
    drop_tombs = []
    for toid in t.directory.tomb_oids:
        tomb = engine.store.get(toid)
        targets = set(torch.unique(rowid_oid(tomb.target)).tolist())
        if targets and targets <= src_set:
            drop_tombs.append(toid)

    apply_ts = engine.next_ts()
    crash_point(CP_TORCH_COMPACT_POST_SEAL)
    # log-before-swing (like _commit phase 2): once the record is durable
    # replay re-runs the whole compaction; before it, nothing happened
    if _log:
        engine.wal.append("compact", table=table, src_oids=tuple(src),
                          ts=apply_ts)
    t.set_directory(t.directory.replace(
        drop_data=src, drop_tombs=drop_tombs, add_data=new_oids,
        ts=apply_ts))
    return len(new_oids)


def compact_table(engine, table: str) -> int:
    """Run one round of policy-driven compaction. Returns #objects written."""
    src = pick_compaction_sources(engine, table)
    if not src:
        return 0
    return compact_objects(engine, table, src)
