"""SNAPSHOT DIFF (paper §3, §5.1).

Two execution paths:

  * ``snapshot_diff`` — the built-in path: Δ-object scan + diff
    aggregation. Cost ∝ changed data.
  * ``sql_diff`` — the Listing-2 SQL-equivalent baseline: full scans of
    both snapshots, UNION ALL with ±1, GROUP BY all columns, HAVING ≠ 0.
    Cost ∝ table size.

Both return the same ``DiffResult``: per surviving value-group the net
count (<0 ⇒ only in the left snapshot, >0 ⇒ only in the right) plus the
group's signatures and a representative payload rowid, all tensors on the
store's device. Payload values are gathered lazily by rowid.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import telemetry
from .delta import DeltaStats, SignedStream, full_scan_stream, signed_delta
from .directory import Snapshot
from .objects import ObjectStore, rowid_off, rowid_oid
from .schema import CType, Schema, concat_batches, take_batch
from .sigs import SigBatch

SP_DIFF = telemetry.register_span(
    "diff", "SNAPSHOT DIFF: Δ-scan + diff aggregation")


def _i64(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.int64, device=device)


@dataclass
class DiffResult:
    """Result of SNAPSHOT DIFF between snapshots (left=a, right=b)."""
    schema: Schema
    diff_cnt: torch.Tensor        # (k,) int32 net count per surviving group
    key_lo: torch.Tensor          # (k,) key signature words of the group
    key_hi: torch.Tensor
    row_lo: torch.Tensor          # (k,) value signature words of the group
    row_hi: torch.Tensor
    rowid: torch.Tensor           # (k,) representative payload row
    stats: DeltaStats = field(default_factory=DeltaStats)

    @property
    def n_groups(self) -> int:
        return int(self.diff_cnt.shape[0])

    def is_empty(self) -> bool:
        return self.n_groups == 0

    def payload(self, store: ObjectStore) -> Dict[str, object]:
        """Gather the representative row values for each surviving group."""
        return gather_payload(store, self.schema, self.rowid)

    def per_key_conflicts(self):
        """Group surviving value-groups by key signature: keys with entries
        from BOTH snapshots are the paper's 'potential conflicts'.

        One segsum scan groups the keys (``ops.diff_aggregate``); per-run
        sign presence is a segment sum on the device, and only the
        conflicting runs are materialized, as index tensors into the
        result (views of one gathered tensor)."""
        if self.n_groups == 0:
            return []
        # NoPK results are value-sorted and key == value, so the key
        # grouping is free; PK results need the (small) key sort
        order, agg = ops.diff_aggregate(self.key_lo, self.key_hi,
                                        torch.ones_like(self.diff_cnt),
                                        presorted=not self.schema.has_pk)
        sg = torch.sign(self.diff_cnt[order])
        k = agg.run_starts.shape[0]
        ids = agg.run_ids
        any_pos = _i64(k, sg.device).index_add_(
            0, ids, (sg > 0).to(torch.int64)) > 0
        any_neg = _i64(k, sg.device).index_add_(
            0, ids, (sg < 0).to(torch.int64)) > 0
        both = any_pos & any_neg
        # the conflicting runs' members, still contiguous and in run
        # order, cut by one split (a slice per run costs a host call each)
        return list(torch.split(order[both[ids]],
                                agg.run_lens[both].tolist()))


def gather_payload(store: ObjectStore, schema: Schema,
                   rowids: torch.Tensor, *, with_sigs: bool = False,
                   runs: Optional[np.ndarray] = None):
    """Materialize full rows by physical rowid (preserves input order).

    ``with_sigs=True`` returns ``(batch, SigBatch)`` with the rows'
    write-once signatures gathered from the same objects — zero hashing —
    so the batch can be re-sealed verbatim. ``runs`` is the CALLER's
    sortedness claim about the ``rowids`` sequence, carried into the
    sidecar untouched. LOB rows are taken with one host copy of the index
    vector, every other column by device indexing."""
    n = rowids.shape[0]
    dev = store.device
    oids = rowid_oid(rowids)
    offs = rowid_off(rowids)
    alias = with_sigs and not schema.has_pk
    lob_names = ([c.name for c in schema.columns if c.ctype is CType.LOB]
                 if with_sigs else [])
    if n and bool((oids == oids[0]).all()):
        # single-object fast path: direct takes, no split or permutation
        obj = store.get(int(oids[0]))
        batch = take_batch(obj.cols, offs)
        if not with_sigs:
            return batch
        row_lo, row_hi = obj.row_lo[offs], obj.row_hi[offs]
        if alias:
            key_lo, key_hi = row_lo, row_hi
        else:
            key_lo, key_hi = obj.key_lo[offs], obj.key_hi[offs]
        lob = {c: obj.lob_sigs[c][offs] for c in lob_names}
        # lint: runs-ok the claim is the caller's, about this input order
        return batch, SigBatch(row_lo, row_hi, key_lo, key_hi, lob,
                               runs=runs)
    batches, perm, sig_parts = [], [], []
    for oid in torch.unique(oids).tolist():
        sel = torch.nonzero(oids == oid).flatten()
        obj = store.get(int(oid))
        o = offs[sel]
        batches.append(take_batch(obj.cols, o))
        perm.append(sel)
        if with_sigs:
            sig_parts.append(
                (obj.row_lo[o], obj.row_hi[o],
                 None if alias else obj.key_lo[o],
                 None if alias else obj.key_hi[o],
                 {c: obj.lob_sigs[c][o] for c in lob_names}))
    if not batches:
        empty = concat_batches(schema, [], dev)
        if not with_sigs:
            return empty
        z64 = _i64(0, dev)
        # lint: runs-ok an empty batch is trivially sorted
        return empty, SigBatch(z64, z64, z64, z64,
                               {c: z64 for c in lob_names},
                               runs=np.zeros((0,), np.int64))
    merged = concat_batches(schema, batches, dev)
    flat = torch.cat(perm)
    if flat.shape[0] > 1 and bool((flat[1:] > flat[:-1]).all()):
        # ascending oids ⇒ the per-object concat order IS the input order
        inv = None
        batch = merged
    else:
        inv = torch.empty((n,), dtype=torch.int64, device=dev)
        inv[flat] = torch.arange(n, device=dev)
        batch = take_batch(merged, inv)
    if not with_sigs:
        return batch
    reorder = (lambda a: a) if inv is None else (lambda a: a[inv])
    row_lo = reorder(torch.cat([p[0] for p in sig_parts]))
    row_hi = reorder(torch.cat([p[1] for p in sig_parts]))
    if alias:
        key_lo, key_hi = row_lo, row_hi
    else:
        key_lo = reorder(torch.cat([p[2] for p in sig_parts]))
        key_hi = reorder(torch.cat([p[3] for p in sig_parts]))
    lob = {c: reorder(torch.cat([p[4][c] for p in sig_parts]))
           for c in lob_names}
    # lint: runs-ok the claim is the caller's, about this input order
    return batch, SigBatch(row_lo, row_hi, key_lo, key_hi, lob, runs=runs)


def gather_rowsigs(store: ObjectStore, rowids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-value signatures at physical rowids (preserves input order).

    The Δ-sized value identity probe: two rows are byte-identical iff
    their 128-bit row signatures match, so revert's "is the current row
    still the one being reverted away?" check never gathers payloads.
    Only the distinct oids come to the host; every gather runs on the
    rowids' device."""
    oids = rowid_oid(rowids)
    offs = rowid_off(rowids)
    uniq = torch.unique(oids).tolist()
    if len(uniq) == 1:
        obj = store.get(int(uniq[0]))  # single-object fast path
        return obj.row_lo[offs], obj.row_hi[offs]
    lo = torch.zeros_like(rowids)
    hi = torch.zeros_like(rowids)
    for oid in uniq:
        sel = torch.nonzero(oids == oid).flatten()
        obj = store.get(int(oid))
        o = offs[sel]
        lo[sel] = obj.row_lo[o]
        hi[sel] = obj.row_hi[o]
    return lo, hi


def _aggregate_stream(schema: Schema, stream: SignedStream,
                      stats: DeltaStats,
                      store: Optional[ObjectStore] = None) -> DiffResult:
    """Diff aggregation: cancel identical changes, keep net per
    value-group.

    Grouping is by full row signature (Listing-2 multiset semantics),
    executed sort-free along the stream's presorted key order; for PK
    streams only the *surviving* groups pay a final sort into the
    value-signature output order. The representative payload rowid per
    group prefers a + row and falls back to a − row."""
    if stream.n == 0:
        z64 = _i64(0, stream.sign.device)
        return DiffResult(schema, torch.zeros((0,), dtype=torch.int32,
                                              device=z64.device),
                          z64, z64, z64, z64, z64, stats)
    # streams served from the delta memo are immutable, so their
    # aggregation is a pure function too
    memo = getattr(stream, "_agg_memo", None)
    if memo is not None:
        return DiffResult(schema, *memo, stats)
    # key-range sharding (derived plan): byte-identical to unsharded
    from ..distributed import sharding as ksh
    shards = ksh.key_shard_count(stream.n)
    cuts = None
    if shards > 1 and not stream.sorted_by_key and stream.runs is not None:
        cuts = ksh.plan_key_cuts(stream.key_lo, stream.key_hi,
                                 stream.runs, shards)
        if cuts is not None and store is not None:
            store.metrics.add("probe.shard_parts", cuts[0].shape[0] + 1)
    st = stream.merge_by_key(cuts=cuts)  # always globally key-sorted, n > 0
    _, agg = ops.diff_aggregate_rows(st.key_lo, st.key_hi,
                                     st.row_lo, st.row_hi, st.sign,
                                     presorted=True)
    surviving = agg.run_sums != 0
    if bool(surviving.all()):  # pure-churn diffs: nothing cancelled
        keep = None
        diff_cnt, starts = agg.run_sums, agg.run_starts
    else:
        keep = torch.nonzero(surviving).flatten()
        diff_cnt, starts = agg.run_sums[keep], agg.run_starts[keep]
    # representative rowid: first element in the run whose sign matches
    # the net direction; only runs whose head mismatches pay the argmin
    n = st.n
    want = torch.sign(agg.run_sums)
    rep_pos = agg.run_starts.clone()
    bad = torch.nonzero((st.sign[agg.run_starts] != want)
                        & (agg.run_sums != 0)).flatten()
    if bad.shape[0]:
        seg, _, flat = ops.segment_expand(agg.run_starts[bad],
                                          agg.run_lens[bad])
        score = torch.where(st.sign[flat] == want[bad][seg], flat, n)
        rep_pos[bad] = torch.full((bad.shape[0],), n, dtype=torch.int64,
                                  device=score.device).scatter_reduce(
            0, seg, score, reduce="amin")
    key_lo, key_hi = st.key_lo[starts], st.key_hi[starts]
    row_lo = key_lo if st.row_lo is st.key_lo else st.row_lo[starts]
    row_hi = key_hi if st.row_hi is st.key_hi else st.row_hi[starts]
    rep = rep_pos if keep is None else rep_pos[keep]
    fields = [diff_cnt.to(torch.int32), key_lo, key_hi, row_lo, row_hi,
              st.rowid[rep]]
    if not st.key_is_row and diff_cnt.shape[0] > 1:
        # PK stream: groups surfaced in key order, but the DiffResult
        # contract is value-signature order — sort just the survivors
        fo = ops._sort128(fields[3], fields[4])
        fields = [f[fo] for f in fields]
    fields = tuple(fields)
    stream._agg_memo = fields
    return DiffResult(schema, *fields, stats)


def snapshot_diff(store: ObjectStore, a: Snapshot, b: Snapshot) -> DiffResult:
    """Built-in SNAPSHOT DIFF: Δ-scan + diff aggregation (paper §5.1)."""
    if not a.schema.compatible_with(b.schema):
        raise ValueError("SNAPSHOT DIFF: snapshots have incompatible schemas")
    with telemetry.span(SP_DIFF):
        stats = DeltaStats()
        stream = signed_delta(store, a.directory, b.directory, stats)
        return _aggregate_stream(a.schema, stream, stats, store)


def sql_diff(store: ObjectStore, a: Snapshot, b: Snapshot) -> DiffResult:
    """Listing-2 baseline: full scan of both snapshots + global
    aggregation."""
    if not a.schema.compatible_with(b.schema):
        raise ValueError("SNAPSHOT DIFF: snapshots have incompatible schemas")
    stats = DeltaStats()
    stream = SignedStream.concat([
        full_scan_stream(store, a.directory, -1, stats),
        full_scan_stream(store, b.directory, +1, stats),
    ], store.device)
    return _aggregate_stream(a.schema, stream, stats, store)
