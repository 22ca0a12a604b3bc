"""Signed delta streams (paper §5.1 "scanning Δ").

``signed_delta(a, b)`` produces the multiset difference visible(b) −
visible(a) as a signed stream, reading **only** objects in the symmetric
difference of the two directories plus tombstone differences on shared
objects — never the full table. It powers SNAPSHOT DIFF and the
per-branch change sets of merge, including the no-common-base
optimization of §5.3 (shared objects are skipped wholesale).

Stream row fields (tensors on the store's device):
  sign    +1: row visible in b, not in a;  −1: visible in a, not in b
  key_lo/hi   key signature (PK sig; the SAME tensors as row sig for NoPK)
  row_lo/hi   full row-value signature
  rowid       physical location of the row (payload gather source)

Sortedness invariant: data objects are sealed key-sorted, so every
emitted per-object run is already in (key_lo, key_hi) order.
``signed_delta`` k-way merges those presorted runs once and caches the
globally key-sorted stream; diff aggregation and the merge paths then run
sort-free. ``runs`` offsets are host metadata (numpy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels import ops
from . import telemetry
from .directory import Directory
from .objects import DataObject, ObjectStore, pack_rowid
from .visibility import KeyedLRU, visibility_index

SP_SIGNED_DELTA = telemetry.register_span(
    "signed_delta", "build the signed Δ stream for one directory pair")


_FIELDS = ("sign", "key_lo", "key_hi", "row_lo", "row_hi", "rowid")

_RUN0 = np.zeros((1,), np.int64)
_RUN0.setflags(write=False)


@dataclass
class SignedStream:
    """A signed Δ stream with a per-part sortedness invariant.

    ``runs`` (when not None) holds host run-start offsets (``runs[0] ==
    0``): every run ``[runs[i], runs[i+1])`` is sorted by (key_lo,
    key_hi). A single run means the whole stream is key-sorted; ``None``
    means no ordering is known. ``key_is_row`` marks streams whose key
    signature IS the row signature (NoPK emission)."""
    sign: torch.Tensor      # (n,) int32
    key_lo: torch.Tensor    # (n,) int64 words
    key_hi: torch.Tensor
    row_lo: torch.Tensor
    row_hi: torch.Tensor
    rowid: torch.Tensor     # (n,) int64
    runs: Optional[np.ndarray] = None
    key_is_row: bool = False

    @property
    def n(self) -> int:
        return int(self.sign.shape[0])

    @property
    def sorted_by_key(self) -> bool:
        """True iff the whole stream is one key-sorted run."""
        return self.runs is not None and self.runs.shape[0] <= 1

    @staticmethod
    def empty(device) -> "SignedStream":
        z64 = torch.zeros((0,), dtype=torch.int64, device=device)
        # lint: runs-ok an empty stream is trivially sorted
        return SignedStream(torch.zeros((0,), dtype=torch.int32,
                                        device=device),
                            z64, z64, z64, z64, z64,
                            runs=np.zeros((0,), np.int64), key_is_row=True)

    @staticmethod
    def concat(parts, device) -> "SignedStream":
        parts = [p for p in parts if p.n]
        if not parts:
            return SignedStream.empty(device)
        if len(parts) == 1:
            return parts[0]
        alias = all(p.key_lo is p.row_lo and p.key_hi is p.row_hi
                    for p in parts)
        fields = []
        for f in _FIELDS:
            if alias and f in ("key_lo", "key_hi"):
                fields.append(None)  # patched below from the row tensors
            else:
                fields.append(torch.cat([getattr(p, f) for p in parts]))
        if alias:
            fields[1], fields[2] = fields[3], fields[4]
        runs = None
        if all(p.runs is not None for p in parts):
            offs, off = [], 0
            for p in parts:
                offs.append((p.runs if p.runs.shape[0] else _RUN0) + off)
                off += p.n
            runs = np.concatenate(offs)
        # lint: runs-ok each part's own runs, shifted by its offset
        return SignedStream(*fields, runs=runs,
                            key_is_row=all(p.key_is_row for p in parts))

    def take(self, idx) -> "SignedStream":
        rl, rh = self.row_lo[idx], self.row_hi[idx]
        kl = rl if self.key_lo is self.row_lo else self.key_lo[idx]
        kh = rh if self.key_hi is self.row_hi else self.key_hi[idx]
        return SignedStream(self.sign[idx], kl, kh, rl, rh,
                            self.rowid[idx], key_is_row=self.key_is_row)

    def filter_mask(self, mask: torch.Tensor) -> "SignedStream":
        """Subset by boolean mask. Order-preserving, so a fully key-sorted
        stream stays key-sorted (finer run metadata is dropped)."""
        out = self.take(torch.nonzero(mask).flatten())
        if self.sorted_by_key:
            out.runs = _RUN0 if out.n else np.zeros((0,), np.int64)
        return out

    def inverse(self) -> "SignedStream":
        """The algebraic inverse Δ(b→a) of this stream Δ(a→b): same rows,
        flipped signs. Signs do not take part in the sortedness
        invariant, so runs and key aliasing carry over and every field
        but ``sign`` is SHARED with this stream — which may be a
        ``DeltaCache`` entry. torch has no read-only flag, so nothing may
        write into the inverse's tensors in place; ``-sign`` is a fresh
        tensor."""
        # lint: runs-ok the same rows in the same order as this stream
        return SignedStream(-self.sign, self.key_lo, self.key_hi,
                            self.row_lo, self.row_hi, self.rowid,
                            runs=self.runs, key_is_row=self.key_is_row)

    def merge_by_key(self, cuts=None) -> "SignedStream":
        """Materialize the globally key-sorted stream: a stable k-way
        merge of the presorted runs (ties keep emission order), falling
        back to a stable 128-bit sort when no run structure is known.
        Identity when already sorted. ``cuts`` partitions the merge by
        key range — byte-identical output."""
        if self.n == 0 or self.sorted_by_key:
            return self
        if self.runs is not None:
            order = ops.merge128_runs(self.key_lo, self.key_hi, self.runs,
                                      cuts=cuts)
        else:
            order = ops._sort128(self.key_lo, self.key_hi)
        out = self.take(order)
        out.runs = _RUN0
        return out


def _emit(obj: DataObject, idx: Optional[torch.Tensor],
          sign: int) -> SignedStream:
    """One presorted run from one object. ``idx`` must be ascending row
    offsets; ``idx=None`` emits every row zero-copy (the stream fields
    ARE the object's immutable lanes)."""
    key_is_row = obj.key_lo is obj.row_lo
    dev = obj.row_lo.device
    if idx is None:
        # lint: runs-ok a sealed object is key-sorted: one run
        return SignedStream(
            torch.full((obj.nrows,), sign, dtype=torch.int32, device=dev),
            obj.key_lo, obj.key_hi, obj.row_lo, obj.row_hi, obj.rowids(),
            runs=_RUN0, key_is_row=key_is_row)
    rl, rh = obj.row_lo[idx], obj.row_hi[idx]
    kl = rl if key_is_row else obj.key_lo[idx]
    kh = rh if key_is_row else obj.key_hi[idx]
    # lint: runs-ok ascending offsets of a key-sorted object: one run
    return SignedStream(
        torch.full((idx.shape[0],), sign, dtype=torch.int32, device=dev),
        kl, kh, rl, rh, pack_rowid(obj.oid, idx),
        runs=_RUN0, key_is_row=key_is_row)


class DeltaStats:
    """Instrumentation: how much the Δ-scan actually read (vs. table size)."""

    def __init__(self):
        self.objects_scanned = 0
        self.objects_skipped_shared = 0
        self.rows_scanned = 0
        self.bytes_scanned = 0
        # fresh tombstone-target-array constructions this op triggered
        self.visibility_builds = 0
        # signed Δ streams served from the memo instead of re-scanned
        self.delta_cache_hits = 0


class DeltaCache(KeyedLRU):
    """Memo of signed Δ streams keyed by the two directory values.

    Directories and objects are immutable, so ``signed_delta(a, b)`` is a
    pure function of ``(a, b)``. LRU-bounded; entries referencing a
    deleted object are dropped via ``on_delete``. Cached streams are
    shared: no consumer writes into them."""

    # streams larger than this are cheap to rebuild relative to the
    # memory they would pin
    MAX_CACHED_ROWS = 1_000_000

    def __init__(self, capacity: int = 8):
        super().__init__(capacity)
        self.hits = 0

    @staticmethod
    def _key(a: Directory, b: Directory):
        return (a.data_oids, a.tomb_oids, a.ts,
                b.data_oids, b.tomb_oids, b.ts)

    def get(self, a: Directory, b: Directory):
        s = self.lookup(self._key(a, b))
        if s is not None:
            self.hits += 1
        return s

    def put(self, a: Directory, b: Directory, stream: "SignedStream"):
        if stream.n > self.MAX_CACHED_ROWS:
            return
        self.insert(self._key(a, b), stream)

    def on_delete(self, oid: int) -> None:
        self.drop_if(lambda k: oid in k[0] or oid in k[1]
                     or oid in k[3] or oid in k[4])


def signed_delta(store: ObjectStore, a: Directory, b: Directory,
                 stats: DeltaStats | None = None) -> SignedStream:
    stats = stats if stats is not None else DeltaStats()
    with telemetry.span(SP_SIGNED_DELTA):
        o0 = stats.objects_scanned
        s0 = stats.objects_skipped_shared
        r0 = stats.rows_scanned
        n0 = stats.bytes_scanned
        try:
            return _signed_delta(store, a, b, stats)
        finally:
            # fold this call's scan work into the store-level cumulatives
            m = store.metrics
            m.add("delta.objects_scanned", stats.objects_scanned - o0)
            m.add("delta.objects_skipped_shared",
                  stats.objects_skipped_shared - s0)
            m.add("delta.rows_scanned", stats.rows_scanned - r0)
            m.add("delta.bytes_scanned", stats.bytes_scanned - n0)


def _signed_delta(store: ObjectStore, a: Directory, b: Directory,
                  stats: DeltaStats) -> SignedStream:
    cache = store.delta_cache
    if cache is None:
        cache = store.delta_cache = DeltaCache()
    cached = cache.get(a, b)
    if cached is not None:
        stats.delta_cache_hits += 1
        return cached
    set_a, set_b = set(a.data_oids), set(b.data_oids)
    only_a = sorted(set_a - set_b)
    only_b = sorted(set_b - set_a)
    shared = sorted(set_a & set_b)
    b0 = store.vis_cache.builds if store.vis_cache is not None else 0
    vi_a = visibility_index(store, a)
    vi_b = visibility_index(store, b)
    stats.visibility_builds += store.vis_cache.builds - b0
    parts = []

    for only, vi, sign in ((only_b, vi_b, +1), (only_a, vi_a, -1)):
        for oid in only:
            obj = store.get(oid)
            stats.objects_scanned += 1
            stats.rows_scanned += obj.nrows
            stats.bytes_scanned += int(obj.nbytes)
            if obj.nrows == 0:
                continue
            if vi.fully_visible(obj):
                parts.append(_emit(obj, None, sign))  # zero-copy run
                continue
            idx = torch.nonzero(vi.visible_mask(obj)).flatten()
            if idx.shape[0]:
                parts.append(_emit(obj, idx, sign))

    # Shared objects: only rows whose visibility DIFFERS can contribute —
    # the tombstone targets of either side within the object plus
    # ts-horizon differences.
    ts_min = min(a.ts, b.ts)
    for oid in shared:
        obj = store.get(oid)
        kills_a = vi_a.has_kills(obj)
        kills_b = vi_b.has_kills(obj)
        any_tomb = kills_a or kills_b
        ts_touched = obj.nrows > 0 and obj.ts_zone[1] > ts_min
        if not any_tomb and not ts_touched:
            stats.objects_skipped_shared += 1
            continue
        base = obj.oid << 32
        cand_parts = []
        if any_tomb:
            for vi, kills in ((vi_a, kills_a), (vi_b, kills_b)):
                if kills:
                    cand_parts.append(vi.object_targets(oid) - base)
        if ts_touched:
            cand_parts.append(torch.nonzero(obj.commit_ts > ts_min)
                              .flatten())
        # each part is already sorted & duplicate-free
        cand = (cand_parts[0] if len(cand_parts) == 1
                # lint: sort-ok multi-part candidate dedup is off the
                # dominant single-part path; parts are tiny tombstone sets
                else torch.unique(torch.cat(cand_parts)))
        if cand.shape[0] == 0:
            stats.objects_skipped_shared += 1
            continue
        stats.objects_scanned += 1
        stats.rows_scanned += int(cand.shape[0])
        if not ts_touched and kills_a != kills_b:
            # one-sided tombstones within both horizons: every candidate
            # flips visibility the same way
            parts.append(_emit(obj, cand, -1 if kills_b else +1))
            continue
        va = vi_a.visible_rows(obj, cand)
        vb = vi_b.visible_rows(obj, cand)
        plus = cand[vb & ~va]
        minus = cand[va & ~vb]
        if plus.shape[0]:
            parts.append(_emit(obj, plus, +1))
        if minus.shape[0]:
            parts.append(_emit(obj, minus, -1))

    # k-way merge the presorted per-object runs; big multi-run streams
    # merge per key-range shard (derived plan, byte-identical order)
    stream = SignedStream.concat(parts, store.device)
    cuts = None
    if stream.n and not stream.sorted_by_key and stream.runs is not None:
        from ..distributed.sharding import maybe_key_cuts
        cuts = maybe_key_cuts(stream.key_lo, stream.key_hi, stream.runs)
        if cuts is not None:
            store.metrics.add("probe.shard_parts", cuts[0].shape[0] + 1)
    stream = stream.merge_by_key(cuts=cuts)
    cache.put(a, b, stream)
    return stream


def full_scan_stream(store: ObjectStore, d: Directory, sign: int,
                     stats: DeltaStats | None = None) -> SignedStream:
    """Scan ALL visible rows of a snapshot (the SQL-baseline path,
    Listing 2). Presorted runs, deliberately NOT merged here."""
    stats = stats if stats is not None else DeltaStats()
    b0 = store.vis_cache.builds if store.vis_cache is not None else 0
    vi = visibility_index(store, d)
    stats.visibility_builds += store.vis_cache.builds - b0
    parts = []
    for oid in d.data_oids:
        obj = store.get(oid)
        stats.objects_scanned += 1
        stats.rows_scanned += obj.nrows
        stats.bytes_scanned += int(obj.nbytes)
        if obj.nrows == 0:
            continue
        if vi.fully_visible(obj):
            parts.append(_emit(obj, None, sign))  # zero-copy run
            continue
        idx = torch.nonzero(vi.visible_mask(obj)).flatten()
        if idx.shape[0]:
            parts.append(_emit(obj, idx, sign))
    return SignedStream.concat(parts, store.device)
