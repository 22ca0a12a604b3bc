"""Immutable storage objects (paper §4), with their lanes on the device.

Data of a table lives in immutable columnar *objects* (row groups). Deletes
are *tombstone* objects holding (key signature, target physical rowid).
Each object's rows are sorted at seal time by key signature and carry a
zone map for probe pruning.

Physical rowid = (oid << 32) | row_offset, a uint64 word held as int64
bits like every other word lane. Oids stay below 2**31, so a rowid's
signed order is its unsigned order.

Every fixed-width lane of a sealed object is a tensor on the store's
device; LOB payloads stay host object arrays. The heap ``ObjectStore`` is
the only tier of this slice (the pack tier comes later).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from .schema import Schema, batch_nbytes, take_batch
from .telemetry import Metrics

OBJECT_CAPACITY = 1 << 18  # max rows per sealed object (256Ki)

_OFF_MASK = 0xFFFFFFFF


def _ts_minmax(commit_ts: torch.Tensor) -> Tuple[int, int]:
    """(min, max) commit_ts of an object's rows ((0, 0) when empty)."""
    if commit_ts.shape[0] == 0:
        return (0, 0)
    mm = torch.stack([commit_ts.min(), commit_ts.max()]).tolist()
    return (int(mm[0]), int(mm[1]))


def pack_rowid(oid: int, offsets: torch.Tensor) -> torch.Tensor:
    return (oid << 32) | offsets.to(torch.int64)


def rowid_oid(rowids: torch.Tensor) -> torch.Tensor:
    return (rowids >> 32) & _OFF_MASK


def rowid_off(rowids: torch.Tensor) -> torch.Tensor:
    return rowids & _OFF_MASK


@dataclass
class DataObject:
    """A sealed, immutable row group. Rows sorted by (key_lo, key_hi)."""
    oid: int
    nrows: int
    cols: Dict[str, object]              # tensors; LOB: host object array
    commit_ts: torch.Tensor              # (n,) int64
    row_lo: torch.Tensor                 # (n,) uint64 bits: row signature
    row_hi: torch.Tensor
    key_lo: torch.Tensor                 # (n,) key signature (sorted)
    key_hi: torch.Tensor
    lob_sigs: Dict[str, torch.Tensor] = field(default_factory=dict)
    nbytes: int = 0                      # logical payload bytes
    _ts_zone: Optional[Tuple[int, int]] = field(
        default=None, repr=False, compare=False)
    _rowids: Optional[torch.Tensor] = field(
        default=None, repr=False, compare=False)

    @property
    def zone(self) -> torch.Tensor:
        """(2,) words: (min, max) of key_lo — zone map for probe pruning
        (the first and last key; objects are key-sorted)."""
        if self.nrows == 0:
            return torch.zeros((2,), dtype=torch.int64,
                               device=self.key_lo.device)
        return self.key_lo[[0, -1]]

    @property
    def ts_zone(self) -> Tuple[int, int]:
        """(min, max) commit_ts — computed once; objects are immutable."""
        if self._ts_zone is None:
            self._ts_zone = _ts_minmax(self.commit_ts)
        return self._ts_zone

    def rowids(self) -> torch.Tensor:
        # computed once; the zero-copy Δ emission path reuses it per scan
        if self._rowids is None:
            self._rowids = pack_rowid(self.oid, torch.arange(
                self.nrows, dtype=torch.int64, device=self.row_lo.device))
        return self._rowids


@dataclass
class TombstoneObject:
    """Sealed batch of deletions: each row kills one physical row."""
    oid: int
    nrows: int
    target: torch.Tensor                 # (n,) rowid being deleted
    key_lo: torch.Tensor                 # key signature of the deleted row
    key_hi: torch.Tensor
    commit_ts: torch.Tensor              # (n,) int64
    # oids of the data objects this tombstone batch targets
    target_oids: Tuple[int, ...] = ()
    _ts_zone: Optional[Tuple[int, int]] = field(
        default=None, repr=False, compare=False)

    @property
    def nbytes(self) -> int:
        return 8 * (self.target.numel() + self.key_lo.numel()
                    + self.key_hi.numel() + self.commit_ts.numel())

    @property
    def ts_zone(self) -> Tuple[int, int]:
        if self._ts_zone is None:
            self._ts_zone = _ts_minmax(self.commit_ts)
        return self._ts_zone


def seal_data_object(oid: int, schema: Schema, batch: Dict[str, object],
                     commit_ts: torch.Tensor, row_lo, row_hi, key_lo, key_hi,
                     lob_sigs: Dict[str, torch.Tensor], *,
                     presorted: bool = False) -> DataObject:
    """Freeze a batch as an immutable key-sorted object.

    ``presorted=True``: the caller guarantees the rows already arrive in
    (key_lo, key_hi) order."""
    if not presorted:
        order = ops._sort128(key_lo, key_hi)
        batch = take_batch(batch, order)
        commit_ts = commit_ts[order]
        row_lo_s, row_hi_s = row_lo[order], row_hi[order]
        # NoPK tables: the key signature IS the row signature — keep the
        # tensor identity through the gather so Δ emission can tag streams
        # key==row
        key_lo = row_lo_s if key_lo is row_lo else key_lo[order]
        key_hi = row_hi_s if key_hi is row_hi else key_hi[order]
        row_lo, row_hi = row_lo_s, row_hi_s
        lob_sigs = {k: v[order] for k, v in lob_sigs.items()}
    return DataObject(
        oid=oid,
        nrows=int(row_lo.shape[0]),
        cols=batch,
        commit_ts=commit_ts,
        row_lo=row_lo, row_hi=row_hi,
        key_lo=key_lo, key_hi=key_hi,
        lob_sigs=lob_sigs,
        nbytes=batch_nbytes(schema, batch),
    )


def lane_nbytes(obj) -> int:
    """Device bytes held by a sealed object's tensor lanes (aliased NoPK
    key lanes counted once; LOB payloads are host-side and excluded)."""
    if isinstance(obj, TombstoneObject):
        return obj.nbytes
    seen, total = set(), 0
    lanes = [obj.commit_ts, obj.row_lo, obj.row_hi, obj.key_lo, obj.key_hi,
             *obj.lob_sigs.values(),
             *(c for c in obj.cols.values() if torch.is_tensor(c))]
    for t in lanes:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


class ObjectStore:
    """The immutable object store (stand-in for S3 in the paper).

    Objects are write-once; deletion happens through GC and through the
    rollback paths that make aborted or ephemeral work invisible
    (``Engine._commit`` unwinding a failed transaction, a CI preview),
    which also rewind ``_next_oid`` — so an oid CAN be reused after its
    object was deleted, and oid-keyed caches subscribe
    to ``delete`` notifications. ``device`` is where every sealed lane
    lives."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._objects: Dict[int, object] = {}
        self._next_oid = 1
        self.bytes_written = 0  # cumulative physical write volume
        # visibility-target / signed-delta caches, attached lazily by
        # core.visibility / core.delta (both modules import objects)
        self.vis_cache = None
        self.delta_cache = None
        # cumulative telemetry counters (delta.* / probe.* totals)
        self.metrics = Metrics()

    def new_oid(self) -> int:
        oid = self._next_oid
        self._next_oid += 1
        return oid

    def put(self, obj) -> int:
        if obj.oid in self._objects:
            raise ValueError("objects are immutable/write-once")
        self._objects[obj.oid] = obj
        self.bytes_written += int(obj.nbytes)
        return obj.oid

    def get(self, oid: int):
        return self._objects[oid]

    def has(self, oid: int) -> bool:
        return oid in self._objects

    def oids(self):
        return self._objects.keys()

    def delete(self, oid: int) -> None:
        obj = self._objects.pop(oid)
        if self.vis_cache is not None and isinstance(obj, TombstoneObject):
            self.vis_cache.on_delete(oid)
        if self.delta_cache is not None:
            self.delta_cache.on_delete(oid)
