"""Immutable storage objects (paper §4), with their lanes on the device.

Data of a table lives in immutable columnar *objects* (row groups). Deletes
are *tombstone* objects holding (key signature, target physical rowid).
Each object's rows are sorted at seal time by key signature and carry a
zone map for probe pruning.

Physical rowid = (oid << 32) | row_offset, a uint64 word held as int64
bits like every other word lane. Oids stay below 2**31, so a rowid's
signed order is its unsigned order.

Every fixed-width lane of a sealed object is a tensor on the store's
device; LOB payloads stay host object arrays. The heap of ``ObjectStore``
is device memory: with a pack directory attached (``attach_packs``),
objects spill to content-addressed pack files, evict from the device, and
fault back in (an upload) on ``get``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from .faults import crash_point, register
from .schema import Schema, batch_nbytes, take_batch
from .telemetry import Metrics

CP_TORCH_STORE_SPILL = register(
    "torch.store.spill",
    "mid spill: the pack file for an object may exist on disk but the "
    "heap entry has not moved to the packed map — the heap copy is still "
    "authoritative, so recovery sees identical content (an orphan pack "
    "file is invisible content-addressed garbage)")

OBJECT_CAPACITY = 1 << 18  # max rows per sealed object (256Ki)

#: the sealed-lane write sanitizer: when armed, every tensor lane of a
#: sealed object is replaced at seal, at store time and at fault-in by an
#: inference-mode copy, which refuses any in-place op (on its views too)
#: with ``RuntimeError`` AT the write — where the reference's frozen numpy
#: lanes raise ``ValueError``. LOB object arrays are marked read-only as
#: in the reference, and ``interop`` hands sanitized lanes out as
#: read-only numpy. Off by default; REPRO_SANITIZE=1 arms it.
SANITIZE = os.environ.get("REPRO_SANITIZE", "0") not in ("", "0")


def set_sanitize(on: bool) -> bool:
    """Arm/disarm the write sanitizer; returns the previous state (tests
    restore it). Only objects sealed while armed are frozen."""
    global SANITIZE
    prev = SANITIZE
    SANITIZE = bool(on)
    return prev


def _frozen(t):
    if not torch.is_tensor(t):                  # LOB: a host object array
        t.setflags(write=False)
        return t
    if t.is_inference():
        return t
    # lint: seal-ok the freeze itself: the lane is cloned into a fresh
    # inference tensor, and nothing is written in place under the mode
    with torch.inference_mode():
        return t.clone()


def _freeze_lanes(obj) -> None:
    """Swap every lane of a sealed object for a write-refusing copy
    (idempotent; a NoPK object's key lanes stay its row lanes)."""
    if isinstance(obj, DataObject):
        alias = obj.key_lo is obj.row_lo
        obj.commit_ts = _frozen(obj.commit_ts)
        obj.row_lo, obj.row_hi = _frozen(obj.row_lo), _frozen(obj.row_hi)
        if alias:
            obj.key_lo, obj.key_hi = obj.row_lo, obj.row_hi
        else:
            obj.key_lo = _frozen(obj.key_lo)
            obj.key_hi = _frozen(obj.key_hi)
        # lint: seal-ok the sanitizer swaps in frozen copies of the lanes
        obj.cols = {k: _frozen(v) for k, v in obj.cols.items()}
        obj.lob_sigs = {k: _frozen(v) for k, v in obj.lob_sigs.items()}
    else:
        obj.commit_ts = _frozen(obj.commit_ts)
        obj.target = _frozen(obj.target)
        obj.key_lo, obj.key_hi = _frozen(obj.key_lo), _frozen(obj.key_hi)

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
    obj = DataObject(
        oid=oid,
        nrows=int(row_lo.shape[0]),
        cols=batch,
        commit_ts=commit_ts,
        row_lo=row_lo, row_hi=row_hi,
        key_lo=key_lo, key_hi=key_hi,
        lob_sigs=lob_sigs,
        nbytes=batch_nbytes(schema, batch),
    )
    if SANITIZE:
        _freeze_lanes(obj)
    return obj


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
    object was deleted, and oid-keyed caches subscribe to ``delete``
    notifications. That same reuse is why the pack tier keys by content
    digest, never oid. ``device`` is where every sealed lane lives: the
    heap tier is device memory, and with a ``store.packs.PackDir``
    attached (``attach_packs``) objects spill to pack files, evict from
    the device and fault back in lazily on ``get``."""

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
        # the pack tier (tier 2), attached via attach_packs(); when None
        # every path below reduces to the plain heap-dict store
        self.packs = None
        # oid -> (digest, is_tomb, nbytes) for every oid with a pack copy;
        # an oid in BOTH maps is spilled-but-resident, in _packed only it
        # is evicted and faults in on get()
        self._packed: Dict[int, Tuple[str, bool, int]] = {}
        # digest -> live-oid refcount: pack files are deleted only when no
        # live oid references their content (oids can share bytes)
        self._digest_refs: Dict[str, int] = {}
        self._atime: Dict[int, int] = {}   # oid -> LRU tick (heap tier)
        self._tick = 0

    def new_oid(self) -> int:
        oid = self._next_oid
        self._next_oid += 1
        return oid

    def put(self, obj) -> int:
        if obj.oid in self._objects or obj.oid in self._packed:
            raise ValueError("objects are immutable/write-once")
        if SANITIZE:
            _freeze_lanes(obj)
        self._objects[obj.oid] = obj
        self.bytes_written += int(obj.nbytes)
        return obj.oid

    def get(self, oid: int):
        obj = self._objects.get(oid)
        if obj is not None:
            if self.packs is not None:
                self.metrics.add("store.hits")
                self._tick += 1
                self._atime[oid] = self._tick
            return obj
        ent = self._packed.get(oid)
        if ent is None:
            raise KeyError(oid)
        return self._fault_in(oid, ent)

    def has(self, oid: int) -> bool:
        return oid in self._objects or oid in self._packed

    def oids(self):
        if not self._packed:
            return self._objects.keys()
        return self._objects.keys() | self._packed.keys()

    def delete(self, oid: int) -> None:
        obj = self._objects.pop(oid, None)
        ent = self._packed.pop(oid, None)
        if obj is None and ent is None:
            raise KeyError(oid)
        self._atime.pop(oid, None)
        is_tomb = (isinstance(obj, TombstoneObject) if obj is not None
                   else ent[1])
        self._unpin(oid, is_tomb)
        if ent is not None:
            digest = ent[0]
            n = self._digest_refs.get(digest, 1) - 1
            if n <= 0:
                self._digest_refs.pop(digest, None)
                self.packs.release(digest)
            else:
                self._digest_refs[digest] = n

    def _unpin(self, oid: int, is_tomb: bool) -> None:
        """Drop cache entries built from ``oid``: on delete they name a
        dead object; on evict they would hold its lanes on the device."""
        if self.vis_cache is not None and is_tomb:
            self.vis_cache.on_delete(oid)
        if self.delta_cache is not None:
            self.delta_cache.on_delete(oid)

    def live_bytes(self) -> int:
        heap = sum(int(o.nbytes) for o in self._objects.values())
        packed_only = sum(ent[2] for oid, ent in self._packed.items()
                          if oid not in self._objects)
        return heap + packed_only

    # -- pack tier ----------------------------------------------------------

    def attach_packs(self, backend) -> None:
        """Attach a pack directory (``store.packs.PackDir``) as tier 2.
        In-place: ``Table._store`` and the caches keep their references to
        this store."""
        self.packs = backend
        backend.metrics = self.metrics

    def digest_of(self, oid: int) -> Optional[str]:
        ent = self._packed.get(oid)
        return ent[0] if ent is not None else None

    def spill(self, oid: int) -> str:
        """Write oid's content to the pack tier (keeps the heap copy);
        returns the content digest. Idempotent per oid."""
        ent = self._packed.get(oid)
        if ent is not None:
            return ent[0]
        obj = self._objects[oid]
        digest, blob = self.packs.encode(obj)
        crash_point(CP_TORCH_STORE_SPILL)
        fresh = self.packs.store(digest, blob)
        self._packed[oid] = (digest, isinstance(obj, TombstoneObject),
                             int(obj.nbytes))
        self._digest_refs[digest] = self._digest_refs.get(digest, 0) + 1
        self.metrics.add("store.spills")
        if fresh:
            self.metrics.add("store.bytes_packed", len(blob))
        return digest

    def evict(self, oid: int) -> str:
        """Spill oid then drop its heap copy, freeing its device lanes.
        The object stays live: fault-in rebuilds identical content at the
        same oid. Cache entries holding its lanes are dropped with it (they
        rebuild from the faulted-in object), so nothing pins them on the
        device."""
        digest = self.spill(oid)
        obj = self._objects.pop(oid, None)
        self._atime.pop(oid, None)
        if obj is not None:
            self._unpin(oid, isinstance(obj, TombstoneObject))
        self.metrics.add("store.evictions")
        return digest

    def _fault_in(self, oid: int, ent):
        obj = self.packs.load(ent[0], oid, self.device)
        if SANITIZE:
            _freeze_lanes(obj)
        self._objects[oid] = obj
        self._tick += 1
        self._atime[oid] = self._tick
        self.metrics.add("store.faults")
        return obj

    def spill_all(self) -> int:
        n = 0
        for oid in list(self._objects):
            if oid not in self._packed:
                self.spill(oid)
                n += 1
        return n

    def evict_all(self) -> int:
        n = 0
        for oid in list(self._objects):
            self.evict(oid)
            n += 1
        return n

    def shrink_heap(self, target_bytes: int) -> int:
        """Evict least-recently-used resident objects until the heap tier
        holds at most ``target_bytes``; returns the eviction count."""
        resident = sum(int(o.nbytes) for o in self._objects.values())
        if resident <= target_bytes:
            return 0
        order = sorted(self._objects, key=lambda o: self._atime.get(o, 0))
        n = 0
        for oid in order:
            if resident <= target_bytes:
                break
            resident -= int(self._objects[oid].nbytes)
            self.evict(oid)
            n += 1
        return n
