"""MVCC visibility: which rows of which objects a directory can see.

A row r of data object o is visible in directory d iff

    commit_ts[r] <= d.ts   AND   no tombstone t in d with
                                 t.target == rowid(r) and t.commit_ts <= d.ts

Tombstone membership tests are range queries on the per-directory sorted
target array, served by the ``searchsorted`` kernel via
``ops.lower_bound``. The sorted target array depends only on
``(d.tomb_oids, d.ts)`` and the immutable tombstone objects, so it is
built once per *directory version* and cached in the store's
``VisibilityCache``; commits extend the parent version's array
incrementally. The array is a tensor on the store's device; its
partition per data object is small host metadata.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops
from . import telemetry
from .directory import Directory
from .objects import DataObject, ObjectStore, rowid_oid

SP_VIS_BUILD = telemetry.register_span(
    "visibility.build", "build a directory's sorted tombstone-target "
    "array from scratch (the cache-miss path)")


def _empty(device) -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.int64, device=device)


class _Entry:
    """One cached directory version: the sorted target array, its lazy
    per-object partition, and whether the ts-horizon filter dropped rows
    while building. ``ts_arr`` (lazy) aligns each target's tombstone
    commit_ts with the sorted array so historical PITR horizons derive by
    masking."""

    __slots__ = ("targets", "slices", "complete", "ts_arr")

    def __init__(self, targets: torch.Tensor, complete: bool):
        self.targets = targets
        self.slices: Optional[Dict[int, Tuple[int, int]]] = None
        self.complete = complete
        self.ts_arr: Optional[torch.Tensor] = None

    def object_slices(self) -> Dict[int, Tuple[int, int]]:
        if self.slices is None:
            t = self.targets
            if t.shape[0] == 0:
                self.slices = {}
            else:
                # rowids are sorted, so each object's targets are one
                # contiguous slice: only the boundaries come to the host
                oids = rowid_oid(t)
                bnd = torch.nonzero(oids[1:] != oids[:-1]).flatten() + 1
                starts = torch.cat([torch.zeros(1, dtype=torch.int64,
                                                device=t.device), bnd])
                s_host = starts.tolist()
                o_host = oids[starts].tolist()
                ends = s_host[1:] + [t.shape[0]]
                self.slices = {int(o): (int(s), int(e))
                               for o, s, e in zip(o_host, s_host, ends)}
        return self.slices


def _build_entry(store: ObjectStore, d: Directory) -> _Entry:
    targets, complete = [], True
    for oid in d.tomb_oids:
        t = store.get(oid)
        if t.ts_zone[1] <= d.ts:
            targets.append(t.target)
        else:
            complete = False
            targets.append(t.target[t.commit_ts <= d.ts])
    # rowids are below 2**63, so a signed sort is their unsigned order
    arr = (torch.sort(torch.cat(targets)).values if targets
           else _empty(store.device))
    return _Entry(arr, complete)


class KeyedLRU:
    """Tiny keyed LRU shared by the visibility and delta caches."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._cache: OrderedDict = OrderedDict()

    def lookup(self, key):
        v = self._cache.get(key)
        if v is not None:
            self._cache.move_to_end(key)
        return v

    def insert(self, key, value) -> None:
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)

    def drop_if(self, pred) -> None:
        for k in [k for k in self._cache if pred(k)]:
            del self._cache[k]

    def clear(self) -> None:
        self._cache.clear()


class _Pending:
    """A not-yet-materialized extension: base entry + new sorted batches.
    The merge copy is paid by the first *read* of the version."""

    __slots__ = ("base", "batches", "complete")

    def __init__(self, base: _Entry, batches, complete: bool):
        self.base = base
        self.batches = batches
        self.complete = complete


class VisibilityCache(KeyedLRU):
    """LRU cache of tombstone-target arrays keyed by (tomb_oids, ts).

    Keys are value-based over immutable inputs, so a directory change
    yields a different key and can never observe a stale array.
    ``on_delete`` drops entries referencing a deleted tombstone (rollback
    paths rewind the oid counter, so an oid can be reused)."""

    def __init__(self, store: ObjectStore, capacity: int = 32):
        super().__init__(capacity)
        self.store = store
        self.builds = 0    # full target-array constructions
        self.extends = 0   # incremental parent -> child extensions
        self.derives = 0   # PITR horizons derived by commit_ts truncation
        self.hits = 0

    @staticmethod
    def _key(d: Directory) -> Tuple:
        return (d.tomb_oids, d.ts)

    def _hmax(self, d: Directory) -> int:
        """Largest tombstone commit_ts in ``d`` (0 with no tombstones)."""
        return max((self.store.get(o).ts_zone[1] for o in d.tomb_oids),
                   default=0)

    def _lookup_entry(self, key: Tuple) -> Optional[_Entry]:
        val = self.lookup(key)
        if isinstance(val, _Pending):
            val = self._materialize(key, val)
        return val

    def entry(self, d: Directory) -> _Entry:
        key = self._key(d)
        val = self._lookup_entry(key)
        if val is not None:
            self.hits += 1
            return val
        hmax = self._hmax(d)
        # full-coverage horizon: the array is independent of ts, so every
        # such horizon shares one canonical entry
        ckey = (d.tomb_oids, hmax) if d.ts >= hmax else key
        hit = None
        if ckey != key:
            hit = self._lookup_entry(ckey)
        if hit is not None:
            self.hits += 1
            val = hit
        else:
            val = self._derive(d, hmax, ckey)
            if val is None:
                with telemetry.span(SP_VIS_BUILD):
                    val = _build_entry(self.store, d)
                    self.builds += 1
                self.insert(ckey, val)
        if ckey != key:
            self.insert(key, val)
        return val

    def _derive(self, d: Directory, hmax: int, ckey: Tuple
                ) -> Optional[_Entry]:
        """Serve a historical horizon by truncating a cached complete HEAD
        array on commit_ts instead of rebuilding from tombstone objects
        (masking a sorted array keeps it sorted: byte-identical)."""
        if not d.tomb_oids:
            return None
        dset = set(d.tomb_oids)
        for key2 in reversed(list(self._cache.keys())):  # newest first
            toids = key2[0]
            if len(toids) < len(dset) or key2 == ckey:
                continue
            extras = set(toids) - dset
            if len(extras) != len(toids) - len(dset):
                continue                    # not a superset
            if any(self.store.get(o).ts_zone[0] <= d.ts for o in extras):
                continue                    # an extra straddles the horizon
            head = self._lookup_entry(key2)
            if head is None or not head.complete:
                continue
            self._ensure_ts(head, toids)
            val = _Entry(head.targets[head.ts_arr <= d.ts],
                         complete=d.ts >= hmax)
            self.derives += 1
            self.insert(ckey, val)
            return val
        return None

    def _ensure_ts(self, entry: _Entry, tomb_oids) -> None:
        """Align each target's tombstone commit_ts with the sorted array
        (complete entries only: every target present exactly once)."""
        if entry.ts_arr is not None:
            return
        ts = torch.empty_like(entry.targets)
        for oid in tomb_oids:
            t = self.store.get(oid)
            ts[ops.lower_bound(entry.targets, t.target)] = t.commit_ts
        entry.ts_arr = ts

    def _materialize(self, key: Tuple, p: _Pending) -> _Entry:
        """Pay the deferred merge: one sort of the accumulated batches and
        one sorted insert into the base array."""
        if len(p.batches) == 1:
            add = p.batches[0]
        else:
            add = torch.sort(torch.cat(p.batches)).values
        merged = p.base.targets
        if add.shape[0] and merged.shape[0] == 0:
            merged = add.clone()
        elif add.shape[0]:
            pos = ops.lower_bound(merged, add)
            out = torch.empty((merged.shape[0] + add.shape[0],),
                              dtype=merged.dtype, device=merged.device)
            at = pos + torch.arange(add.shape[0], device=add.device)
            mask = torch.zeros(out.shape, dtype=torch.bool,
                               device=out.device)
            mask[at] = True
            out[at] = add
            out[~mask] = merged
            merged = out
        entry = _Entry(merged, p.complete)
        self.insert(key, entry)
        return entry

    def get(self, d: Directory) -> "VisibilityIndex":
        return VisibilityIndex(self.store, d, _entry=self.entry(d))

    def extend(self, parent: Directory, child: Directory) -> None:
        """Derive the child version's array from the parent's by recording
        the newly added (already sorted at seal time) tombstone batches.
        No-op unless the parent is cached, the child only *adds*
        tombstones, and the parent array was horizon-complete."""
        pval = self._cache.get(self._key(parent))
        ph = None
        if pval is None:
            ph = self._hmax(parent)
            if parent.ts >= ph:
                pval = self._cache.get((parent.tomb_oids, ph))
        if pval is None or not pval.complete:
            return
        p_set = set(parent.tomb_oids)
        c_set = set(child.tomb_oids)
        if not (p_set <= c_set) or child.ts < parent.ts:
            return
        complete = True
        hmax_child = ph if ph is not None else self._hmax(parent)
        batches = []
        for oid in child.tomb_oids:
            if oid in p_set:
                continue
            t = self.store.get(oid)
            hmax_child = max(hmax_child, t.ts_zone[1])
            if t.ts_zone[1] <= child.ts:
                batches.append(t.target)
            else:
                complete = False
                batches.append(t.target[t.commit_ts <= child.ts])
        ckey = ((child.tomb_oids, hmax_child) if complete
                else self._key(child))
        if self._cache.get(ckey) is not None:
            return
        if isinstance(pval, _Pending):   # chain of unread commits: flatten
            base, batches = pval.base, pval.batches + batches
        else:
            base = pval
        if not batches:
            self.insert(ckey, _Entry(base.targets, complete))
        else:
            self.insert(ckey, _Pending(base, batches, complete))
        self.extends += 1

    def on_delete(self, oid: int) -> None:
        """A tombstone object was deleted: drop entries referencing it."""
        self.drop_if(lambda k: oid in k[0])


def visibility_index(store: ObjectStore, d: Directory) -> "VisibilityIndex":
    """The cached entry point every hot path goes through."""
    cache = store.vis_cache
    if cache is None:
        cache = VisibilityCache(store)
        store.vis_cache = cache
    return cache.get(d)


class VisibilityIndex:
    """View over one directory version's sorted tombstone-target array."""

    def __init__(self, store: ObjectStore, d: Directory,
                 _entry: Optional[_Entry] = None):
        self.store = store
        self.d = d
        if _entry is None:
            _entry = _build_entry(store, d)
        self._entry = _entry

    @property
    def targets(self) -> torch.Tensor:
        return self._entry.targets

    def object_targets(self, oid: int) -> torch.Tensor:
        """The slice of targets that can touch data object ``oid``."""
        sl = self._entry.object_slices().get(oid)
        if sl is None:
            return _empty(self.store.device)
        return self._entry.targets[sl[0]:sl[1]]

    def has_kills(self, obj: DataObject) -> bool:
        return obj.oid in self._entry.object_slices()

    def fully_visible(self, obj: DataObject) -> bool:
        """Zone pruning: every row passes without masking — no tombstone
        targets the object and its commit-ts zone is within the horizon."""
        return (obj.oid not in self._entry.object_slices()
                and obj.ts_zone[1] <= self.d.ts)

    def killed_mask(self, obj: DataObject) -> torch.Tensor:
        """(nrows,) bool — True where a tombstone kills the row."""
        mask = torch.zeros((obj.nrows,), dtype=torch.bool,
                           device=self.store.device)
        if obj.nrows == 0:
            return mask
        t = self.object_targets(obj.oid)
        if t.shape[0]:
            mask[t - (obj.oid << 32)] = True
        return mask

    def killed_rowids(self, rowids: torch.Tensor) -> torch.Tensor:
        """(k,) bool for arbitrary rowids."""
        targets = self._entry.targets
        if targets.shape[0] == 0 or rowids.shape[0] == 0:
            return torch.zeros(rowids.shape, dtype=torch.bool,
                               device=rowids.device)
        idx = ops.lower_bound(targets, rowids)
        idx_c = idx.clamp(max=targets.shape[0] - 1)
        return (targets[idx_c] == rowids) & (idx < targets.shape[0])

    def killed_offsets(self, obj: DataObject,
                       offs: torch.Tensor) -> torch.Tensor:
        """(k,) bool for row offsets within one object — searches only the
        object's slice of the target array."""
        t = self.object_targets(obj.oid)
        if t.shape[0] == 0 or offs.shape[0] == 0:
            return torch.zeros(offs.shape, dtype=torch.bool,
                               device=offs.device)
        toffs = t - (obj.oid << 32)
        pos = ops.lower_bound(toffs, offs)
        pos_c = pos.clamp(max=toffs.shape[0] - 1)
        return (toffs[pos_c] == offs) & (pos < toffs.shape[0])

    def visible_rows(self, obj: DataObject,
                     offs: torch.Tensor) -> torch.Tensor:
        """Visibility of selected row offsets without materializing the
        object-wide mask (Δ-scan hot path: cost ∝ candidates, not rows)."""
        ok = ~self.killed_offsets(obj, offs)
        lo, hi = obj.ts_zone
        if hi <= self.d.ts:
            return ok
        if lo > self.d.ts:
            return torch.zeros(offs.shape, dtype=torch.bool,
                               device=offs.device)
        return ok & (obj.commit_ts[offs] <= self.d.ts)

    def visible_mask(self, obj: DataObject) -> torch.Tensor:
        if self.fully_visible(obj):
            return torch.ones((obj.nrows,), dtype=torch.bool,
                              device=self.store.device)
        if obj.ts_zone[1] <= self.d.ts:
            return ~self.killed_mask(obj)
        return (obj.commit_ts <= self.d.ts) & ~self.killed_mask(obj)



    def visible_count(self, obj: DataObject) -> int:
        """Visible-row count without materializing a mask when pruned."""
        if self.fully_visible(obj):
            return obj.nrows
        return int(self.visible_mask(obj).sum())

