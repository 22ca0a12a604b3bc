"""The version-control engine: tables, transactions, commit and seal,
snapshots and clone (paper §§3–5), with every sealed lane on the device.

Single-node stand-in for MatrixOne's CN/TN/LogService split: commits are
serialized through ``_commit`` (the TN role), every logical change is
WAL'd (the LogService role), and all bulk row work runs on tensors on the
engine's device through the kernel ops (the CN role).

This port covers tables, Txn, commit and seal, snapshots, clone (with
indices, or materialized), restore, drop, ALTER TABLE ADD COLUMN, GC,
WAL replay, and the workflow porcelain's engine-level shims (branches,
pull requests, Δ-revert; the verbs live in ``workspace``). Not ported
yet: the replay of a refs snapshot from the remote tier (replay on top
of an engine restored by other means) and everything of ``core/fsck.py``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from .directory import Directory, Snapshot
from .objects import (OBJECT_CAPACITY, DataObject, ObjectStore,
                      TombstoneObject, rowid_off, rowid_oid,
                      seal_data_object)
from .refs import AtRef, BareRef, parse_ref, require, validate_name
from .refs import RefSyntaxError, resolve as resolve_ref
from .schema import Schema, concat_batches, is_lob
from .sigs import (SigBatch, concat_sigs, key_sigs_for_lookup, resolve_sigs,
                   validate_runs)
from . import telemetry
from .faults import crash_point, register
from .table import Table
from .visibility import visibility_index
from .wal import WAL, TornTransaction

SP_COMMIT = telemetry.register_span(
    "commit", "one atomic (possibly multi-table) transaction commit")
SP_COMMIT_SEAL = telemetry.register_span(
    "commit.seal", "commit phase 1: validate every table and seal its "
    "objects (no directory touched)")
SP_COMMIT_SWING = telemetry.register_span(
    "commit.swing", "commit phase 2: swing every directory (the WAL "
    "group is already logged)")
SP_GC = telemetry.register_span(
    "gc", "mark-sweep garbage collection over the object store")
SP_REPLAY = telemetry.register_span(
    "replay", "rebuild an engine from a WAL (recovery)")

CP_TORCH_COMMIT_PRE_SEAL = register(
    "torch.engine.commit.pre_seal",
    "top of _commit, before the timestamp or any object is allocated — "
    "the transaction must be fully absent")
CP_TORCH_COMMIT_POST_SEAL = register(
    "torch.engine.commit.post_seal",
    "after phase 1 sealed every table's objects but before any WAL record "
    "or directory swing — nothing logged")
CP_TORCH_COMMIT_MID_SWING = register(
    "torch.engine.commit.mid_swing",
    "between directory swings of a multi-table commit — the WAL already "
    "holds the FULL group (log-before-swing)")
CP_TORCH_GC_MID_SWEEP = register(
    "torch.engine.gc.mid_sweep",
    "between object deletions of a GC sweep — GC is not WAL-logged, so "
    "the logical state is unchanged, with more garbage left")


class TxnConflict(Exception):
    """Write-write conflict: a target row vanished before commit."""


class PKViolation(Exception):
    pass


SnapshotRef = Union[str, Snapshot]


def as_rowids(rowids, device) -> torch.Tensor:
    """Rowids from a caller (tensor, or numpy uint64/int64) as int64 words
    on ``device``."""
    if torch.is_tensor(rowids):
        return rowids.to(device=device, dtype=torch.int64)
    a = np.ascontiguousarray(rowids)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.astype(np.int64, copy=False)).to(device)


class Txn:
    """Optimistic transaction: workspace of inserts + resolved delete
    rowids."""

    def __init__(self, engine: "Engine"):
        self.engine = engine
        self.read_ts = engine.ts
        self._ins: Dict[str, List[Dict[str, object]]] = {}
        # signature sidecars, aligned 1:1 with _ins (None = hash at seal)
        self._sigs: Dict[str, List[Optional[SigBatch]]] = {}
        self._del: Dict[str, List[torch.Tensor]] = {}
        self.committed: Optional[int] = None

    def insert(self, table: str, batch,
               sigs: Optional[SigBatch] = None) -> None:
        """Stage a batch; ``sigs`` is the zero-rehash carry contract.

        Passing ``sigs`` asserts the batch came verbatim off sealed
        objects (``gather_payload(with_sigs=True)`` / ``scan_carry``): it
        is already normalized (bytes LOBs, device tensors of the exact
        dtypes) and the caller relinquishes it. Producer-authored data
        must use ``sigs=None`` (normalized + hashed at seal)."""
        t = self.engine.table(table)
        if sigs is None:
            batch = t.schema.normalize_batch(batch, self.engine.device)
        self._ins.setdefault(table, []).append(batch)
        self._sigs.setdefault(table, []).append(sigs)

    def delete_rowids(self, table: str, rowids) -> None:
        self._del.setdefault(table, []).append(
            as_rowids(rowids, self.engine.device))

    def delete_by_keys(self, table: str, key_batch) -> int:
        """Resolve PK -> rowids against the current state; returns #resolved."""
        t = self.engine.table(table)
        keys = t.schema.primary_key
        sub = Schema(tuple(t.schema.column(k) for k in keys), keys)
        key_batch = sub.normalize_batch({k: key_batch[k] for k in keys},
                                        self.engine.device)
        klo, khi = key_sigs_for_lookup(t.schema, key_batch)
        rid = t.locate_keys(klo, khi)
        hit = rid != 0
        self.delete_rowids(table, rid[hit])
        return int(hit.sum())

    def update_by_keys(self, table: str, batch) -> int:
        """Upsert semantics used by the paper's UPDATE experiments: delete
        the existing row for each key (if any), insert the new version."""
        t = self.engine.table(table)
        batch = t.schema.normalize_batch(batch, self.engine.device)
        n = self.delete_by_keys(
            table, {k: batch[k] for k in t.schema.primary_key})
        self.insert(table, batch)
        return n

    @property
    def staged(self) -> bool:
        """True iff the workspace holds any insert or delete."""
        return (any(b for b in self._ins.values())
                or any(d.shape[0] for ds in self._del.values() for d in ds))

    def commit(self, *, _log: bool = True) -> int:
        # expand with secondary-index maintenance (same-commit atomic)
        if self.engine.indices:
            from .indices import maintain_on_commit
            for name in list(self._ins.keys() | self._del.keys()):
                if name in self.engine.indices:
                    # lint: sort-ok delete-target dedup at commit time —
                    # targets arrive from arbitrary staging order
                    dels = (torch.unique(torch.cat(self._del[name]))
                            if self._del.get(name)
                            else torch.zeros((0,), dtype=torch.int64,
                                             device=self.engine.device))
                    maintain_on_commit(self.engine, self, name,
                                       self._ins.get(name, []), dels)
        ts = self.engine._commit(self, _log=_log)
        self.committed = ts
        return ts


class Engine:
    def __init__(self, device=None, retention_versions: int = 1024):
        self.device = resolve_device(device)
        self.store = ObjectStore(self.device)
        self.wal = WAL()
        self.commit_stats = CommitStats()
        self.ts = 0
        self.tables: Dict[str, Table] = {}
        self.snapshots: Dict[str, Snapshot] = {}
        self.retention_versions = retention_versions
        # lineage: latest common base snapshot per unordered table pair
        self._base: Dict[Tuple[str, str], Snapshot] = {}
        # secondary indices (paper §5.5.4): base table -> [IndexSpec]
        self.indices: Dict[str, list] = {}
        # workflow porcelain: branch refs + pull requests
        self.branches: Dict[str, "Branch"] = {}
        self.prs: Dict[int, "PullRequest"] = {}
        self._next_pr_id = 1
        # commit log: one CommitRecord per table per applied operation,
        # tagged with the op kind
        self.commit_log: List[CommitRecord] = []
        self._op_kind = "commit"

    @contextlib.contextmanager
    def op_kind(self, kind: str):
        """Tag commits applied inside the block with an op kind (merge,
        clone, ...) for the commit log."""
        prev, self._op_kind = self._op_kind, kind
        try:
            yield
        finally:
            self._op_kind = prev

    def reset_metrics(self) -> None:
        """Zero every registered telemetry counter on this engine
        (``telemetry.metrics_snapshot`` reads all zeros afterwards).
        ``replay`` calls this last: traces are derived state, never
        durable state — a recovered engine must start clean."""
        self.commit_stats = CommitStats()
        store = self.store
        if store.vis_cache is not None:
            vc = store.vis_cache
            vc.builds = vc.extends = vc.derives = vc.hits = 0
        if store.delta_cache is not None:
            store.delta_cache.hits = 0
        store.metrics.reset()
        w = self.wal
        w.frames = w.bytes_written = w.fsyncs = 0

    # ------------------------------------------------------------ basics
    def next_ts(self) -> int:
        self.ts += 1
        return self.ts

    def table(self, name: str) -> Table:
        return self.tables[name]

    def create_table(self, name: str, schema: Schema, *, _log=True) -> Table:
        if name in self.tables:
            raise ValueError(f"table {name} exists")
        t = Table(name, schema, self.store, self.ts)
        self.tables[name] = t
        self.commit_log.append(CommitRecord(self.ts, name, "create", 0, 0))
        if _log:
            self.wal.append("create_table", name=name, schema=schema)
        return t

    def drop_table(self, name: str, *, _log=True) -> None:
        require(self.tables, name, "table")
        # drop secondary-index specs and their auxiliary tables with the
        # base table — no dangling ``engine.indices`` entry or aux table
        for spec in self.indices.pop(name, []):
            if spec.aux_table in self.tables:
                self.drop_table(spec.aux_table, _log=False)
        del self.tables[name]
        self._base = {k: v for k, v in self._base.items() if name not in k}
        if _log:
            self.wal.append("drop_table", name=name)

    def begin(self) -> Txn:
        return Txn(self)

    # convenience single-op transactions
    def insert(self, table: str, batch) -> int:
        tx = self.begin()
        tx.insert(table, batch)
        return tx.commit()

    def delete_by_keys(self, table: str, key_batch) -> int:
        tx = self.begin()
        n = tx.delete_by_keys(table, key_batch)
        tx.commit()
        return n

    def update_by_keys(self, table: str, batch) -> int:
        tx = self.begin()
        n = tx.update_by_keys(table, batch)
        tx.commit()
        return n

    # ------------------------------------------------------------ commit
    def _seal_inserts(self, schema: Schema, batches, sig_batches, ts: int):
        """Key-sort the txn's inserts and seal capacity-sized objects with
        disjoint zones.

        The zero-rehash apply path: batches gathered from sealed objects
        arrive with a ``SigBatch`` sidecar whose signatures are reused
        verbatim; a declared-key-sorted batch (one run) skips the sort,
        multi-run batches take the stable k-way merge (≡ np.lexsort).
        Only producer-authored rows pay ``compute_sigs``. Returns (oids,
        (key_lo, key_hi)) with the key lanes in SEALED (sorted) order."""
        from .sigs import DEBUG_VALIDATE_CARRY
        stats = self.commit_stats
        parts = []
        for b, sg in zip(batches, sig_batches):
            if schema.validate_batch(b) == 0:
                continue
            parts.append((b, resolve_sigs(schema, b, sg, stats)))
        if not parts:
            return [], None
        batch = (parts[0][0] if len(parts) == 1
                 else concat_batches(schema, [b for b, _ in parts],
                                     self.device))
        sigs = concat_sigs([s for _, s in parts])
        row_lo, row_hi = sigs.row_lo, sigs.row_hi
        key_lo, key_hi = sigs.key_lo, sigs.key_hi
        lob_sigs, runs = sigs.lob_sigs, sigs.runs
        alias = key_lo is row_lo           # NoPK: key IS the row signature
        n = int(row_lo.shape[0])
        if runs is not None and DEBUG_VALIDATE_CARRY:
            validate_runs(key_lo, key_hi, runs)
        order = None
        if runs is not None and runs.shape[0] <= 1:
            stats.apply_sort_skipped += 1  # producer-declared key-sorted
        elif runs is None:
            order = ops._sort128(key_lo, key_hi)
            stats.apply_sorts += 1
        else:
            # multi-run seal merges shard by key range when big enough
            # (derived plan — byte-identical sealed order)
            from ..distributed.sharding import maybe_key_cuts
            cuts = maybe_key_cuts(key_lo, key_hi, runs)
            if cuts is not None:
                self.store.metrics.add("probe.shard_parts",
                                       cuts[0].shape[0] + 1)
            order = ops.merge128_runs(key_lo, key_hi, runs, cuts=cuts)
            stats.apply_sort_merged += 1
        if order is not None:
            s_klo, s_khi = key_lo[order], key_hi[order]
        else:
            s_klo, s_khi = key_lo, key_hi
        # objects own COMPACT lanes: capacity slices of one multi-object
        # parent are copied; the single-object case stays zero-copy
        multi = n > OBJECT_CAPACITY
        oids = []
        for s in range(0, n, OBJECT_CAPACITY):
            e = min(s + OBJECT_CAPACITY, n)
            if order is not None:
                take = _gather(order[s:e])
            elif multi:
                take = _slice_copy(s, e)
            else:
                take = _same
            rl, rh = take(row_lo), take(row_hi)
            kl = rl if alias else take(key_lo)
            kh = rh if alias else take(key_hi)
            # lint: runs-ok rows are key-sorted above (sort, k-way merge,
            # or the producer's one-run claim) before capacity slicing
            obj = seal_data_object(
                self.store.new_oid(), schema,
                {k: take(v) for k, v in batch.items()},
                torch.full((e - s,), ts, dtype=torch.int64,
                           device=self.device), rl, rh, kl, kh,
                {k: take(v) for k, v in lob_sigs.items()}, presorted=True)
            self.store.put(obj)
            oids.append(obj.oid)
        return oids, (s_klo, s_khi)

    def _seal_tombstones(self, targets: torch.Tensor, ts: int) -> List[int]:
        if targets.shape[0] == 0:
            return []
        # lint: sort-ok tombstone targets must be rowid-sorted so the
        # one boundary pass below can gather per-object key lanes
        targets = torch.sort(targets).values
        klo = torch.empty_like(targets)
        khi = torch.empty_like(targets)
        toids = rowid_oid(targets)
        offs = rowid_off(targets)
        bnd = (torch.nonzero(toids[1:] != toids[:-1]).flatten() + 1).tolist()
        starts = [0] + bnd
        ends = bnd + [targets.shape[0]]
        uniq_oids = tuple(toids[starts].tolist())
        for oid, s, e in zip(uniq_oids, starts, ends):
            obj: DataObject = self.store.get(int(oid))
            klo[s:e] = obj.key_lo[offs[s:e]]
            khi[s:e] = obj.key_hi[offs[s:e]]
        oids = []
        for s in range(0, targets.shape[0], OBJECT_CAPACITY):
            sl = slice(s, s + OBJECT_CAPACITY)
            t = TombstoneObject(
                oid=self.store.new_oid(), nrows=int(targets[sl].shape[0]),
                target=targets[sl], key_lo=klo[sl], key_hi=khi[sl],
                commit_ts=torch.full(targets[sl].shape, ts,
                                     dtype=torch.int64, device=self.device),
                target_oids=uniq_oids)
            self.store.put(t)
            oids.append(t.oid)
        return oids

    def _commit(self, tx: Txn, *, _log=True) -> int:
        """Commit a (possibly multi-table) transaction at ONE timestamp.

        Phase 1 validates every table and seals its objects WITHOUT
        touching any directory; phase 2 swings all directories, after the
        FULL commit group is logged. A conflict or PK violation in any
        table unwinds every object sealed so far."""
        with telemetry.span(SP_COMMIT):
            return self._commit_phases(tx, _log)

    def _commit_phases(self, tx: Txn, _log: bool) -> int:
        crash_point(CP_TORCH_COMMIT_PRE_SEAL)
        names = sorted(set(tx._ins) | set(tx._del))
        ts = self.next_ts()
        oid0 = self.store._next_oid
        staged: List[Tuple[Table, object, list, torch.Tensor, int]] = []
        sealed: List[int] = []
        with telemetry.span(SP_COMMIT_SEAL):
            try:
                for name in names:
                    t = self.table(name)
                    # lint: sort-ok delete-target dedup at commit time —
                    # targets arrive from arbitrary staging order
                    dels = (torch.unique(torch.cat(tx._del[name]))
                            if tx._del.get(name)
                            else torch.zeros((0,), dtype=torch.int64,
                                             device=self.device))
                    # write-write conflict: every target must still be
                    # visible
                    if dels.shape[0]:
                        vi = visibility_index(self.store, t.directory)
                        if bool(vi.killed_rowids(dels).any()):
                            raise TxnConflict(
                                f"{name}: delete target already deleted")
                        live_oids = set(t.directory.data_oids)
                        # lint: sort-ok per-object liveness check — unique
                        # oids, not rows; a handful of values per commit
                        for oid in torch.unique(rowid_oid(dels)).tolist():
                            if int(oid) not in live_oids:
                                raise TxnConflict(
                                    f"{name}: target object gone")
                    ins = tx._ins.get(name, [])
                    data_oids, key_sigs = self._seal_inserts(
                        t.schema, ins, tx._sigs.get(name, [None] * len(ins)),
                        ts)
                    sealed.extend(data_oids)
                    # PK enforcement — the seal path returns the key lanes
                    # in sorted order, so in-batch dedup is one
                    # adjacent-equal scan
                    if t.schema.has_pk and key_sigs is not None:
                        klo, khi = key_sigs
                        if klo.shape[0] > 1 and bool(
                                ((klo[1:] == klo[:-1])
                                 & (khi[1:] == khi[:-1])).any()):
                            raise PKViolation(
                                f"{name}: duplicate key in insert batch")
                        existing = t.locate_keys(klo, khi)
                        live = existing != 0
                        if bool(live.any()):
                            # every live key must be among this txn's
                            # deletes (update-in-place)
                            if bool(torch.isin(existing[live], dels,
                                               invert=True).any()):
                                raise PKViolation(
                                    f"{name}: key already exists")
                    tomb_oids = self._seal_tombstones(dels, ts)
                    sealed.extend(tomb_oids)
                    ins_n = (0 if key_sigs is None
                             else int(key_sigs[0].shape[0]))
                    staged.append((t, t.directory.with_objects(
                        data_oids, tomb_oids, ts=ts), ins, dels, ins_n))
            except Exception:
                # an aborted transaction must be INVISIBLE: unwind the
                # sealed objects and roll back the oid counter and the
                # timestamp it consumed
                self._unwind(sealed)
                self.store._next_oid = oid0
                self.ts = ts - 1
                raise
        crash_point(CP_TORCH_COMMIT_POST_SEAL)
        if _log:
            for t, directory, ins, dels, ins_n in staged:
                self.wal.append("commit", table=t.name, ts=ts,
                                inserts=ins, deletes=dels,
                                op=self._op_kind, ntab=len(staged))
        with telemetry.span(SP_COMMIT_SWING):
            for j, (t, directory, ins, dels, ins_n) in enumerate(staged):
                if j:
                    crash_point(CP_TORCH_COMMIT_MID_SWING)
                t.set_directory(directory)
                self.commit_log.append(CommitRecord(
                    ts, t.name, self._op_kind, ins_n, int(dels.shape[0])))
        return ts

    def _unwind(self, oids: Sequence[int]) -> None:
        for o in oids:
            self.store.delete(o)

    # --------------------------------------------------------- snapshots
    def _snapshotish(self, ref: SnapshotRef,
                     table: Optional[str] = None) -> Snapshot:
        """Snapshot-position resolution for clone/restore: an EXACT named
        snapshot wins before ref parsing (a pre-grammar tag literally named
        ``step~1`` must restore THAT tag); everything else takes the one
        resolver, table-relative forms against ``table``."""
        if isinstance(ref, str) and ref in self.snapshots:
            return self.snapshots[ref]
        return resolve_ref(self, ref, table=table).snapshot

    def resolve_snapshot(self, ref: SnapshotRef) -> Snapshot:
        """DEPRECATED shim — kept for old callers; use ``refs.resolve``.

        A bare string resolves in the snapshot namespace alone, dict
        first (a pre-grammar name may look like a qualified ref form); a
        bare name absent from the dict raises rather than matching a table
        or branch. Only qualified forms take the one resolver."""
        if isinstance(ref, str):
            if ref in self.snapshots:
                return self.snapshots[ref]
            try:
                bare = isinstance(parse_ref(ref), BareRef)
            except RefSyntaxError:
                bare = True          # pre-grammar legacy name
            if bare:
                return require(self.snapshots, ref, "snapshot",
                               f"snap:{ref}")
        return resolve_ref(self, ref).snapshot

    def create_snapshot(self, name: str, table: str, *, _log=True) -> Snapshot:
        """CREATE SNAPSHOT name FOR TABLE table (a git tag)."""
        if _log:
            validate_name(name, "snapshot name")
        if name in self.snapshots:
            raise ValueError(f"snapshot {name} exists")
        t: Table = require(self.tables, table, "table")
        snap = Snapshot(name=name, table=table, schema=t.schema,
                        directory=t.directory, created_ts=self.ts)
        self.snapshots[name] = snap
        if _log:
            self.wal.append("snapshot", name=name, table=table)
        return snap

    def drop_snapshot(self, name: str, *, _log=True) -> None:
        require(self.snapshots, name, "snapshot", f"snap:{name}")
        del self.snapshots[name]
        # drop lineage entries pointing at the dropped snapshot (anonymous
        # bases have name=None and never match a named drop)
        self._base = {k: v for k, v in self._base.items() if v.name != name}
        if _log:
            self.wal.append("drop_snapshot", name=name)

    def list_snapshots(self) -> list:
        """Named snapshots as (name, table, created_ts), oldest first."""
        return sorted(((s.name, s.table, s.created_ts)
                       for s in self.snapshots.values()),
                      key=lambda r: (r[2], r[0]))

    def snapshot_at(self, table: str, ts: int) -> Snapshot:
        """DEPRECATED shim — use the ``table@{ts}`` ref form through
        ``refs.resolve``. T{mo_ts = ts}, a git commit."""
        return resolve_ref(self, AtRef(table, ts)).snapshot

    def current_snapshot(self, table: str) -> Snapshot:
        t = self.table(table)
        return Snapshot(name=None, table=table, schema=t.schema,
                        directory=t.directory, created_ts=self.ts)

    # ------------------------------------------------------------- clone
    def clone_table(self, new_name: str, src: SnapshotRef, *,
                    with_indices: bool = False, materialize: bool = False,
                    _log=True) -> Table:
        """CREATE TABLE new FROM SNAPSHOT src — metadata-only copy (a
        snapshot is a frozen directory, so clone copies the directory).

        ``with_indices``: also clone the auxiliary index tables, at the
        snapshot-consistent aux version (PITR at the snapshot's creation
        horizon); an index younger than the snapshot (or whose history
        was trimmed past the horizon) is rebuilt from the cloned data.

        ``materialize=True``: physically rewrite the snapshot's visible
        rows into fresh objects. Rides the zero-rehash apply path: the
        scan carries every signature lane plus per-object sorted runs, so
        the rewrite never hashes a row."""
        snap = self._snapshotish(src)
        if new_name in self.tables:
            raise ValueError(f"table {new_name} exists")
        if materialize:
            if with_indices:
                raise ValueError("clone_table: materialize=True does not "
                                 "support with_indices")
            t = self.create_table(new_name, snap.schema, _log=False)
            reader = Table(snap.table, snap.schema, self.store, snap.ts)
            batch, _, sigs = reader.scan_carry(snap.directory)
            if sigs.row_lo.shape[0]:
                tx = self.begin()
                # lint: runs-ok scan_carry's runs: one per object, each an
                # ascending slice of a key-sorted sealed object
                tx.insert(new_name, batch, sigs=sigs)
                with self.op_kind("clone"):
                    tx.commit(_log=False)
            self.set_common_base(new_name, snap.table, snap)
            if _log:
                self.wal.append("clone", new=new_name, snap=snap,
                                with_indices=False, materialize=True)
            return t
        t = Table(new_name, snap.schema, self.store, snap.ts)
        t.directory = snap.directory
        t.history = [(snap.ts, snap.directory)]
        self.tables[new_name] = t
        self.commit_log.append(CommitRecord(self.ts, new_name, "clone", 0, 0))
        self.set_common_base(new_name, snap.table, snap)
        if with_indices:
            from .indices import IndexSpec, backfill_index
            horizon = max(snap.created_ts, snap.directory.ts)
            batch = None  # one rebuild scan shared by every rebuilt index
            for spec in self.indices.get(snap.table, []):
                new_spec = IndexSpec(spec.name, new_name, spec.columns)
                aux_t = self.tables.get(spec.aux_table)
                aux_dir = None
                if aux_t is not None:
                    try:
                        aux_dir = aux_t.directory_at(horizon)
                    except KeyError:
                        pass  # index younger than the snapshot
                if aux_dir is not None:
                    self.clone_table(
                        new_spec.aux_table,
                        Snapshot(name=None, table=spec.aux_table,
                                 schema=aux_t.schema, directory=aux_dir,
                                 created_ts=horizon),
                        _log=False)
                else:
                    batch = backfill_index(self, new_spec, batch)
                self.indices.setdefault(new_name, []).append(new_spec)
        if _log:
            self.wal.append("clone", new=new_name, snap=snap,
                            with_indices=with_indices)
        return t

    def restore_table(self, table: str, src: SnapshotRef, *,
                      _log=True) -> None:
        """RESTORE TABLE table FROM SNAPSHOT src — git reset --hard.

        ``src`` may be any ref form; table-relative refs (ts:N, HEAD, ~n)
        resolve against ``table``."""
        t: Table = require(self.tables, table, "table")
        snap = self._snapshotish(src, table=table)
        if snap.table != table and not t.schema.compatible_with(snap.schema):
            raise ValueError("restore: incompatible schema")
        t.schema = snap.schema  # PITR across schema change (paper §5.5.6)
        t.set_directory(Directory(snap.directory.data_oids,
                                  snap.directory.tomb_oids, snap.ts))
        self.commit_log.append(CommitRecord(self.ts, table, "restore", 0, 0))
        if snap.table != table:
            self.set_common_base(table, snap.table, snap)
        if _log:
            self.wal.append("restore", table=table, snap=snap)

    # ------------------------------------------------------ schema change
    def alter_table_add_column(self, table: str, column, default, *,
                               _log=True) -> None:
        """ALTER TABLE ADD COLUMN (paper §5.5.6): rewrites the table under
        the new schema (row signatures cover the full row). Old snapshots
        keep the old schema.

        Partial signature carry: row signatures change and are recomputed
        (the rowhash kernel over the new lanes), but PK key signatures,
        old-column LOB content signatures and the per-object key-sorted
        runs ride through — the rewrite never re-runs blake2b and (for PK
        tables) never re-sorts what the objects already keep sorted."""
        t = self.table(table)
        batch, _, carried = t.scan_carry()
        n = batch[t.schema.names[0]].shape[0] if t.schema.names else 0
        new_schema = Schema(t.schema.columns + (column,),
                            primary_key=t.schema.primary_key)
        if column.ctype.value == "lob":
            # the sig-carrying insert below skips normalize_batch, so the
            # fill value is normalized here (str -> bytes)
            if isinstance(default, str):
                default = default.encode()
            if not isinstance(default, (bytes, bytearray)):
                raise TypeError(f"LOB column {column.name}: default must "
                                "be bytes/str")
            fill = np.empty((n,), object)
            fill[:] = bytes(default)
        else:
            # numpy fills as the reference does; the column then moves to
            # the device
            fill = torch.from_numpy(np.full(
                (n,), default, dtype=new_schema.np_dtype(column.name))
            ).to(self.device)
        batch[column.name] = fill
        if t.schema.has_pk:
            # lint: runs-ok the carried PK key lanes keep their per-object
            # sorted runs: an added column changes no key
            sigs = SigBatch(None, None, carried.key_lo, carried.key_hi,
                            carried.lob_sigs, carried.runs)
        else:
            # NoPK keys ARE row signatures — both change with the new
            # column, and so does their sort order
            # lint: runs-ok runs=None claims no order at all
            sigs = SigBatch(None, None, None, None, carried.lob_sigs, None)
        t.schema = new_schema
        t.directory = t.directory.replace(
            drop_data=t.directory.data_oids,
            drop_tombs=t.directory.tomb_oids, ts=t.directory.ts)
        t._history_append(t.directory)
        if n:
            tx = self.begin()
            # lint: runs-ok the partial carry above: key runs for PK only
            tx.insert(table, batch, sigs=sigs)
            # the rewrite is a sub-operation of the ONE alter_add_column
            # record: logging it as a plain commit too would replay it
            # twice
            with self.op_kind("alter"):
                tx.commit(_log=False)
        if _log:
            self.wal.append("alter_add_column", table=table, column=column,
                            default=default)

    # ------------------------------------------------- workflow porcelain
    # Branch refs, pull requests, atomic publish and Δ-based revert live in
    # core.workspace; these shims are the engine-level API (local imports
    # break the engine <-> workspace cycle).

    def create_branch(self, name: str, tables, from_ref: Optional[str] = None,
                      *, _log=True) -> "Branch":
        from .workspace import create_branch
        return create_branch(self, name, tables, from_ref, _log=_log)

    def drop_branch(self, name: str, *, _log=True) -> None:
        from .workspace import drop_branch
        drop_branch(self, name, _log=_log)

    def branch(self, name: str) -> "Branch":
        # lint: legacy-ok Engine.branch IS the engine-level shim —
        # as_branch lacks resolve_branch's synthesized-trunk semantics
        from .workspace import resolve_branch
        return resolve_branch(self, name)  # lint: legacy-ok the shim body

    def list_branches(self) -> list:
        """Registered branches, sorted by name."""
        return sorted(self.branches.values(), key=lambda b: b.name)

    def open_pr(self, base: Optional[str], head: str, *,
                _log=True) -> "PullRequest":
        from .workspace import open_pr
        return open_pr(self, base, head, _log=_log)

    def revert(self, table: str, from_ref: SnapshotRef, to_ref: SnapshotRef,
               *, _log=True) -> Optional[int]:
        """Apply the INVERSE of Δ(from_ref -> to_ref) to ``table``'s
        current state as a new commit — history-preserving, Δ-sized (git
        revert, not the head-rewriting restore_table)."""
        from .workspace import revert
        return revert(self, table, from_ref, to_ref, _log=_log)

    # ----------------------------------------------------------- lineage
    def set_common_base(self, a: str, b: str, snap: Snapshot) -> None:
        self._base[tuple(sorted((a, b)))] = snap

    def find_common_base(self, a: str, b: str) -> Optional[Snapshot]:
        return self._base.get(tuple(sorted((a, b))))

    # ------------------------------------------------------------ replay
    @staticmethod
    def replay(wal: WAL, *, device=None, into: Optional["Engine"] = None,
               start: int = 0) -> "Engine":
        """Deterministically rebuild an engine from its WAL (crash
        recovery), on ``device`` (the card unless the caller asks).

        Records may hold tensors (a live WAL) or numpy (a deserialized
        one); their batches are moved onto the replaying engine's device.
        ``into``/``start`` continue replay on top of an engine restored by
        other means (a refs snapshot, see ``repro_torch.store.remote``):
        records before ``start`` are assumed already absorbed into
        ``into``'s state — its oid counter included — so only the tail
        re-runs, on ``into``'s device."""
        from .compaction import compact_objects  # local import: cycle
        _sp = telemetry.span(SP_REPLAY)
        _sp.__enter__()
        try:
            e = Engine._replay_loop(wal, compact_objects, device,
                                    engine=into, start=start)
        finally:
            _sp.__exit__(None, None, None)
        # traces are derived state, never durable state: replay re-ran the
        # commits with live counters, so wipe them
        e.reset_metrics()
        return e

    @staticmethod
    def _replay_loop(wal: WAL, compact_objects, device=None,
                     engine: Optional["Engine"] = None,
                     start: int = 0) -> "Engine":
        e = engine if engine is not None else Engine(device=device)
        records = list(wal)
        i = start
        while i < len(records):
            rec = records[i]
            k, p = rec.kind, rec.payload
            i += 1
            if k == "create_table":
                e.create_table(p["name"], p["schema"], _log=False)
            elif k == "drop_table":
                e.drop_table(p["name"], _log=False)
            elif k == "commit":
                # a multi-table transaction emits one commit record per
                # table at ONE shared ts — regroup the run into one
                # transaction so replay consumes one timestamp and
                # allocates oids in the live order
                group_start = i - 1
                group = [p]
                while (i < len(records) and records[i].kind == "commit"
                        and records[i].payload["ts"] == p["ts"]):
                    group.append(records[i].payload)
                    i += 1
                # _commit logs the whole group BEFORE swinging; fewer than
                # ntab records at the tail is a torn transaction — drop it
                # whole (also from the log). Mid-log it is damage: refuse.
                want = group[0].get("ntab")
                if want is not None and len(group) < want:
                    if i >= len(records):
                        del records[group_start:]
                        wal.records = records
                        break
                    raise TornTransaction(p["ts"], len(group), want)
                tx = e.begin()
                op = group[0].get("op", "commit")
                for g in group:
                    schema = e.table(g["table"]).schema
                    for b in g["inserts"]:
                        tx._ins.setdefault(g["table"], []).append(
                            schema.normalize_batch(b, e.device))
                    if g["deletes"].shape[0]:
                        tx.delete_rowids(g["table"], g["deletes"])
                with e.op_kind(op):
                    e._commit(tx, _log=False)
            elif k == "snapshot":
                e.create_snapshot(p["name"], p["table"], _log=False)
            elif k == "drop_snapshot":
                e.drop_snapshot(p["name"], _log=False)
            elif k == "clone":
                snap = p["snap"]
                snap = e.snapshots.get(snap.name, snap) if snap.name else snap
                e.clone_table(p["new"], snap,
                              with_indices=p.get("with_indices", False),
                              materialize=p.get("materialize", False),
                              _log=False)
            elif k == "restore":
                snap = p["snap"]
                snap = e.snapshots.get(snap.name, snap) if snap.name else snap
                e.restore_table(p["table"], snap, _log=False)
            elif k == "set_base":
                e.set_common_base(p["a"], p["b"], p["snap"])
            elif k == "create_index":
                from .indices import create_index
                create_index(e, p["table"], p["name"], p["columns"],
                             _log=False)
            elif k == "drop_index":
                from .indices import drop_index
                drop_index(e, p["table"], p["name"], _log=False)
            elif k == "alter_add_column":
                e.alter_table_add_column(p["table"], p["column"],
                                         p["default"], _log=False)
            elif k == "compact":
                compact_objects(e, p["table"], p["src_oids"], _log=False)
            # workflow porcelain: one record per logical operation; the
            # sub-operations re-derive deterministically from the replayed
            # state
            elif k == "create_branch":
                e.create_branch(p["name"], p["tables"], p.get("from_ref"),
                                _log=False)
            elif k == "drop_branch":
                e.drop_branch(p["name"], _log=False)
            elif k == "open_pr":
                pr = e.open_pr(p["base"], p["head"], _log=False)
                if pr.id != p["pr"]:
                    raise ValueError(
                        f"replay diverged: PR id {pr.id} != {p['pr']}")
            elif k == "close_pr":
                e.prs[p["pr"]].close(_log=False)
            elif k == "publish":
                from .merge import ConflictMode
                e.prs[p["pr"]].publish(mode=ConflictMode(p["mode"]),
                                       _log=False, _skip_checks=True)
            elif k == "publish_revert":
                e.prs[p["pr"]].revert_publish(_log=False)
            elif k == "revert":
                sf, st = p["snap_from"], p["snap_to"]
                sf = e.snapshots.get(sf.name, sf) if sf.name else sf
                st = e.snapshots.get(st.name, st) if st.name else st
                e.revert(p["table"], sf, st, _log=False)
            else:
                raise ValueError(f"unknown WAL record {k}")
        # replay must land on the same timestamp (`or 0`: no-op publish /
        # revert records carry ts=None); scan `records`, not `wal`, so a
        # dropped torn-tail group does not leak its timestamp
        e.ts = max(e.ts, max((r.payload.get("ts") or 0 for r in records),
                             default=0))
        # the recovered engine owns its history: adopt the source WAL
        e.wal = wal
        return e

    # ------------------------------------------------------- GC (mark-sweep)
    def _pinned_snapshots(self) -> List[Snapshot]:
        """Snapshots that must survive GC beyond the named ones: lineage
        bases, branch points, and the horizons held by live pull requests
        (open PRs pin their base-at-open; published-but-not-closed PRs pin
        their pre/post publish states so revert_publish stays possible)."""
        pins = list(self._base.values())
        for br in self.branches.values():
            pins.extend(br.base.values())
        for pr in self.prs.values():
            if pr.status == "open":
                pins.extend(pr.base_pins.values())
            elif pr.status == "published":
                pins.extend(pr.pre_publish.values())
                pins.extend(pr.post_publish.values())
        return pins

    def gc(self) -> "GCStats":
        """Mark-sweep GC: drop objects unreachable from current tables,
        retained PITR history, named snapshots, and pinned horizons.

        History is trimmed to ``retention_versions`` per table, but every
        entry still backing a pinned horizon survives the trim — a pin
        guarantees ``directory_at`` keeps resolving at that horizon."""
        with telemetry.span(SP_GC):
            st = self._gc_sweep()
            m = self.store.metrics
            m.add("gc.objects_freed", st.objects_freed)
            m.add("gc.versions_pruned", st.versions_pruned)
            # a gauge, not a running sum: "pinned at the LAST sweep"
            m.counters["gc.pinned_horizons"] = st.pinned_horizons
            return st

    def _gc_sweep(self) -> "GCStats":
        pins = self._pinned_snapshots()
        pin_ts: Dict[str, set] = {}
        for s in list(self.snapshots.values()) + pins:
            if s.table in self.tables:
                pin_ts.setdefault(s.table, set()).add(
                    max(s.created_ts, s.directory.ts))
        marked = set()
        pruned = 0
        for name, t in self.tables.items():
            pruned += t.trim_history(self.retention_versions,
                                     pin_ts.get(name, ()))
            for _, d in t.history:
                marked.update(d.data_oids)
                marked.update(d.tomb_oids)
            marked.update(t.directory.data_oids)
            marked.update(t.directory.tomb_oids)
        for s in list(self.snapshots.values()) + pins:
            marked.update(s.directory.data_oids)
            marked.update(s.directory.tomb_oids)
        dead = [o for o in list(self.store.oids()) if o not in marked]
        for o in dead:
            # GC is not WAL-logged: dying between deletions only leaves
            # extra garbage for the next sweep, never a logical change
            crash_point(CP_TORCH_GC_MID_SWEEP)
            self.store.delete(o)
        return GCStats(objects_freed=len(dead), versions_pruned=pruned,
                       pinned_horizons=sum(len(v) for v in pin_ts.values()))

    def lane_nbytes(self, table: str) -> int:
        """Device bytes of the lanes of every object a table's current
        directory lists (LOB payloads are host-side and not counted)."""
        from .objects import lane_nbytes
        d = self.table(table).directory
        return sum(lane_nbytes(self.store.get(o))
                   for o in d.data_oids + d.tomb_oids)


def _same(a):
    return a


def _gather(idx: torch.Tensor):
    host = []

    def take(a):
        if is_lob(a):
            if not host:
                host.append(idx.cpu().numpy())
            return a[host[0]]
        return a[idx]
    return take


def _slice_copy(s: int, e: int):
    def take(a):
        return a[s:e].copy() if is_lob(a) else a[s:e].clone()
    return take


@dataclass
class CommitRecord:
    """One commit-log entry: what one applied operation did to one table."""
    ts: int
    table: str
    kind: str
    inserted: int
    deleted: int


@dataclass
class GCStats:
    """What one GC pass did (and deliberately did not) collect."""
    objects_freed: int = 0
    versions_pruned: int = 0
    pinned_horizons: int = 0


@dataclass
class CommitStats:
    """Where seal-time work went, cumulative per engine.

    The zero-rehash invariant: applying rows gathered from sealed objects
    (merge, revert, publish, materialized clones) never pays ``rows_rehashed`` or
    ``lob_rows_hashed``; their signatures ride along in ``SigBatch``
    sidecars and the sort is skipped or a k-way run merge."""
    rows_rehashed: int = 0       # rows that ran the rowhash kernel at seal
    rows_carried: int = 0        # rows sealed on carried write-once sigs
    lob_rows_hashed: int = 0     # per-LOB-column rows that paid blake2b
    apply_sorts: int = 0         # seals that paid the global key sort
    apply_sort_merged: int = 0   # seals that k-way merged declared runs
    apply_sort_skipped: int = 0  # seals of declared-key-sorted batches
