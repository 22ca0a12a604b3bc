"""Table: schema + current directory + PITR history + key probes."""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from .directory import Directory
from .objects import DataObject, pack_rowid
from .schema import CType, Schema, concat_batches, take_batch
from .sigs import SigBatch
from .visibility import visibility_index


def _i64(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.int64, device=device)


def _is_sorted_lo(lo: torch.Tensor) -> bool:
    """Queries ascending by their lo word (unsigned order)?"""
    f = ops.flip(lo)
    return bool((f[1:] >= f[:-1]).all())


def _zone_windows(q_lo: torch.Tensor,
                  objs: List[DataObject]) -> List[Tuple[int, int]]:
    """[a, b) per non-empty object: the slice of lo-sorted queries inside
    its zone (its first and last key_lo; objects are key-sorted). One
    searchsorted launch takes every zone's minimum on the left and its
    maximum on the right, and one host read brings the windows back."""
    k = len(objs)
    if k == 0:
        return []
    edges = torch.cat([o.key_lo[:1] for o in objs]
                      + [o.key_lo[-1:] for o in objs])
    ab = ops.lower_upper_bound(q_lo, edges, k).tolist()
    return list(zip(ab[:k], ab[k:]))


def _in_zone(q_lo: torch.Tensor, zone: torch.Tensor) -> torch.Tensor:
    f, z = ops.flip(q_lo), ops.flip(zone)
    return (f >= z[0]) & (f <= z[1])


class Table:
    def __init__(self, name: str, schema: Schema, store, ts: int):
        self.name = name
        self.schema = schema
        self._store = store
        self.directory = Directory.empty(ts)
        # PITR history: every directory version, trimmed by Engine GC and
        # kept sorted by apply-ts
        self.history: List[Tuple[int, Directory]] = [(ts, self.directory)]

    # ------------------------------------------------------------- state
    def _history_append(self, d: Directory) -> None:
        """Append a directory version, keeping history sorted by ts (an
        out-of-order apply-ts shadows every entry with ts >= its own)."""
        while self.history and self.history[-1][0] >= d.ts:
            self.history.pop()
        self.history.append((d.ts, d))

    def set_directory(self, d: Directory) -> None:
        old = self.directory
        self.directory = d
        self._history_append(d)
        # incremental visibility maintenance: derive the new version's
        # tombstone-target array from the parent's
        cache = self._store.vis_cache
        if cache is not None:
            cache.extend(old, d)

    def trim_history(self, retention: int, pinned_ts=()) -> int:
        """Trim PITR history to the trailing ``retention`` versions while
        keeping every entry still needed to serve ``directory_at`` of a
        pinned horizon (open PR bases, lineage snapshots, branch points).

        For each pin the *latest* entry with apply-ts <= pin survives — the
        one ``directory_at(pin)`` resolves to. Returns the number of
        entries pruned. ``retention <= 0`` keeps everything."""
        n = len(self.history)
        if retention <= 0 or n <= retention:
            return 0
        keep = set(range(n - retention, n))
        for ts in pinned_ts:
            i = bisect.bisect_right(self.history, ts, key=lambda e: e[0])
            if i > 0:
                keep.add(i - 1)
        kept = [self.history[i] for i in sorted(keep)]
        pruned = n - len(kept)
        self.history = kept
        return pruned

    def directory_at(self, ts: int) -> Directory:
        """PITR: latest directory version with apply-ts <= ts, horizon ts."""
        i = bisect.bisect_right(self.history, ts, key=lambda e: e[0])
        if i == 0:
            raise KeyError(f"no PITR history for {self.name} at ts={ts}")
        best = self.history[i - 1][1]
        return Directory(best.data_oids, best.tomb_oids, ts)

    # -------------------------------------------------------------- scan
    def scan(self, directory: Optional[Directory] = None,
             with_sigs: bool = False):
        """Materialize all visible rows: (batch, rowids[, row_lo, row_hi])."""
        if with_sigs:
            batch, rid, sigs = self._scan_walk(directory, carry=True)
            return batch, rid, sigs.row_lo, sigs.row_hi
        batch, rid, _ = self._scan_walk(directory, carry=False)
        return batch, rid

    def scan_carry(self, directory: Optional[Directory] = None):
        """Materialize all visible rows WITH their signature sidecar.

        Returns (batch, rowids, SigBatch): row/key signature lanes and LOB
        content signatures gathered straight from the sealed objects (zero
        hashing), plus ``runs`` offsets — every object's visible subset is
        an ascending slice of a key-sorted object, i.e. one presorted run.
        Feeding the result into ``Txn.insert(..., sigs=...)`` re-seals the
        rows without rehashing (clone materialization, ALTER rewrites)."""
        return self._scan_walk(directory, carry=True)

    def _scan_walk(self, directory: Optional[Directory], carry: bool):
        """The one visibility walk behind every scan variant."""
        d = directory or self.directory
        dev = self._store.device
        vi = visibility_index(self._store, d)
        alias = not self.schema.has_pk
        lob_names = ([c.name for c in self.schema.columns
                      if c.ctype is CType.LOB] if carry else [])
        batches, rowids, rlo, rhi, klo, khi = [], [], [], [], [], []
        lob = {c: [] for c in lob_names}
        runs, off = [], 0
        for oid in d.data_oids:
            obj: DataObject = self._store.get(oid)
            if obj.nrows == 0:
                continue
            if vi.fully_visible(obj):
                idx = None
            else:
                m = vi.visible_mask(obj)
                if not bool(m.any()):
                    continue
                idx = torch.nonzero(m).flatten()
            take = (lambda a: a) if idx is None else (lambda a: a[idx])
            batches.append(obj.cols if idx is None
                           else take_batch(obj.cols, idx))
            rowids.append(obj.rowids() if idx is None
                          else pack_rowid(oid, idx))
            if not carry:
                continue
            rlo.append(take(obj.row_lo))
            rhi.append(take(obj.row_hi))
            if not alias:
                klo.append(take(obj.key_lo))
                khi.append(take(obj.key_hi))
            for c in lob_names:
                lob[c].append(take(obj.lob_sigs[c]))
            runs.append(off)
            off += rlo[-1].shape[0]
        batch = concat_batches(self.schema, batches, dev)
        cat = lambda xs: torch.cat(xs) if xs else _i64(0, dev)  # noqa: E731
        rid = cat(rowids)
        if not carry:
            return batch, rid, None
        row_lo, row_hi = cat(rlo), cat(rhi)
        if alias:
            key_lo, key_hi = row_lo, row_hi
        else:
            key_lo, key_hi = cat(klo), cat(khi)
        # lint: runs-ok each object's visible rows are an ascending slice of
        # a key-sorted sealed object, one run per object
        sigs = SigBatch(
            row_lo, row_hi, key_lo, key_hi,
            {c: cat(v) for c, v in lob.items()},
            runs=np.asarray(runs, np.int64))
        return batch, rid, sigs

    def count(self, directory: Optional[Directory] = None) -> int:
        """Visible rows; one host read per object that has kills."""
        d = directory or self.directory
        vi = visibility_index(self._store, d)
        return sum(vi.visible_count(self._store.get(o)) for o in d.data_oids)

    # ------------------------------------------------------------ probes
    def locate_keys(self, key_lo: torch.Tensor, key_hi: torch.Tensor,
                    directory: Optional[Directory] = None) -> torch.Tensor:
        """PK probe: rowid of the visible row per key signature, 0 if
        absent. LSM probe with zone-map pruning and one fused
        ``ops.probe128`` pass per object; PK uniqueness -> at most one
        visible match. Queries should arrive sorted by (key_lo, key_hi)."""
        d = directory or self.directory
        vi = visibility_index(self._store, d)
        q = key_lo.shape[0]
        m = self._store.metrics
        m.add("probe.queries", q)
        out = _i64(q, key_lo.device)
        # sorted queries turn each object's zone filter into its window of
        # the queries (every window from one launch) + one unresolved scan
        srt = q > 1 and _is_sorted_lo(key_lo)
        pending = None if srt else torch.arange(q, device=key_lo.device)
        objs = self._live_objects(d)        # newest objects first
        wins = _zone_windows(key_lo, objs) if srt else [None] * len(objs)
        for obj, win in zip(objs, wins):
            if pending is not None and pending.shape[0] == 0:
                break
            if srt:
                a, b = win
                cand = (a + torch.nonzero(out[a:b] == 0).flatten() if b > a
                        else _i64(0, key_lo.device))
            else:
                sel = _in_zone(key_lo[pending], obj.zone)
                cand = pending[sel]
            if cand.shape[0] == 0:
                m.add("probe.objects_pruned")
                continue
            found = self._probe_object(obj, vi, key_lo[cand], key_hi[cand])
            hit = found != 0
            m.add("probe.hits", int(hit.sum()))
            out[cand[hit]] = found[hit]
            if not srt:
                pending = torch.cat([pending[~sel], cand[~hit]])
        return out

    def _live_objects(self, d: Directory) -> List[DataObject]:
        """The directory's non-empty data objects, newest first."""
        objs = (self._store.get(oid) for oid in reversed(d.data_oids))
        return [obj for obj in objs if obj.nrows]

    def _probe_object(self, obj: DataObject, vi, q_lo: torch.Tensor,
                      q_hi: torch.Tensor) -> torch.Tensor:
        """rowids of visible matches of (q_lo, q_hi) in obj (0 = miss).

        One fused ``ops.probe128`` pass hands every query its exact-key
        run ``[start, start + cnt)``; visible run heads resolve at once,
        and only runs with an invisible head AND length > 1 expand."""
        n = obj.nrows
        self._store.metrics.add("probe.objects_probed")
        out = _i64(q_lo.shape[0], q_lo.device)
        start, cnt = ops.probe128(obj.key_lo, obj.key_hi, q_lo, q_hi)
        hit = cnt > 0
        if not bool(hit.any()):
            return out
        vis = vi.visible_mask(obj)
        head = hit & vis[start.clamp(max=n - 1)]
        out[head] = pack_rowid(obj.oid, start[head])
        deep = torch.nonzero(hit & ~head & (cnt > 1)).flatten()
        if deep.shape[0]:
            self._store.metrics.add("probe.expansions", int(deep.shape[0]))
            seg, _, flat = ops.segment_expand(start[deep] + 1, cnt[deep] - 1)
            first = torch.full((deep.shape[0],), n, dtype=torch.int64,
                               device=flat.device).scatter_reduce(
                0, seg, torch.where(vis[flat], flat, n), reduce="amin")
            found = first < n
            out[deep[found]] = pack_rowid(obj.oid, first[found])
        return out

    def locate_rowsig_multi(self, sig_lo: torch.Tensor, sig_hi: torch.Tensor,
                            need: torch.Tensor,
                            directory: Optional[Directory] = None,
                            *, flat: bool = False):
        """NoPK probe: up to ``need[i]`` visible rowids per row-signature.

        Used by merge to delete k rows among duplicates (paper §3 NoPK
        cardinality resolution). Per object, one fused ``ops.probe128``
        pass hands every still-needy signature its exact-key run; only
        genuine duplicate runs expand, and matches are ranked within their
        query segment by a cumulative count.

        ``flat=True`` returns one query-ordered rowid tensor (the
        concatenation of the per-query buckets); otherwise a list of one
        rowid tensor per query."""
        d = directory or self.directory
        dev = sig_lo.device
        vi = visibility_index(self._store, d)
        q = sig_lo.shape[0]
        m = self._store.metrics
        m.add("probe.queries", q)
        part_rows: List[torch.Tensor] = []
        part_qids: List[torch.Tensor] = []
        remaining = need.to(device=dev, dtype=torch.int64).clone()
        srt = q > 1 and _is_sorted_lo(sig_lo)
        objs = self._live_objects(d)
        wins = _zone_windows(sig_lo, objs) if srt else [None] * len(objs)
        for obj, win in zip(objs, wins):
            if srt:
                a, b = win
                act = (a + torch.nonzero(remaining[a:b] > 0).flatten()
                       if b > a else _i64(0, dev))
            else:
                act = torch.nonzero(remaining > 0).flatten()
                if act.shape[0] == 0:
                    break
                act = act[_in_zone(sig_lo[act], obj.zone)]
            if act.shape[0] == 0:
                m.add("probe.objects_pruned")
                continue
            m.add("probe.objects_probed")
            start, lens = ops.probe128(obj.key_lo, obj.key_hi,
                                       sig_lo[act], sig_hi[act])
            nz = lens > 0
            act, start, lens = act[nz], start[nz], lens[nz]
            if act.shape[0] == 0:
                continue
            vis = vi.visible_mask(obj)
            if bool((lens == 1).all()):
                # unique signatures: the run IS its head
                ok = vis[start]
                hit_off = start[ok]
                if hit_off.shape[0]:
                    m.add("probe.hits", int(hit_off.shape[0]))
                    part_rows.append(pack_rowid(obj.oid, hit_off))
                    part_qids.append(act[ok])
                    remaining[act[ok]] -= 1
                continue
            m.add("probe.expansions", int((lens > 1).sum()))
            seg, base, offs = ops.segment_expand(start, lens)
            match = vis[offs].to(torch.int64)  # keys equal by construction
            # rank of each match within its query segment (1-based)
            cm = torch.cumsum(match, 0)
            seg_base = cm[base] - match[base]
            rank = cm - seg_base[seg]
            take = (match > 0) & (rank <= remaining[act][seg])
            taken = torch.nonzero(take).flatten()
            if taken.shape[0]:
                m.add("probe.hits", int(taken.shape[0]))
                part_rows.append(pack_rowid(obj.oid, offs[taken]))
                part_qids.append(act[seg[taken]])
            remaining[act] -= _i64(act.shape[0], dev).index_add_(
                0, seg, take.to(torch.int64))
        empty = _i64(0, dev)
        if not part_rows:
            return empty if flat else [empty] * q
        rows = torch.cat(part_rows)
        qids = torch.cat(part_qids)
        # bucket per query, stable by discovery order (newest object
        # first, ascending offset within an object)
        order = torch.sort(qids, stable=True).indices
        rows, qids = rows[order], qids[order]
        if flat:
            return rows
        found = [empty] * q
        for qi, part in zip(*_split_by_key(qids, rows)):
            found[qi] = part
        return found


def _split_by_key(keys: torch.Tensor, vals: torch.Tensor):
    """Runs of equal (sorted) ``keys``: (host key list, value slices)."""
    cuts = (torch.nonzero(keys[1:] != keys[:-1]).flatten() + 1).tolist()
    heads = [0] + cuts
    bounds = heads + [keys.shape[0]]
    ks = keys[heads].tolist()
    return ks, [vals[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
