"""Integrity verification and salvage (`datagit fsck`), on the device.

The write-once signature substrate makes verification nearly free in the
ForkBase sense: every sealed object *carries* the 128-bit row/key
signatures of its rows, so recomputing them from the stored column values
(the rowhash kernel, on the store's device) and comparing is a complete,
self-contained integrity check — no external checksum database needed.

``fsck(engine)`` verifies four layers and the pack tier:

1. **objects** — structural shape (every lane the same length), key-lane
   sortedness (the seal invariant readers bisect on, compared as
   sign-flipped words on the device), tombstone targets inside their
   declared object set, and carried signatures vs recomputed hashes (full
   or sampled);
2. **reachability** — every object referenced by any directory reachable
   from a ref root (table current+history, named snapshots, branch bases,
   PR pins, lineage bases) exists in the store;
3. **refs** — branch physical tables resolve;
4. **packs** — every packed oid's pack file exists (or is origin-backed),
   matches its content address and frame-verifies;
5. **replay** — serialize -> deserialize -> ``Engine.replay`` reproduces
   identical content digests, timestamps, and porcelain registries.

The report equals the reference's on the same history: the same issue
kinds, places, oids and counts (sampling draws with
``np.random.default_rng(seed)`` exactly as the reference does, so both
verify the same objects). Each layer runs in a telemetry span of its own
(``fsck.objects``, ``fsck.signatures`` once per recomputed object,
``fsck.packs``, ``fsck.replay``); :func:`layer_seconds` reads the run's
host seconds by layer from an armed tracer. fsck reads no clock itself.

``repair=True`` is salvage, not undo: corrupt/missing objects are
quarantined (dropped from the store and scrubbed from every directory),
the report lists every ref the quarantine makes unreachable, and
derivable state is rebuilt — visibility/delta caches are reset for lazy
re-attach and secondary-index aux tables are re-backfilled from their
repaired base tables. Repair is NOT WAL-logged; a repaired engine no
longer replay-matches its log, and the report says so.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..interop import to_numpy
from ..kernels import ops
from . import telemetry
from .directory import Directory
from .objects import DataObject, TombstoneObject, rowid_oid
from .sigs import compute_sigs

__all__ = ["FsckIssue", "FsckReport", "fsck", "layer_seconds"]

SP_FSCK = telemetry.register_span(
    "fsck", "integrity verification: objects, reachability, refs, packs, "
    "replay round-trip")
#: one span per layer, by the layer's name in :func:`layer_seconds`
LAYER_SPANS = {
    "objects": telemetry.register_span(
        "fsck.objects", "fsck layer: reachability, refs, every object's "
                        "fault-in, structure and sortedness (its "
                        "fsck.signatures spans nest inside)"),
    "signatures": telemetry.register_span(
        "fsck.signatures", "fsck layer: one data object's rowhash "
                           "recompute and compare"),
    "packs": telemetry.register_span(
        "fsck.packs", "fsck layer: every packed oid's pack file verified"),
    "replay": telemetry.register_span(
        "fsck.replay", "fsck layer: the WAL round-trip replay and its "
                       "digests"),
}


@dataclass
class FsckIssue:
    kind: str               # signature_mismatch | bad_structure |
    #                         unsorted_keys | bad_tombstone |
    #                         missing_object | dangling_ref |
    #                         pack_corrupt | replay_divergence |
    #                         replay_failure
    where: str              # ref context, e.g. "table:t@current"
    detail: str
    oid: Optional[int] = None

    def __str__(self):
        o = f" oid={self.oid}" if self.oid is not None else ""
        return f"[{self.kind}]{o} {self.where}: {self.detail}"


@dataclass
class FsckReport:
    issues: List[FsckIssue] = field(default_factory=list)
    objects_checked: int = 0
    rows_verified: int = 0
    directories_checked: int = 0
    refs_checked: int = 0
    packs_checked: int = 0
    replay_checked: bool = False
    # repair results
    repaired: bool = False
    quarantined: List[int] = field(default_factory=list)
    refs_unreachable: List[str] = field(default_factory=list)
    indices_rebuilt: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.issues

    def summary(self) -> str:
        head = ("clean" if self.ok
                else f"{len(self.issues)} issue(s)")
        s = (f"fsck: {head} — {self.objects_checked} object(s), "
             f"{self.rows_verified} row(s) verified, "
             f"{self.directories_checked} directories, "
             f"{self.refs_checked} refs"
             + (f", {self.packs_checked} pack(s)" if self.packs_checked
                else "")
             + (", replay checked" if self.replay_checked else ""))
        if self.repaired:
            s += (f"; repaired: {len(self.quarantined)} quarantined, "
                  f"{len(self.refs_unreachable)} ref(s) now unreachable, "
                  f"{len(self.indices_rebuilt)} index(es) rebuilt "
                  "(WAL no longer replays this state)")
        return s


def _digest(engine, table: str) -> str:
    """Order-independent sha256 over the full-row signatures, sorted as
    unsigned (lo, hi) pairs on the device."""
    _, _, lo, hi = engine.table(table).scan(with_sigs=True)
    order = ops._sort128(lo, hi)
    h = hashlib.sha256(to_numpy(lo[order], u64=True).tobytes())
    h.update(to_numpy(hi[order], u64=True).tobytes())
    return h.hexdigest()


def _state(engine) -> dict:
    out = {"__ts__": engine.ts,
           "__tables__": tuple(sorted(engine.tables)),
           "__snapshots__": tuple(sorted(engine.snapshots)),
           "__branches__": tuple(sorted(engine.branches)),
           "__prs__": tuple(sorted((i, p.status)
                                   for i, p in engine.prs.items()))}
    for name in engine.tables:
        out[name] = _digest(engine, name)
    return out


def _ref_roots(engine) -> List[Tuple[str, object, Directory]]:
    """Every (ref label, schema, directory) fsck must walk: table current
    state and PITR history, named snapshots, lineage bases, branch points,
    and live PR pins — the same roots ``Engine.gc`` marks from."""
    roots: List[Tuple[str, object, Directory]] = []
    for name, t in engine.tables.items():
        roots.append((f"table:{name}@current", t.schema, t.directory))
        for ts_, d in t.history:
            roots.append((f"table:{name}@ts:{ts_}", t.schema, d))
    for s in engine.snapshots.values():
        roots.append((f"snapshot:{s.name}", s.schema, s.directory))
    for (a, b), s in engine._base.items():
        roots.append((f"base:{a}~{b}", s.schema, s.directory))
    for bname, br in engine.branches.items():
        for lg, s in br.base.items():
            roots.append((f"branch:{bname} base {lg}", s.schema,
                          s.directory))
    for pid, pr in engine.prs.items():
        pins: Dict[str, object] = {}
        if pr.status == "open":
            pins = pr.base_pins
        elif pr.status == "published":
            pins = {**pr.pre_publish,
                    **{f"{k}(post)": v for k, v in pr.post_publish.items()}}
        for lg, s in pins.items():
            roots.append((f"pr:{pid} pin {lg}", s.schema, s.directory))
    return roots


def _first(mask: torch.Tensor) -> int:
    return int(torch.nonzero(mask).flatten()[0])


def _check_data_object(obj: DataObject, schema, where: str,
                       verify_sigs: bool, report: FsckReport) -> None:
    n = obj.nrows
    lanes = {"commit_ts": obj.commit_ts, "row_lo": obj.row_lo,
             "row_hi": obj.row_hi, "key_lo": obj.key_lo,
             "key_hi": obj.key_hi}
    for cname, arr in obj.cols.items():
        lanes[f"col:{cname}"] = arr
    for lname, sig in obj.lob_sigs.items():
        lanes[f"lob_sig:{lname}"] = sig
    bad = [ln for ln, a in lanes.items() if len(a) != n]
    if bad:
        report.issues.append(FsckIssue(
            "bad_structure", where, f"lane length != nrows={n}: {bad}",
            obj.oid))
        return                      # shape is broken; nothing else is safe
    if n > 1:
        # unsigned order of the words: compare them sign-flipped
        lo, hi = ops.flip(obj.key_lo), ops.flip(obj.key_hi)
        ordered = (lo[1:] > lo[:-1]) | ((lo[1:] == lo[:-1])
                                        & (hi[1:] >= hi[:-1]))
        if not bool(ordered.all()):
            at = _first(~ordered)
            report.issues.append(FsckIssue(
                "unsorted_keys", where,
                f"key lanes not lexsorted at row {at + 1}", obj.oid))
            return                  # bisecting readers would misbehave
    # signature verification needs the sealing-era schema: an object sealed
    # before an ALTER has fewer columns than the table's current schema —
    # verify only when the context schema matches the stored columns
    if (not verify_sigs or schema is None
            or tuple(schema.names) != tuple(obj.cols)):
        return
    with telemetry.span(LAYER_SPANS["signatures"]):
        rlo, rhi, klo, khi, lob = compute_sigs(schema, obj.cols)
        mism = (rlo != obj.row_lo) | (rhi != obj.row_hi)
        if schema.has_pk:
            mism |= (klo != obj.key_lo) | (khi != obj.key_hi)
        for cname, sig in lob.items():
            mism |= sig != obj.lob_sigs[cname]
        if bool(mism.any()):
            rows = torch.nonzero(mism).flatten()
            report.issues.append(FsckIssue(
                "signature_mismatch", where,
                f"{rows.shape[0]} row(s) disagree with carried signatures "
                f"(first at row {int(rows[0])})", obj.oid))
        else:
            report.rows_verified += n


def _check_tombstone(obj: TombstoneObject, where: str,
                     report: FsckReport) -> None:
    n = obj.nrows
    lanes = {"target": obj.target, "key_lo": obj.key_lo,
             "key_hi": obj.key_hi, "commit_ts": obj.commit_ts}
    bad = [ln for ln, a in lanes.items() if len(a) != n]
    if bad:
        report.issues.append(FsckIssue(
            "bad_structure", where, f"lane length != nrows={n}: {bad}",
            obj.oid))
        return
    if n:
        declared = set(int(x) for x in np.asarray(obj.target_oids).ravel())
        actual = set(torch.unique(rowid_oid(obj.target)).tolist())
        stray = actual - declared
        if stray:
            report.issues.append(FsckIssue(
                "bad_tombstone", where,
                f"targets hit undeclared object(s) {sorted(stray)}",
                obj.oid))
    # rowids sit below 2**63: their signed order is their unsigned order
    if n > 1 and not bool((obj.target[1:] >= obj.target[:-1]).all()):
        report.issues.append(FsckIssue(
            "bad_tombstone", where, "target rowids not sorted", obj.oid))


def _is_data(store, oid: int) -> bool:
    """Whether ``oid`` is a data object, without faulting it in."""
    obj = store._objects.get(oid)
    if obj is not None:
        return isinstance(obj, DataObject)
    return not store._packed[oid][1]


def _objects_layer(engine, report: FsckReport, sample: float,
                   seed: int) -> List[Tuple[str, object, Directory]]:
    """Reachability, ref resolvability and every reachable object's
    checks (a sampled signature recompute); returns the roots walked."""
    roots = _ref_roots(engine)
    report.directories_checked = len(roots)

    # ---- reachability + per-object context (first ref wins for schema)
    ctx: Dict[int, Tuple[str, object]] = {}
    missing: Dict[int, str] = {}
    for where, schema, d in roots:
        for oid in tuple(d.data_oids) + tuple(d.tomb_oids):
            if not engine.store.has(oid):
                missing.setdefault(oid, where)
            elif oid not in ctx:
                ctx[oid] = (where, schema)
    for oid, where in sorted(missing.items()):
        report.issues.append(FsckIssue(
            "missing_object", where,
            "directory references an object absent from the store", oid))

    # ---- ref resolvability (branch physical tables can dangle if a table
    # was force-dropped; snapshots/pins are self-contained by construction)
    for bname, br in engine.branches.items():
        for lg, phys in br.tables.items():
            report.refs_checked += 1
            if phys not in engine.tables:
                report.issues.append(FsckIssue(
                    "dangling_ref", f"branch:{bname}",
                    f"table {lg!r} -> physical {phys!r} does not exist"))
    report.refs_checked += len(roots)

    # ---- object verification (sampled signature recompute; the draw is
    # the reference's, over the same sorted data oids)
    oids = sorted(ctx)
    verify = set(oids)
    if sample < 1.0:
        rng = np.random.default_rng(seed)
        data_oids = [o for o in oids if _is_data(engine.store, o)]
        k = max(1, int(np.ceil(sample * len(data_oids)))) \
            if data_oids else 0
        verify = set(rng.choice(data_oids, size=k, replace=False).tolist()) \
            if k else set()
    for oid in oids:
        obj = engine.store.get(oid)
        where, schema = ctx[oid]
        report.objects_checked += 1
        if isinstance(obj, TombstoneObject):
            _check_tombstone(obj, where, report)
        else:
            _check_data_object(obj, schema, where, oid in verify, report)
    return roots


def fsck(engine, *, sample: float = 1.0, check_replay: bool = True,
         repair: bool = False, seed: int = 0) -> FsckReport:
    """Verify the engine's integrity; optionally salvage (see module doc).

    ``sample`` is the fraction of reachable data objects whose signatures
    are recomputed (1.0 = every row of every object; structural and
    sortedness checks always run on all of them). Deterministic under
    ``seed``."""
    with telemetry.span(SP_FSCK):
        return _fsck(engine, sample=sample, check_replay=check_replay,
                     repair=repair, seed=seed)


def _fsck(engine, *, sample: float, check_replay: bool, repair: bool,
          seed: int) -> FsckReport:
    report = FsckReport()
    with telemetry.span(LAYER_SPANS["objects"]):
        roots = _objects_layer(engine, report, sample, seed)

    # ---- pack tier integrity: every packed oid's pack file must exist (or
    # be origin-backed), match its content address, and frame-verify —
    # bit rot in the spill tier is caught here even while a heap copy
    # masks it from readers
    packs = engine.store.packs
    if packs is not None:
        with telemetry.span(LAYER_SPANS["packs"]):
            for oid, ent in sorted(engine.store._packed.items()):
                report.packs_checked += 1
                for why in packs.verify(ent[0]):
                    report.issues.append(FsckIssue(
                        "pack_corrupt", f"pack:{ent[0][:12]}", why, oid))

    # ---- WAL replay equivalence (skipped when state is already damaged:
    # the live digests would throw on missing objects)
    if check_replay and not report.issues:
        with telemetry.span(LAYER_SPANS["replay"]):
            _replay_layer(engine, report)

    if repair:
        _repair(engine, report, roots)
    return report


def _replay_layer(engine, report: FsckReport) -> None:
    from .engine import Engine
    from .wal import WAL
    report.replay_checked = True
    try:
        replayed = Engine.replay(
            WAL.deserialize(engine.wal.serialize()),
            device=engine.device)
        live, redo = _state(engine), _state(replayed)
        if live != redo:
            keys = sorted(k for k in set(live) | set(redo)
                          if live.get(k) != redo.get(k))
            report.issues.append(FsckIssue(
                "replay_divergence", "wal",
                f"replayed state differs at {keys}"))
    except Exception as exc:
        report.issues.append(FsckIssue(
            "replay_failure", "wal", f"{type(exc).__name__}: {exc}"))


def layer_seconds(tracer: telemetry.Tracer) -> Dict[str, float]:
    """Host seconds of the fsck runs in ``tracer``'s window by layer:
    objects (its spans less the signature spans nested in them),
    signatures, packs and replay; 0.0 for a layer that did not run. On
    the card a span times what the host enqueued and waited for."""
    names = {sp: layer for layer, sp in LAYER_SPANS.items()}
    out = dict.fromkeys(LAYER_SPANS, 0.0)
    stack = list(tracer.roots)
    while stack:
        sp = stack.pop()
        if sp.name in names:
            out[names[sp.name]] += sp.dur_s
        stack.extend(sp.children)
    out["objects"] -= out["signatures"]
    return out


def _repair(engine, report: FsckReport, roots) -> None:
    """Salvage: quarantine bad objects and scrub them out of EVERY
    reachable directory (current, history, snapshots, pins), reporting
    each ref that loses state; then rebuild the derivable state. After
    repair the engine is internally consistent again — a follow-up
    ``fsck(check_replay=False)`` is clean — but the WAL still describes
    the undamaged history, so the replay check reports divergence until
    the store is re-created."""
    import dataclasses

    bad_kinds = {"signature_mismatch", "bad_structure", "unsorted_keys",
                 "bad_tombstone"}
    bad = {i.oid for i in report.issues
           if i.kind in bad_kinds and i.oid is not None}
    gone = bad | {i.oid for i in report.issues
                  if i.kind == "missing_object"}
    if not gone:
        return
    report.repaired = True
    # caches first: they index the pre-quarantine object set; None means
    # lazy rebuild on the next visibility/delta read
    engine.store.vis_cache = None
    engine.store.delta_cache = None
    for oid in sorted(bad):
        if engine.store.has(oid):
            engine.store.delete(oid)
        report.quarantined.append(oid)
    for where, _, d in roots:
        if (set(d.data_oids) | set(d.tomb_oids)) & gone:
            report.refs_unreachable.append(where)

    def scrub(d: Directory) -> Directory:
        return d.replace(drop_data=gone, drop_tombs=gone)

    def scrub_snap(s):
        return dataclasses.replace(s, directory=scrub(s.directory))

    affected = []
    for name, t in engine.tables.items():
        if (set(t.directory.data_oids) | set(t.directory.tomb_oids)) & gone:
            affected.append(name)
        t.directory = scrub(t.directory)
        t.history[:] = [(hts, scrub(d)) for hts, d in t.history]
    for nm, s in list(engine.snapshots.items()):
        engine.snapshots[nm] = scrub_snap(s)
    for k, s in list(engine._base.items()):
        engine._base[k] = scrub_snap(s)
    for br in engine.branches.values():
        for lg, s in list(br.base.items()):
            br.base[lg] = scrub_snap(s)
    for pr in engine.prs.values():
        for pins in (pr.base_pins, pr.pre_publish, pr.post_publish):
            for lg, s in list(pins.items()):
                pins[lg] = scrub_snap(s)
    # derivable state: re-backfill secondary indices of repaired tables
    from .indices import backfill_index
    for name in affected:
        for spec in engine.indices.get(name, ()):
            if spec.aux_table in engine.tables:
                engine.drop_table(spec.aux_table, _log=False)
            backfill_index(engine, spec)
            report.indices_rebuilt.append(spec.aux_table)
