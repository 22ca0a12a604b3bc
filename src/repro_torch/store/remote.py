"""Remotes: refs snapshots, push/pull/fetch, and repo-level clone.

A **remote** is a directory with the same object layout a local pack tier
uses, plus the repo metadata::

    <remote>/refs.dgrf            refs snapshot (the remote's commit point)
    <remote>/wal.dgws             full framed WAL (transport/history copy)
    <remote>/objects/<digest>.dgp content-addressed DGPK pack files

The **refs snapshot** is the engine's metadata — directories, histories,
snapshots, branches, PRs, the commit log, and the oid→digest map — WITHOUT
object payloads, and without a tensor anywhere in it. It is what makes
``clone --shallow`` possible: a shallow clone imports refs up front and
faults objects from its origin on first gather (an upload to the engine's
device), never replaying the WAL's data batches.

The refs payload pickles this package's own metadata classes, so a remote
written by ``repro_torch`` is read by ``repro_torch``; the DGPK packs are
the part both packages read.

Authority rules (the crash-consistency contract):

* On a **remote**, ``refs.dgrf`` is the commit point. WAL bytes beyond
  ``refs["n_records"]`` are an unacknowledged push tail and are ignored by
  every reader (``read_remote`` truncates) — so a crash between the WAL
  swing and the refs swing is invisible, all-or-nothing.
* On a **local refs-mode store**, the WAL is the commit point (the CLI
  acknowledged those frames) and refs are a derived cache: a load replays
  the WAL tail past ``n_records`` on top of the imported refs.

Exchange ships only what the other side is missing: objects by digest
(dedup across oids and repos for free) plus the WAL suffix.
"""
from __future__ import annotations

import os
import pickle
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.engine import CommitRecord, Engine
from ..core.faults import crash_point, register
from ..core.objects import TombstoneObject
from ..core.table import Table
from ..core.wal import WAL, encode_frame, iter_frames
from ..interop import host_tree
from .packs import (PACK_SUFFIX, PackDir, PackFormatError, _atomic_write,
                    _read, blob_digest, encode_object)

REFS_MAGIC = b"DGRF"
REFS_VERSION = 1
REFS_HEADER = REFS_MAGIC + bytes([REFS_VERSION]) + b"\x00\x00\x00"

REFS_FILE = "refs.dgrf"
WAL_FILE = "wal.dgws"

CP_TORCH_STORE_PUSH_MANIFEST = register(
    "torch.store.push.manifest",
    "objects and the WAL copy are shipped but the remote refs file has "
    "not swung — the refs are the remote's commit point, so recovery "
    "must read the remote at its OLD state (extra content-addressed "
    "objects are invisible garbage)")
CP_TORCH_STORE_PULL_APPLY = register(
    "torch.store.pull.apply",
    "missing objects are fetched into the local pack tier but the local "
    "engine/WAL has not swung — recovery must show the local repo "
    "unchanged (prefetched packs are invisible until referenced)")


class RemoteError(ValueError):
    """A remote is unreadable, diverged, or refused the operation."""


# --------------------------------------------------------------------------
# refs snapshot encode/decode
# --------------------------------------------------------------------------

def encode_refs(payload: dict) -> bytes:
    return REFS_HEADER + encode_frame(
        pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))


def decode_refs(blob: bytes) -> dict:
    if blob[:4] != REFS_MAGIC:
        raise PackFormatError(
            f"bad magic {bytes(blob[:4])!r}: not a datagit refs snapshot")
    if len(blob) < len(REFS_HEADER) or blob[4] != REFS_VERSION:
        raise PackFormatError("refs snapshot header truncated or "
                              f"unsupported version (want v{REFS_VERSION})")
    frames = iter_frames(blob, len(REFS_HEADER))
    payload = next(frames, None)
    if payload is None:
        raise PackFormatError("refs snapshot has no payload frame")
    return pickle.loads(payload[0])


def export_refs(engine, objects: Dict[int, Tuple[str, bool, int]], *,
                origin: Optional[str] = None) -> dict:
    """The engine's metadata as a picklable refs payload (no tensors).

    ``objects`` maps every live oid to ``(digest, is_tomb, nbytes)`` —
    the content-address map that replaces the heap. PR CI checks are
    in-process callables and do not survive (same caveat as WAL replay)."""
    prs = []
    for pr in engine.prs.values():
        prs.append({"id": pr.id, "base_name": pr.base_name,
                    "head_name": pr.head_name, "tables": dict(pr.tables),
                    "base_pins": dict(pr.base_pins), "status": pr.status,
                    "publish_ts": pr.publish_ts,
                    "pre_publish": dict(pr.pre_publish),
                    "post_publish": dict(pr.post_publish)})
    return {
        "format": REFS_VERSION,
        "n_records": len(engine.wal.records),
        "record_sigs": _record_sigs(engine.wal),
        "ts": engine.ts,
        "next_oid": engine.store._next_oid,
        "retention": engine.retention_versions,
        "tables": {name: (t.schema, list(t.history))
                   for name, t in engine.tables.items()},
        "snapshots": dict(engine.snapshots),
        "base": dict(engine._base),
        "indices": {k: list(v) for k, v in engine.indices.items()},
        "branches": {name: (br.name, dict(br.tables), dict(br.base),
                            br.parent, br.created_ts)
                     for name, br in engine.branches.items()},
        "prs": prs,
        "next_pr_id": engine._next_pr_id,
        "commit_log": [(c.ts, c.table, c.kind, c.inserted, c.deleted)
                       for c in engine.commit_log],
        "objects": {int(oid): tuple(ent) for oid, ent in objects.items()},
        "origin": origin,
    }


def import_refs(payload: dict, wal: WAL, packs: PackDir,
                device=None) -> Engine:
    """Rebuild an engine on ``device`` (the card unless the caller asks)
    from a refs payload WITHOUT replaying the WAL.

    Every object starts evicted (oid → digest in the pack tier) and faults
    in on first gather. WAL records past ``payload["n_records"]`` (a local
    store's crash tail or post-refs appends) are replayed on top;
    signatures of imported objects are carried verbatim, never recomputed
    (``rows_rehashed`` stays 0)."""
    from ..core.workspace import Branch, PullRequest

    e = Engine(device=device,
               retention_versions=payload.get("retention", 1024))
    st = e.store
    st.attach_packs(packs)
    for oid, ent in payload["objects"].items():
        st._packed[int(oid)] = tuple(ent)
        st._digest_refs[ent[0]] = st._digest_refs.get(ent[0], 0) + 1
    st._next_oid = payload["next_oid"]
    for name, (schema, history) in payload["tables"].items():
        t = Table(name, schema, st, 0)
        t.history = list(history)
        t.directory = t.history[-1][1]
        e.tables[name] = t
    e.snapshots = dict(payload["snapshots"])
    e._base = dict(payload["base"])
    e.indices = {k: list(v) for k, v in payload["indices"].items()}
    for name, tup in payload["branches"].items():
        e.branches[name] = Branch(*tup)
    for d in payload["prs"]:
        pr = object.__new__(PullRequest)
        pr.engine = e
        pr.id = d["id"]
        pr.base_name = d["base_name"]
        pr.head_name = d["head_name"]
        pr.tables = dict(d["tables"])
        pr.base_pins = dict(d["base_pins"])
        pr.checks = []                  # in-process callables never survive
        pr.status = d["status"]
        pr.publish_ts = d["publish_ts"]
        pr.pre_publish = dict(d["pre_publish"])
        pr.post_publish = dict(d["post_publish"])
        pr.publish_reports = {}
        e.prs[pr.id] = pr
    e._next_pr_id = payload["next_pr_id"]
    e.commit_log = [CommitRecord(*t) for t in payload["commit_log"]]
    e.ts = payload["ts"]
    n = payload["n_records"]
    _adopt_sigs(wal, payload)
    if len(wal.records) > n:
        # local crash tail: the WAL is the local commit point — replay the
        # acknowledged records the refs cache has not absorbed yet
        Engine.replay(wal, into=e, start=n)
    else:
        e.wal = wal
        e.reset_metrics()
    return e


# --------------------------------------------------------------------------
# remote I/O
# --------------------------------------------------------------------------

def _paths(remote: str) -> Tuple[str, str, str]:
    return (os.path.join(remote, REFS_FILE),
            os.path.join(remote, WAL_FILE),
            os.path.join(remote, "objects"))


def read_remote(remote: str) -> Tuple[dict, list]:
    """A remote's ``(refs payload, acknowledged records)``.

    The refs file is the remote's commit point: WAL records past
    ``n_records`` are an unacknowledged push tail and are dropped here."""
    refs_path, wal_path, _ = _paths(remote)
    if not os.path.exists(refs_path):
        raise RemoteError(f"no remote at {remote} (missing {REFS_FILE})")
    payload = decode_refs(_read(refs_path))
    records = WAL.deserialize(_read(wal_path)).records
    n = payload["n_records"]
    if len(records) < n:
        raise RemoteError(
            f"remote {remote} is damaged: refs acknowledge {n} record(s) "
            f"but the WAL holds {len(records)}")
    return payload, records[:n]


def _fold(h: int, x) -> int:
    """Fold one WAL payload value into a running zlib crc32: arrays (and
    tensors, as numpy) by dtype, shape and bytes, LOB arrays by their
    values' lengths and bytes, containers element by element, anything
    else by its pickle. A live record and its deserialized twin fold
    alike: nothing here depends on pickle's memoisation of shared
    subobjects."""
    if torch.is_tensor(x):
        x = host_tree(x)
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            vals = [bytes(v) for v in x.tolist()]
            lens = np.fromiter(map(len, vals), dtype=np.int64,
                               count=len(vals))
            h = zlib.crc32(b"L%d" % len(vals), h)
            h = zlib.crc32(lens.tobytes(), h)
            return zlib.crc32(b"".join(vals), h)
        a = np.ascontiguousarray(x)
        h = zlib.crc32(f"A{a.dtype.str}{a.shape}".encode(), h)
        return zlib.crc32(a.reshape(-1).view(np.uint8), h)
    if isinstance(x, dict):
        h = zlib.crc32(b"D%d" % len(x), h)
        for k, v in x.items():
            h = _fold(_fold(h, k), v)
        return h
    if isinstance(x, (list, tuple)):
        h = zlib.crc32(b"T" if isinstance(x, tuple) else b"S", h)
        h = zlib.crc32(b"%d" % len(x), h)
        for v in x:
            h = _fold(h, v)
        return h
    return zlib.crc32(pickle.dumps(x, protocol=pickle.HIGHEST_PROTOCOL), h)


def _record_sig(record) -> int:
    """One record's content fingerprint (kind and payload, folded)."""
    return _fold(zlib.crc32(record.kind.encode()), record.payload)


def _record_sigs(wal: WAL) -> List[int]:
    """Per-record content fingerprints for the fast-forward check.

    Kinds alone cannot tell two different inserts apart — divergent
    histories with the same op shapes would slip past a prefix-of-kinds
    compare. Records are immutable once appended, so each is hashed once
    per WAL: ``wal._sigs`` caches (record, sig) pairs by identity, and a
    WAL built from a refs snapshot's records starts with the snapshot's
    fingerprints (``_adopt_sigs``)."""
    cache = getattr(wal, "_sigs", [])
    recs = wal.records
    k = 0
    while k < len(cache) and k < len(recs) and cache[k][0] is recs[k]:
        k += 1
    cache = cache[:k] + [(r, _record_sig(r)) for r in recs[k:]]
    wal._sigs = cache
    return [s for _, s in cache]


def _adopt_sigs(wal: WAL, payload: dict) -> None:
    """Seed ``wal``'s fingerprint cache with the refs snapshot's, for the
    records the snapshot acknowledges (their content is what it hashed)."""
    n = min(payload["n_records"], len(wal.records))
    wal._sigs = list(zip(wal.records[:n], payload["record_sigs"][:n]))


def _require_fast_forward(local_sigs: List[int], remote_sigs: List[int],
                          op: str) -> None:
    behind, ahead = ((remote_sigs, local_sigs) if op == "push"
                     else (local_sigs, remote_sigs))
    n = len(behind)
    if n > len(ahead) or behind != ahead[:n]:
        raise RemoteError(
            f"{op} refused: histories diverged (not a fast-forward) — "
            + ("pull first, then push" if op == "push"
               else "the local store has records the remote lacks"))


def _digest_entry(store, oid: int) -> Tuple[Tuple[str, bool, int],
                                            Optional[bytes]]:
    """``(digest, is_tomb, nbytes)`` for one live oid, reusing the pack
    tier's digest when spilled (blob is returned only when freshly
    encoded — callers copy the pack file otherwise)."""
    ent = store._packed.get(oid)
    if ent is not None:
        return ent, None
    obj = store.get(oid)
    blob = encode_object(obj)
    return ((blob_digest(blob), isinstance(obj, TombstoneObject),
             int(obj.nbytes)), blob)


def push(engine, remote: str) -> dict:
    """Ship missing objects + the WAL to ``remote``; swing its refs.

    Only objects whose digest the remote lacks are transferred (the
    content address is the dedup key); the refs rewrite is the atomic
    commit point, so a crash anywhere leaves the remote at its old state."""
    refs_path, wal_path, objects_dir = _paths(remote)
    os.makedirs(objects_dir, exist_ok=True)
    local_sigs = _record_sigs(engine.wal)
    n_remote = 0
    if os.path.exists(refs_path):
        rpayload = decode_refs(_read(refs_path))
        _require_fast_forward(local_sigs, rpayload["record_sigs"], "push")
        n_remote = rpayload["n_records"]
    objects: Dict[int, Tuple[str, bool, int]] = {}
    pushed = bytes_pushed = 0
    store = engine.store
    for oid in sorted(store.oids()):
        ent, blob = _digest_entry(store, oid)
        objects[oid] = ent
        dst = os.path.join(objects_dir, ent[0] + PACK_SUFFIX)
        if not os.path.exists(dst):
            if blob is None:            # spilled: copy the local pack file
                blob = store.packs.read(ent[0])
            _atomic_write(dst, blob)
            pushed += 1
            bytes_pushed += len(blob)
    # the WAL copy is transport/history, not the commit point — an atomic
    # whole rewrite keeps it a pure function of the refs that follow
    _atomic_write(wal_path, engine.wal.serialize())
    crash_point(CP_TORCH_STORE_PUSH_MANIFEST)
    _atomic_write(refs_path, encode_refs(export_refs(engine, objects)))
    store.metrics.add("store.objects_pushed", pushed)
    return {"objects_pushed": pushed, "bytes_pushed": bytes_pushed,
            "records_pushed": len(local_sigs) - n_remote}


def fetch(engine, remote: str, pack_dir: Optional[str] = None) -> dict:
    """Copy objects the local pack tier lacks from ``remote`` (no state
    change — a warm-up for shallow clones and future pulls)."""
    payload, _ = read_remote(remote)
    packs = _local_packs(engine, pack_dir, remote)
    fetched, fbytes = _fetch_missing(packs, payload, remote)
    engine.store.metrics.add("store.objects_pulled", fetched)
    return {"objects_pulled": fetched, "bytes_pulled": fbytes}


def _local_packs(engine, pack_dir: Optional[str], remote: str) -> PackDir:
    if engine.store.packs is not None:
        return engine.store.packs
    if pack_dir is None:
        # no local pack tier: mount the remote's objects read-through
        backend = PackDir(remote)
    else:
        backend = PackDir(pack_dir, origin=remote)
    engine.store.attach_packs(backend)
    return backend


def _fetch_missing(packs: PackDir, payload: dict,
                   remote: str) -> Tuple[int, int]:
    if os.path.abspath(packs.root) == os.path.abspath(remote):
        return 0, 0                     # reading the remote in place
    fetched = fbytes = 0
    for digest in sorted({ent[0] for ent in payload["objects"].values()}):
        if packs.has(digest):
            continue
        blob = _read(os.path.join(remote, "objects", digest + PACK_SUFFIX))
        if blob_digest(blob) != digest:
            raise PackFormatError(
                f"remote object {digest[:12]}… fails its digest")
        packs.store(digest, blob)
        fetched += 1
        fbytes += len(blob)
    return fetched, fbytes


def pull(engine, remote: str,
         pack_dir: Optional[str] = None) -> Tuple[Engine, dict]:
    """Fast-forward the local repo to the remote's acknowledged state.

    Fetches only missing objects (counter-pinned: ``store.objects_pulled``
    == the missing-set size when a local pack tier exists), then rebuilds
    the engine from the remote refs on the same device — imported objects
    carry their signatures verbatim, so a pull never re-hashes a row.
    Objects already resident locally with a matching digest stay in the
    heap tier (on the device)."""
    payload, records = read_remote(remote)
    local_sigs = _record_sigs(engine.wal)
    _require_fast_forward(local_sigs, payload["record_sigs"], "pull")
    if len(local_sigs) == len(payload["record_sigs"]):
        return engine, {"up_to_date": True, "objects_pulled": 0,
                        "records_pulled": 0}
    packs = _local_packs(engine, pack_dir, remote)
    if os.path.abspath(packs.root) != os.path.abspath(remote):
        # make the local tier authoritative for what we already have, so
        # "missing" is computed against durable local content
        engine.store.spill_all()
        packs.origin = payload.get("origin") or remote
    fetched, fbytes = _fetch_missing(packs, payload, remote)
    crash_point(CP_TORCH_STORE_PULL_APPLY)
    new_wal = WAL()
    new_wal.records = list(records)
    e2 = import_refs(dict(payload, origin=packs.origin), new_wal, packs,
                     engine.device)
    # heap carry-over: same oid + same digest == same bytes (content
    # addressing); keep the resident object instead of a later fault-in
    old = engine.store
    for oid, ent in e2.store._packed.items():
        obj = old._objects.get(oid)
        oent = old._packed.get(oid)
        if obj is not None and oent is not None and oent[0] == ent[0]:
            e2.store._objects[oid] = obj
    e2.store.metrics.add("store.objects_pulled", fetched)
    return e2, {"up_to_date": False, "objects_pulled": fetched,
                "bytes_pulled": fbytes,
                "records_pulled": len(records) - len(local_sigs)}


def clone(remote: str, dest_store: str, *, shallow: bool = False) -> dict:
    """Create a local refs-mode store from ``remote``.

    ``shallow``: copy refs + WAL only; objects fault in from the origin on
    first gather. Otherwise every object is fetched up front."""
    payload, records = read_remote(remote)
    if os.path.exists(dest_store):
        raise RemoteError(f"clone destination {dest_store} already exists")
    packs = PackDir(dest_store + ".packs", origin=os.path.abspath(remote))
    packs.ensure()
    fetched = 0
    if not shallow:
        fetched, _ = _fetch_missing(packs, payload, remote)
    w = WAL()
    w.records = records
    _atomic_write(dest_store, w.serialize())
    _atomic_write(dest_store + ".refs",
                  encode_refs(dict(payload,
                                   origin=os.path.abspath(remote))))
    return {"shallow": shallow, "objects_fetched": fetched,
            "records": len(records)}
