"""``datagit`` — git-style CLI over the VCS statement layer, on the port.

Every subcommand compiles to a ``core.statements`` statement and executes
it against a :class:`~repro_torch.core.Repo`, so the CLI, the statement
string, and the Python API are three doors into the SAME resolver and verb
set.

State persists as a serialized WAL: each invocation replays the store file
into an engine on ``--device`` (the card unless ``--device cpu`` is
given), runs the command, and appends the new WAL records back — crash
recovery and the CLI share one durability story.

  PYTHONPATH=src python -m repro_torch.vcs_cli --device cpu \\
      --store /tmp/demo.wal init
  ... seed orders --rows 10000
  ... branch dev -t orders
  ... mutate dev/orders --rows 200 --seed 1
  ... diff 'branch:dev' HEAD --table orders
  ... pr open dev
  ... publish 1
  ... log orders
  ... revert-pr 1
  ... gc
  ... fsck
  ... lint --format json

``seed`` / ``mutate`` generate deterministic demo data, the same rows as
the reference CLI's (they are the only subcommands that do not map onto a
statement). ``push`` / ``pull`` / ``fetch`` exchange with a remote
directory, ``clone <remote> [--shallow]`` makes a new refs-mode store
(``<store>.refs`` + ``<store>.packs``) whose objects fault in from the
origin, and ``fsck [--repair]`` verifies the store's frames and then the
engine. ``lint`` runs the port's static invariant analysis
(``repro_torch.analysis``) over the port's source tree; it needs no store
and no device, and shares the runner with ``python -m
repro_torch.analysis`` and the ``LINT`` statement.

Caveat on ``pr check``: user CI checks are in-process Python callables
(``repo.pr(n).add_check(fn)``) and cannot survive the WAL round-trip, so
a fresh invocation sees none of them — across processes the gate catches
only the built-in merge-conflict preview (which is still exit-1
gateable).
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
from typing import List, Optional

import numpy as np

from .core import (AmbiguousRefError, Column, CorruptFrame, CType,
                   MergeConflictError, PKViolation, PublishBlocked, Repo,
                   RefSyntaxError, RevertConflict, Schema, StoreFormatError,
                   TornFrame, TxnConflict, UnknownRefError, WAL, as_branch)
from .core import telemetry
from .core.engine import Engine
from .core.faults import crash_point, register
from .core.statements import StatementError, execute, execute_script
from .core.wal import (STORE_HEADER, StoreVersionError, check_store_header,
                       dump_records, encode_frame, iter_frames)
from .device import resolve_device
from .interop import to_numpy

DEMO_SCHEMA = Schema((Column("k", CType.I64), Column("v", CType.F64),
                      Column("doc", CType.LOB)), primary_key=("k",))
DEMO_SCHEMA_NOPK = Schema(DEMO_SCHEMA.columns, primary_key=None)


# --------------------------------------------------------------------------
# store persistence — checksummed append-only WAL frames
#
# The store file is the DGWS framed format of ``core.wal``: an 8-byte
# magic/version header, then one CRC32C frame per invocation holding the
# records that invocation appended. Load verifies every frame and replays;
# save appends ONLY the records new since load — O(delta) I/O per command,
# not O(history), which is also the WAL's own durability story (a log you
# append to, not a snapshot you rewrite).
#
# Records go into a frame as numpy (``wal.dump_records``), never as
# tensors; replay moves them onto the engine's device.
#
# Failure surface (all typed, never pickle garbage):
#   torn tail     -> recovered at load; bytes preserved to <store>.corrupt
#                    and truncated at the NEXT save (never parsed past)
#   flipped bit   -> CorruptFrame naming the frame (a plain load refuses)
#   wrong version -> StoreVersionError with an upgrade hint; legacy
#                    headerless pickle stores load once and are rewritten
#                    in the framed format on the next save
# --------------------------------------------------------------------------

CP_TORCH_SAVE_MID_FRAME = register(
    "torch.cli.save.mid_frame",
    "half of a store frame's bytes are on disk when the process dies — "
    "load must recover to the previous clean frame and preserve the torn "
    "tail to the .corrupt sidecar")
CP_TORCH_SAVE_PRE_FSYNC = register(
    "torch.cli.save.pre_fsync",
    "the frame is fully written but not fsynced — the frame may or may "
    "not survive; both recoveries are all-or-nothing")


def _preserve_tail(store: str, tail: bytes) -> bool:
    """Preserve dropped bytes to ``<store>.corrupt`` — NEVER silently
    discard. Returns False when this exact tail is already preserved (so
    the recovery hint prints once, not on every subsequent load)."""
    if not tail:
        return False
    side = store + ".corrupt"
    if os.path.exists(side):
        with open(side, "rb") as f:
            if f.read().endswith(tail):
                return False
    with open(side, "ab") as f:
        f.write(tail)
        f.flush()
        # lint: crash-ok sidecar preservation is best-effort forensics —
        # a crash here loses no acknowledged data (the store is untouched)
        os.fsync(f.fileno())
    return True


def load_repo(store: str, device=None) -> Repo:
    """Replay the store into a Repo whose engine runs on ``device`` (the
    card unless the caller asks)."""
    wal = WAL()
    clean_end = 0
    rewrite = False                 # next save must rewrite the whole file
    blob = b""
    if os.path.exists(store):
        with open(store, "rb") as f:
            blob = f.read()
    if blob:
        start = check_store_header(blob)
        if start < 0:
            # one-shot legacy path: pre-frame stores are a bare sequence
            # of pickle frames with no checksums — load them once, then
            # save_repo upgrades the file to the framed format
            import io
            bio = io.BytesIO(blob)
            while True:
                try:
                    recs = pickle.load(bio)
                except Exception:   # EOF = done; anything else = torn tail
                    break
                wal.records.extend(recs)
                clean_end = bio.tell()
            rewrite = True
            if _preserve_tail(store, blob[clean_end:]):
                print(f"warning: {len(blob) - clean_end} byte(s) of torn "
                      f"trailing frame in {store} (unacknowledged crashed "
                      f"write) preserved to {store}.corrupt",
                      file=sys.stderr)
        else:
            clean_end = start
            try:
                for payload, end in iter_frames(blob, start):
                    wal.records.extend(pickle.loads(payload))
                    clean_end = end
            except TornFrame as err:
                # recoverable by construction: the tail was never
                # acknowledged. Preserve it; the next save truncates.
                if _preserve_tail(store, err.tail):
                    print(f"warning: {len(err.tail)} byte(s) of torn "
                          f"trailing frame in {store} (unacknowledged "
                          f"crashed write) preserved to {store}.corrupt",
                          file=sys.stderr)
            # CorruptFrame / StoreVersionError propagate: mid-file damage
            # is not self-healing — main() surfaces the typed error
    n_loaded = len(wal.records)
    refs_path = store + ".refs"
    refs_origin = None
    if os.path.exists(refs_path) and not rewrite:
        # refs-mode store: rebuild from the refs snapshot and fault objects
        # from the pack tier lazily — only WAL records past the snapshot
        # (a crash tail) replay. The WAL stays authoritative locally; the
        # refs file is a derived cache refreshed at save.
        from .store.packs import PackDir
        from .store.remote import decode_refs, import_refs
        with open(refs_path, "rb") as f:
            payload = decode_refs(f.read())
        refs_origin = payload.get("origin")
        packs = PackDir(store + ".packs", origin=refs_origin)
        engine = import_refs(payload, wal, packs, resolve_device(device))
    else:
        # adopts `wal`, so new records append
        engine = Engine.replay(wal, device=device)
        refs_path = None
    repo = Repo(engine)
    if len(wal.records) != n_loaded:
        # replay dropped a torn trailing commit group: the on-disk frames
        # still carry it, so appending after them would turn it into
        # mid-log damage — rewrite the store whole on the next save
        rewrite = True
    repo._persisted_records = len(wal.records)
    repo._persisted_offset = clean_end
    repo._rewrite_store = rewrite
    repo._refs_path = refs_path
    repo._refs_origin = refs_origin
    return repo


def save_repo(store: str, repo: Repo) -> None:
    done = getattr(repo, "_persisted_records", 0)
    new = repo.engine.wal.records[done:]
    exists = os.path.exists(store)
    if not new and exists:
        # nothing appended: read-only commands must never touch the store
        # file — even a pending legacy upgrade / torn-group rewrite waits
        # for the next MUTATING command (the load path handles the old
        # format again until then)
        return
    if getattr(repo, "_rewrite_store", False):
        # legacy upgrade (or a dropped torn txn group): rewrite the whole
        # store in the framed format, atomically via rename
        tmp = store + ".tmp"
        with open(tmp, "wb") as f:
            f.write(STORE_HEADER)
            f.write(encode_frame(dump_records(repo.engine.wal.records)))
            f.flush()
            # lint: crash-ok the rewrite goes to a temp file: a crash here
            # leaves the old store untouched until os.replace below
            os.fsync(f.fileno())
        os.replace(tmp, store)
        repo.engine.wal.bytes_written += os.path.getsize(store)
        repo.engine.wal.fsyncs += 1
        repo._persisted_offset = os.path.getsize(store)
        repo._persisted_records = len(repo.engine.wal.records)
        repo._rewrite_store = False
        _save_refs(store, repo)
        return
    offset = getattr(repo, "_persisted_offset", 0)
    with open(store, "r+b" if exists else "wb") as f:
        if offset < len(STORE_HEADER):
            f.write(STORE_HEADER)
            offset = len(STORE_HEADER)
        f.seek(0, os.SEEK_END)
        if f.tell() > offset:
            # torn tail from a previous crash: already preserved by
            # load_repo; truncate HERE, at save-time, so a purely
            # read-only session never modifies the store file
            f.seek(offset)
            _preserve_tail(store, f.read())
            f.truncate(offset)
        f.seek(offset)
        frame = encode_frame(dump_records(new))
        # two-part write around the crash point so an injected mid-frame
        # kill leaves genuinely torn bytes on disk for load to recover
        half = len(frame) // 2
        f.write(frame[:half])
        f.flush()
        crash_point(CP_TORCH_SAVE_MID_FRAME)
        f.write(frame[half:])
        f.flush()
        crash_point(CP_TORCH_SAVE_PRE_FSYNC)
        os.fsync(f.fileno())
        repo.engine.wal.bytes_written += len(frame)
        repo.engine.wal.fsyncs += 1
        repo._persisted_offset = f.tell()
    repo._persisted_records = done + len(new)
    _save_refs(store, repo)


def _save_refs(store: str, repo: Repo) -> None:
    """Refresh the refs snapshot of a refs-mode store.

    Runs AFTER the WAL bytes are durable: locally the WAL is the commit
    point and the refs file only caches the replayed state, so a crash
    between the two just means the next load replays a short tail."""
    refs_path = getattr(repo, "_refs_path", None)
    if refs_path is None:
        return
    from .store.packs import _atomic_write, attach_packs
    from .store.remote import encode_refs, export_refs
    e = repo.engine
    origin = getattr(repo, "_refs_origin", None)
    attach_packs(e.store, store + ".packs", origin=origin)
    e.store.spill_all()             # every live object gets a pack copy
    _atomic_write(refs_path, encode_refs(export_refs(
        e, dict(e.store._packed), origin=e.store.packs.origin)))


# --------------------------------------------------------------------------
# demo data (deterministic; the only non-statement subcommands)
# --------------------------------------------------------------------------

def _demo_batch(keys: np.ndarray, seed: int):
    rng = np.random.default_rng(seed)
    return {"k": keys.astype(np.int64),
            "v": np.round(rng.random(keys.shape[0]) * 100.0, 6),
            "doc": [b"doc-%d-%d" % (seed, int(k)) for k in keys]}


def seed_table(repo: Repo, table: str, rows: int, seed: int,
               nopk: bool = False) -> str:
    if table not in repo.engine.tables:
        repo.create_table(table, DEMO_SCHEMA_NOPK if nopk else DEMO_SCHEMA)
    repo.insert(table, _demo_batch(np.arange(rows), seed))
    return f"table {table} seeded with {rows} row(s) (seed={seed})"


def mutate_table(repo: Repo, table: str, rows: int, seed: int) -> str:
    batch, _ = repo.table(table).scan()
    keys = np.sort(to_numpy(batch["k"]))
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(keys, size=min(rows, keys.shape[0]),
                              replace=False))
    upd = _demo_batch(pick, seed)
    upd["doc"] = [b"mut-%d-%d" % (seed, int(k)) for k in pick]
    repo.update_by_keys(table, upd)
    return f"table {table}: {pick.shape[0]} row(s) updated (seed={seed})"


# --------------------------------------------------------------------------
# subcommand -> statement compilation
# --------------------------------------------------------------------------

def _q(ref: str) -> str:
    """Quote a ref-position arg into statement text. No legal ref contains
    a quote — reject instead of letting it escape the quoting and be
    reinterpreted as statement syntax (the _ident() rationale)."""
    if "'" in ref:
        raise ValueError(f"invalid ref {ref!r}: refs cannot contain \"'\"")
    return "'" + ref + "'"


def _ident(name: str, what: str) -> str:
    """Name-position CLI args are interpolated into statement text
    unquoted — validate them first so `dg branch "dev FOR (prod)"` is an
    error, not silently reinterpreted as statement syntax."""
    from .core.refs import validate_name
    return validate_name(name, what)


def _branch_ident(name: str) -> str:
    """Branch-position arg: a `branch:` qualifier is legal, strip it."""
    return _ident(name[len("branch:"):] if name.startswith("branch:")
                  else name, "branch name")


def _compile(args, repo: Repo) -> Optional[str]:
    """The statement a subcommand compiles to (None = handled natively)."""
    c = args.cmd
    if c == "branch":
        name = _ident(args.name, "branch name")
        if args.delete:
            return f"DROP BRANCH {name}"
        stmt = f"CREATE BRANCH {name}"
        if args.from_ref:
            stmt += f" FROM {_q(args.from_ref)}"
        if args.tables is not None:
            if not args.tables:
                raise ValueError("branch: -t/--tables needs at least one "
                                 "table (omit it to branch every table)")
            stmt += " FOR (" + ", ".join(
                _ident(t, "table name") for t in args.tables) + ")"
        return stmt
    if c == "snapshot":
        name = _ident(args.name, "snapshot name")
        if args.delete:
            return f"DROP SNAPSHOT {name}"
        if not args.table:
            raise ValueError("snapshot: a table is required "
                             "(snapshot NAME TABLE)")
        return (f"CREATE SNAPSHOT {name} FOR TABLE "
                f"{_ident(args.table, 'table name')}")
    if c == "clone":
        return (f"CLONE TABLE {_ident(args.new, 'table name')} "
                f"FROM {_q(args.ref)}"
                + (" MATERIALIZE" if args.materialize else ""))
    if c == "push":
        return f"PUSH TO {_q(args.remote)}"
    if c == "diff":
        stmt = f"DIFF {_q(args.a)} AGAINST {_q(args.b)}"
        if args.table:
            stmt += f" FOR TABLE {_ident(args.table, 'table name')}"
        return stmt
    if c == "merge":
        # both sides branches -> whole-branch atomic merge; else table
        # form. The into-position prefers an exact table name (same rule
        # as Repo.merge / MERGE ... INTO TABLE): a branch sharing the
        # name must not make the table unreachable from the CLI.
        dst_is_table = args.dst in repo.engine.tables
        if (not dst_is_table
                and as_branch(repo.engine, args.src) is not None
                and as_branch(repo.engine, args.dst) is not None):
            # MERGE BRANCH takes bare names: strip a branch: qualifier the
            # user (legitimately) wrote, instead of double-prefixing it
            src, dst = _branch_ident(args.src), _branch_ident(args.dst)
            stmt = f"MERGE BRANCH {src} INTO {dst}"
            if args.mode:
                stmt += f" MODE {_ident(args.mode, 'mode')}"
            if args.tables is not None:
                if not args.tables:
                    raise ValueError("merge: -t/--tables needs at least "
                                     "one table (omit it to merge every "
                                     "shared table)")
                stmt += " FOR (" + ", ".join(
                    _ident(t, "table name") for t in args.tables) + ")"
            return stmt
        if args.tables is not None:
            raise ValueError("merge: -t/--tables only applies to "
                             "branch-to-branch merges")
        stmt = (f"MERGE {_q(args.src)} INTO TABLE "
                f"{_ident(args.dst, 'table name')}")
        if args.mode:
            stmt += f" MODE {_ident(args.mode, 'mode')}"
        return stmt
    if c == "pr":
        if args.pr_cmd == "open":
            stmt = f"OPEN PR FROM {_branch_ident(args.head)}"
            if args.into:
                stmt += f" INTO {_branch_ident(args.into)}"
            return stmt
        if args.pr_cmd == "check":
            return f"CHECK PR {args.id}"
        return f"CLOSE PR {args.id}"
    if c == "publish":
        return (f"PUBLISH PR {args.id}"
                + (f" MODE {_ident(args.mode, 'mode')}"
                   if args.mode else ""))
    if c == "revert-pr":
        return f"REVERT PR {args.id}"
    if c == "revert":
        return (f"REVERT TABLE {_ident(args.table, 'table name')} "
                f"FROM {_q(args.from_ref)} TO {_q(args.to_ref)}")
    if c == "restore":
        return (f"RESTORE TABLE {_ident(args.table, 'table name')} "
                f"TO {_q(args.ref)}")
    if c == "log":
        return (f"LOG TABLE {_ident(args.table, 'table name')}"
                + (f" LIMIT {args.limit}" if args.limit is not None else ""))
    if c == "branches":
        return "SHOW BRANCHES"
    if c == "snapshots":
        return "SHOW SNAPSHOTS"
    if c == "prs":
        return "SHOW PRS"
    if c == "tables":
        return "SHOW TABLES"
    if c == "status":
        return "STATUS"
    if c == "stats":
        return "STATS"
    if c == "gc":
        return "GC"
    return None


#: subcommands that only read — skipped on store write-back. ``sql`` is
#: NOT here: raw statements may mutate, so their WAL must persist. ``gc``
#: IS here: it is deliberately un-WAL-logged, so the write-back would be
#: byte-identical wasted I/O. ``push``/``fetch`` write to the REMOTE (or
#: the pack sidecar), never to the store file itself.
_READ_ONLY = {"diff", "log", "branches", "snapshots", "prs", "tables",
              "status", "stats", "gc", "push", "fetch"}

#: error types with a deliberate user-facing shape (ref/statement/VCS
#: semantics, durable-format damage); anything else caught below gets its
#: class name surfaced
_TYPED_ERRORS = (UnknownRefError, AmbiguousRefError, RefSyntaxError,
                 StatementError, MergeConflictError, PublishBlocked,
                 RevertConflict, PKViolation, TxnConflict,
                 StoreFormatError)


def _store_fsck(store: str, repair: bool) -> int:
    """Byte-level pass of `dg fsck`: header + frame CRC verification.

    Returns the count of UNREPAIRED store-level problems. With ``repair``,
    a corrupt frame is handled git-style: everything from the bad frame
    onward moves to ``<store>.corrupt`` and the store truncates to the
    last clean prefix (acknowledged data is lost but preserved — the
    report says exactly how many bytes)."""
    with open(store, "rb") as f:
        blob = f.read()
    if not blob:
        return 0
    try:
        clean = check_store_header(blob)
        if clean < 0:
            print("store: legacy headerless format (no checksums) — "
                  "loads once; any write upgrades it to the framed format")
            return 0
        for _, end in iter_frames(blob, clean):
            clean = end
    except TornFrame as err:
        preserved = _preserve_tail(store, err.tail)
        print(f"store: torn tail — {len(err.tail)} unacknowledged byte(s) "
              f"past offset {err.clean_end}"
              + (f" (preserved to {store}.corrupt)" if preserved
                 else " (already preserved)"))
        return 0                    # recoverable: load handles this
    except (CorruptFrame, StoreVersionError) as err:
        print(f"store: {err}")
        if repair and isinstance(err, CorruptFrame):
            _preserve_tail(store, blob[err.offset:])
            with open(store, "r+b") as f:
                f.truncate(err.offset)
                f.flush()
                # lint: crash-ok repair truncation is idempotent — a
                # crash here re-runs fsck --repair to the same offset
                os.fsync(f.fileno())
            print(f"store: truncated to last clean frame at offset "
                  f"{err.offset}; {len(blob) - err.offset} byte(s) "
                  f"preserved to {store}.corrupt")
            return 0
        if isinstance(err, CorruptFrame):
            print("hint: `fsck --repair` truncates to the last clean "
                  "frame (damaged bytes preserved to the .corrupt "
                  "sidecar), or restore the store from a backup")
        return 1
    return 0


def _cmd_fsck(args, device) -> int:
    bad = _store_fsck(args.store, args.repair)
    if bad:
        return 1
    repo = load_repo(args.store, device)
    report = repo.fsck(sample=args.sample,
                       check_replay=not args.no_replay,
                       repair=args.repair)
    print(report.summary())
    for issue in report.issues:
        print(str(issue))
    if report.repaired:
        # engine state derives from the WAL at every load; quarantine
        # results live only in this process — the durable fix for a
        # WAL-backed store is the byte-level truncation above
        print("note: object-level repairs apply to this process; the "
              "store re-derives state from its WAL on every load")
    return 0 if report.ok else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="datagit", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--store", default=os.environ.get("VCS_STORE",
                                                      ".vcs_store.wal"),
                    help="WAL store file (default $VCS_STORE or "
                         ".vcs_store.wal)")
    ap.add_argument("--device", default=None,
                    help="where the engine runs: a torch device such as "
                         "cuda or cpu (default: the card)")
    ap.add_argument("--trace", metavar="FILE", default=None,
                    help="write this invocation's span tree as "
                         "Chrome-tracing JSON (loads in Perfetto / "
                         "chrome://tracing)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("init", help="create an empty store")

    p = sub.add_parser("seed", help="create + fill a demo table")
    p.add_argument("table")
    p.add_argument("--rows", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nopk", action="store_true")

    p = sub.add_parser("mutate", help="deterministically update demo rows")
    p.add_argument("table")
    p.add_argument("--rows", type=int, default=100)
    p.add_argument("--seed", type=int, default=1)

    p = sub.add_parser("sql", help="run raw VCS statements (';'-separated)")
    p.add_argument("statements")

    p = sub.add_parser("branch", help="create (or -d delete) a branch")
    p.add_argument("name")
    p.add_argument("-d", "--delete", action="store_true")
    p.add_argument("-t", "--tables", nargs="*", default=None)
    p.add_argument("--from", dest="from_ref", default=None,
                   metavar="REF")

    p = sub.add_parser("snapshot", help="tag (or -d drop) a named snapshot")
    p.add_argument("name")
    p.add_argument("table", nargs="?", default=None)
    p.add_argument("-d", "--delete", action="store_true")

    p = sub.add_parser("clone", help="clone a table from any ref, or — "
                                     "with one arg — clone a whole repo "
                                     "from a remote directory into --store")
    p.add_argument("new", help="new table name (table clone) or the "
                               "remote directory (repo clone)")
    p.add_argument("ref", nargs="?", default=None)
    p.add_argument("--materialize", action="store_true")
    p.add_argument("--shallow", action="store_true",
                   help="repo clone only: skip fetching objects — fault "
                        "them from the origin on first read")

    p = sub.add_parser("diff", help="diff two refs")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--table", default=None)

    p = sub.add_parser("merge", help="merge a ref/branch into a "
                                     "table/branch")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--mode", default=None)
    p.add_argument("-t", "--tables", nargs="*", default=None)

    p = sub.add_parser("pr", help="pull requests")
    prs = p.add_subparsers(dest="pr_cmd", required=True)
    pp = prs.add_parser("open")
    pp.add_argument("head")
    pp.add_argument("--into", default=None)
    for name in ("check", "close"):
        pp = prs.add_parser(name)
        pp.add_argument("id", type=int)

    p = sub.add_parser("publish", help="publish a PR atomically")
    p.add_argument("id", type=int)
    p.add_argument("--mode", default=None)

    p = sub.add_parser("revert-pr", help="inverse-Δ revert of a publish")
    p.add_argument("id", type=int)

    p = sub.add_parser("revert", help="apply inverse Δ(from -> to)")
    p.add_argument("table")
    p.add_argument("from_ref")
    p.add_argument("to_ref")

    p = sub.add_parser("restore", help="git reset --hard to a ref")
    p.add_argument("table")
    p.add_argument("ref")

    p = sub.add_parser("log", help="commit history of a table")
    p.add_argument("table")
    p.add_argument("-n", "--limit", type=int, default=None)

    for name, help_ in (("branches", "list branches"),
                        ("snapshots", "list snapshots"),
                        ("prs", "list pull requests"),
                        ("tables", "list tables"),
                        ("status", "full repo summary"),
                        ("gc", "mark-sweep garbage collection")):
        sub.add_parser(name, help=help_)

    p = sub.add_parser("push", help="ship missing objects + the WAL to a "
                                    "remote directory (fast-forward only)")
    p.add_argument("remote")

    p = sub.add_parser("pull", help="fast-forward this store to a "
                                    "remote's state (fetches only "
                                    "missing objects)")
    p.add_argument("remote")

    p = sub.add_parser("fetch", help="copy missing objects from a remote "
                                     "without changing repo state")
    p.add_argument("remote")

    p = sub.add_parser("stats", help="metrics registry snapshot")
    p.add_argument("--format", choices=("text", "json"), default="text")

    p = sub.add_parser(
        "lint",
        help="static invariant analysis of the source tree",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description=(
            "Run the invariant analysis suite (repro_torch.analysis) over "
            "the port's package, src/repro_torch/ (or the given paths).\n\n"
            "Passes:\n"
            "  sorted-claims   runs=/sigs=/presorted=True claims outside\n"
            "                  the reviewed producer modules\n"
            "  hidden-sort     np./torch. sort/lexsort/unique/argsort on\n"
            "                  the zero-rehash hot paths (delta/merge/ops/"
            "engine)\n"
            "  crash-coverage  core.faults registry vs crash_point sites;\n"
            "                  unguarded fsync/directory swings; broad\n"
            "                  excepts around seams\n"
            "  deprecation     the deprecated resolvers, incl. aliasing\n"
            "                  and getattr forms\n"
            "  wal-hygiene     WAL kinds vs the replay dispatch; time/RNG\n"
            "                  (numpy's and torch's) in logging functions;\n"
            "                  clocks anywhere in repro_torch.core outside\n"
            "                  core.telemetry\n"
            "  sealed-write    in-place writes to sealed-object lanes,\n"
            "                  in-place tensor methods, re-armed writes\n"
            "                  (static half of REPRO_SANITIZE=1)\n\n"
            "Suppress a finding with a JUSTIFIED pragma on the finding\n"
            "line or a comment line directly above:\n"
            "  # lint: <token> <reason>\n"
            "where <token> is the pass's token (runs-ok, sort-ok,\n"
            "crash-ok, legacy-ok, wal-ok, seal-ok). A pragma without a\n"
            "reason suppresses nothing and is itself a finding.\n\n"
            "Exit codes: 0 clean, 1 unsuppressed findings, 2 usage "
            "error."))
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the repo tree)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", metavar="FILE", default=None,
                   help="only findings absent from this JSON snapshot "
                        "fail the run")
    p.add_argument("--write-baseline", metavar="FILE", default=None,
                   help="write the findings snapshot and exit 0")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="also list suppressed findings")

    p = sub.add_parser("fsck", help="verify store frames, object "
                                    "signatures, refs, replay equivalence")
    p.add_argument("--repair", action="store_true",
                   help="truncate past store corruption (bytes preserved "
                        "to .corrupt) and quarantine bad objects")
    p.add_argument("--sample", type=float, default=1.0,
                   help="fraction of objects to signature-verify "
                        "(default 1.0 = all)")
    p.add_argument("--no-replay", action="store_true",
                   help="skip the WAL replay-equivalence check")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.trace:
        # arm BEFORE the store loads so the replay span is captured (the
        # engine binds in _cmd once it exists); the trace file is written
        # on the way out, errors included — traces are derived state, so
        # nothing here touches the durability story
        with telemetry.trace(None) as tracer:
            try:
                return _run(args, tracer)
            finally:
                telemetry.write_chrome_trace(args.trace, tracer)
    return _run(args, None)


def _run(args, tracer: Optional[telemetry.Tracer]) -> int:
    # every CLI invocation is itself a span, so an armed trace shows the
    # command as the root with load/replay, the operation, and the store
    # write-back attributed beneath it (registration is idempotent)
    with telemetry.span(telemetry.register_span(
            f"cli.{args.cmd}", "one datagit CLI invocation")):
        return _cmd(args, tracer)


def _cmd(args, tracer: Optional[telemetry.Tracer]) -> int:
    try:
        if args.cmd == "lint":
            # pure source analysis: no store, no repo, no device — same
            # runner and exit-code contract as `python -m
            # repro_torch.analysis`
            from .analysis.runner import main as lint_main
            largv: List[str] = list(args.paths)
            if args.format != "text":
                largv += ["--format", args.format]
            if args.baseline:
                largv += ["--baseline", args.baseline]
            if args.write_baseline:
                largv += ["--write-baseline", args.write_baseline]
            if args.verbose:
                largv.append("-v")
            return lint_main(largv)
        try:
            device = resolve_device(args.device)
        except RuntimeError as exc:
            # no card and no --device: say so instead of a traceback
            print(f"error: {exc}", file=sys.stderr)
            return 2
        if args.cmd == "init":
            if os.path.exists(args.store):
                print(f"error: store {args.store} already exists "
                      "(delete it to start fresh)", file=sys.stderr)
                return 2
            save_repo(args.store, Repo(device=device))
            print(f"initialized empty store at {args.store}")
            return 0
        if args.cmd == "clone" and args.ref is None:
            # repo-level clone: `new` is the remote directory and --store
            # names the NEW store — which must not exist yet
            from .store.remote import clone as _repo_clone
            if args.materialize:
                raise ValueError("clone: --materialize is a table-clone "
                                 "flag (repo clones fetch packs instead; "
                                 "use --shallow to skip even that)")
            st = _repo_clone(args.new, args.store, shallow=args.shallow)
            print(f"cloned {args.new} into {args.store}: "
                  f"{st['records']} record(s), "
                  + ("shallow (objects fault in from the origin)"
                     if st["shallow"]
                     else f"{st['objects_fetched']} object(s) fetched"))
            return 0
        if not os.path.exists(args.store):
            # a typo'd --store must not silently create a store elsewhere
            print(f"error: no store at {args.store} — run `init` first "
                  "(or point --store/$VCS_STORE at the right file)",
                  file=sys.stderr)
            return 2
        if args.cmd == "fsck":
            return _cmd_fsck(args, device)
        repo = load_repo(args.store, device)
        if tracer is not None:
            tracer.bind(repo.engine)
        if args.cmd == "seed":
            print(seed_table(repo, args.table, args.rows, args.seed,
                             args.nopk))
        elif args.cmd == "mutate":
            print(mutate_table(repo, args.table, args.rows, args.seed))
        elif args.cmd == "pull":
            # native (not a compiled statement): the CLI supplies the
            # store's pack sidecar and flips the store to refs-mode so
            # subsequent loads import refs instead of replaying data
            st = repo.pull(args.remote, pack_dir=args.store + ".packs")
            if st.get("up_to_date"):
                print(f"pull {args.remote}: already up to date")
            else:
                repo._refs_path = args.store + ".refs"
                repo._refs_origin = repo.engine.store.packs.origin
                print(f"pull {args.remote}: {st['objects_pulled']} "
                      f"object(s), {st['records_pulled']} record(s)")
        elif args.cmd == "fetch":
            st = repo.fetch(args.remote, pack_dir=args.store + ".packs")
            print(f"fetch {args.remote}: {st['objects_pulled']} object(s) "
                  f"({st['bytes_pulled']} bytes)")
        elif args.cmd == "sql":
            checks_failed = False
            for res in execute_script(repo, args.statements):
                print(res.message)
                if res.kind == "check_pr" and any(not c.ok
                                                  for c in res.data):
                    checks_failed = True
            save_repo(args.store, repo)
            # same shell-gateable contract as `dg pr check`: a failing
            # check run exits 1 (after persisting the script's mutations)
            return 1 if checks_failed else 0
        else:
            stmt = _compile(args, repo)
            res = execute(repo, stmt)
            if args.cmd == "stats" and args.format == "json":
                print(json.dumps(res.data, indent=2, sort_keys=True))
            else:
                print(res.message)
            if res.kind == "check_pr" and any(not c.ok for c in res.data):
                # a failing CI check must be shell-gateable:
                # `dg pr check N && deploy` has only the exit code
                return 1
            if args.cmd == "gc":
                # GC is deliberately un-WAL-logged (replay keeps more
                # garbage but identical logical state) — for a WAL-backed
                # store that makes freeing per-process, so say so
                print("note: the store is a replayed WAL — freed objects "
                      "re-materialize on the next load; gc reclaims "
                      "memory for this process only")
        # pr check is read-only too: the preview rolls its oids back and
        # logs nothing, so rewriting the store would be pure wasted I/O
        if args.cmd not in _READ_ONLY and not (
                args.cmd == "pr" and args.pr_cmd == "check"):
            save_repo(args.store, repo)
        return 0
    except (*_TYPED_ERRORS, ValueError, KeyError) as exc:
        msg = exc.args[0] if exc.args else str(exc)
        if isinstance(exc, _TYPED_ERRORS):
            print(f"error: {msg}", file=sys.stderr)
        else:
            # a bare ValueError/KeyError may be a legitimate user error
            # ("branch exists", "PR is closed") OR an internal bug —
            # surface the class so the two are distinguishable
            print(f"error [{type(exc).__name__}]: {msg}", file=sys.stderr)
            if os.environ.get("VCS_DEBUG"):
                raise
        if isinstance(exc, CorruptFrame):
            print("hint: the store has mid-file damage — run "
                  "`datagit fsck --repair` to truncate to the last clean "
                  "frame (damaged bytes preserved to the .corrupt "
                  "sidecar), or restore from a backup", file=sys.stderr)
        suggestions = getattr(exc, "suggestions", ())
        if suggestions:
            print("hint: " + " | ".join(map(str, suggestions)),
                  file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
