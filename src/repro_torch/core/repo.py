"""The ``Repo`` facade: every porcelain verb, on refs.

One object, one resolver, one verb set — the Python twin of the statement
surface (``core.statements``) and the CLI (``repro.vcs_cli``). Every way to
name a version goes through ``Repo.resolve`` (one grammar, typed errors);
every verb maps 1:1 onto a statement and a CLI subcommand:

    ==============  ============================  =====================
    Repo method     statement                     CLI
    ==============  ============================  =====================
    branch          CREATE BRANCH d FROM m FOR..  branch d -t t ...
    drop_branch     DROP BRANCH d                 branch -d d
    tag             CREATE SNAPSHOT s FOR TABLE   snapshot s t
    drop_tag        DROP SNAPSHOT s               snapshot -d s
    clone           CLONE TABLE new FROM 'ref'    clone new ref
    diff            DIFF 'a' AGAINST 'b'          diff a b
    merge           MERGE BRANCH d INTO m MODE x  merge d m --mode x
    open_pr         OPEN PR FROM d INTO m         pr open d --into m
    check           CHECK PR n                    pr check n
    publish         PUBLISH PR n MODE x           publish n --mode x
    revert_pr       REVERT PR n                   revert-pr n
    close_pr        CLOSE PR n                    pr close n
    revert          REVERT TABLE t FROM 'a' TO    revert t a b
    restore         RESTORE TABLE t TO 'ref'      restore t ref
    log             LOG TABLE t [LIMIT n]         log t [-n N]
    status          STATUS                        status
    gc              GC                            gc
    fsck            FSCK [REPAIR]                 fsck [--repair]
    push            PUSH TO 'dir'                 push dir
    pull            PULL FROM 'dir'               pull dir
    fetch           FETCH FROM 'dir'              fetch dir
    (clone repo)    —                             clone new-store dir
    ==============  ============================  =====================

The facade is thin by design: verbs delegate to the engine/workspace layer
(which owns WAL logging and replay), so a statement-driven session and a
Repo-driven session write the same WAL. ``Repo()`` builds ``Engine()``,
which runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from . import telemetry
from .directory import Snapshot
from .diff import DiffResult, snapshot_diff
from .engine import CommitRecord, Engine, GCStats
from .merge import ConflictMode, MergeReport, plan_merge
from .refs import (Ref, RefLike, RefSyntaxError, ResolvedRef,
                   as_branch, parse_ref, resolve)

#: accepted spellings of each conflict mode (statement MODE / --mode)
MODE_ALIASES = {
    "fail": ConflictMode.FAIL,
    "skip": ConflictMode.SKIP, "ours": ConflictMode.SKIP,
    "accept": ConflictMode.ACCEPT, "theirs": ConflictMode.ACCEPT,
    "cell": ConflictMode.CELL,
}


def parse_mode(mode: Union[str, ConflictMode, None]) -> ConflictMode:
    if mode is None:
        return ConflictMode.FAIL
    if isinstance(mode, ConflictMode):
        return mode
    m = MODE_ALIASES.get(str(mode).lower())
    if m is None:
        raise ValueError(
            f"unknown conflict mode {mode!r} "
            f"(one of {', '.join(sorted(MODE_ALIASES))})")
    return m


class Repo:
    """Facade over :class:`Engine`: the full VCS verb set on refs.

    Data-plane DML (schemas, inserts, updates) stays on ``repo.engine`` —
    the facade adds exactly the version-control porcelain."""

    def __init__(self, engine: Optional[Engine] = None, **engine_kw):
        self.engine = engine if engine is not None else Engine(**engine_kw)

    # ------------------------------------------------------------ resolve
    def resolve(self, ref: RefLike,
                table: Optional[str] = None) -> ResolvedRef:
        """Resolve any ref form to ``ResolvedRef(table_physical, Snapshot)``
        — the single naming path behind every verb below."""
        return resolve(self.engine, ref, table)

    # ------------------------------------------------- data-plane sugar
    def create_table(self, name, schema, **kw):
        return self.engine.create_table(name, schema, **kw)

    def drop_table(self, name, **kw):
        return self.engine.drop_table(name, **kw)

    def table(self, name):
        return self.engine.table(name)

    def insert(self, table, batch):
        return self.engine.insert(table, batch)

    def update_by_keys(self, table, batch):
        return self.engine.update_by_keys(table, batch)

    def delete_by_keys(self, table, key_batch):
        return self.engine.delete_by_keys(table, key_batch)

    # ----------------------------------------------------- branches/tags
    def branch(self, name: str, tables: Optional[Sequence[str]] = None,
               from_ref: Optional[str] = None):
        """CREATE BRANCH name [FROM ref] [FOR (tables)] — tables default to
        every table of the source branch (trunk: every plain table)."""
        from .refs import BranchRef
        from .workspace import TRUNK
        src_name = self._branch_name(from_ref)
        if tables is None:
            # branch-only position: BranchRef skips bare-name ambiguity
            # (a table named "main" must not block repo.branch("dev"))
            br = as_branch(self.engine, BranchRef(src_name or TRUNK))
            tables = sorted(br.tables)
        return self.engine.create_branch(name, tables, src_name)

    def drop_branch(self, name: str) -> None:
        self.engine.drop_branch(self._branch_name(name))

    def branches(self) -> list:
        """(name, created_ts, logical tables) rows, name-sorted."""
        return [(b.name, b.created_ts, tuple(sorted(b.tables)))
                for b in self.engine.list_branches()]

    def tag(self, name: str, table_ref: RefLike) -> Snapshot:
        """CREATE SNAPSHOT name — tag the current head of a table.

        Only heads are taggable: the WAL ``snapshot`` record captures
        (name, table) and replay re-derives the directory from the live
        state, so tagging a historical horizon would not survive replay.
        Clone the historical ref instead."""
        if isinstance(table_ref, str) and table_ref in self.engine.tables:
            return self.engine.create_snapshot(name, table_ref)
        rr = self.resolve(table_ref)
        head = self.engine.table(rr.table).directory
        d = rr.snapshot.directory
        # head-ness by content (object sets), not object identity: a
        # restore rebuilds the head Directory from the same oids
        if (d.data_oids, d.tomb_oids) != (head.data_oids, head.tomb_oids):
            text = rr.ref.format() if rr.ref is not None else str(table_ref)
            raise ValueError(
                f"tag: {text} is not the current head — only heads can be "
                "tagged (CLONE the historical ref instead)")
        return self.engine.create_snapshot(name, rr.table)

    def drop_tag(self, name: str) -> None:
        self.engine.drop_snapshot(name)

    def snapshots(self) -> list:
        """(name, table, created_ts) rows, oldest first."""
        return self.engine.list_snapshots()

    # ------------------------------------------------------- clone/restore
    def clone(self, new_name: str, ref: RefLike, *,
              materialize: bool = False, with_indices: bool = False):
        """CLONE TABLE new FROM 'ref' — metadata-only unless materialized."""
        return self.engine.clone_table(new_name, ref,
                                       materialize=materialize,
                                       with_indices=with_indices)

    def restore(self, table: str, ref: RefLike) -> None:
        """RESTORE TABLE t TO 'ref' — git reset --hard (head rewrite; use
        :meth:`revert` for the history-preserving inverse-Δ form)."""
        self.engine.restore_table(table, ref)

    # --------------------------------------------------------------- diff
    def diff(self, a: RefLike, b: RefLike,
             table: Optional[str] = None) -> DiffResult:
        """SNAPSHOT DIFF between two refs: negative groups only in ``a``,
        positive only in ``b``. ``table`` is the context for table-less
        forms (HEAD, ts:, branch refs)."""
        ra = self.resolve(a, table)
        rb = self.resolve(b, table)
        return snapshot_diff(self.engine.store, ra.snapshot, rb.snapshot)

    # -------------------------------------------------------------- merge
    def merge(self, src: RefLike, into: RefLike,
              mode: Union[str, ConflictMode, None] = None,
              tables: Optional[Sequence[str]] = None):
        """MERGE 'src' INTO 'into'.

        Branch into branch: every shared table (or ``tables``) is planned
        onto ONE transaction and lands at ONE commit timestamp — the same
        all-or-nothing property as PR publish; returns {table: MergeReport}.
        Otherwise ``into`` names a table and ``src`` any snapshot ref;
        returns one MergeReport (lineage supplies the three-way base)."""
        from .merge import three_way_merge
        mode = parse_mode(mode)
        engine = self.engine
        src_br = as_branch(engine, src)
        # the into-position prefers an exact table name (same rule as
        # _table_name): "INTO TABLE x" must stay resolvable when a branch
        # shares the name — branch intent is spelled branch:x
        dst_br = (None if isinstance(into, str) and into in engine.tables
                  else as_branch(engine, into))
        if src_br is not None and dst_br is not None:
            logicals = (sorted(set(src_br.tables) & set(dst_br.tables))
                        if tables is None else list(tables))
            # structural conflicts between two refs that both EXIST are
            # ValueError, not UnknownRefError — `except KeyError` callers
            # probing for missing refs must not swallow them
            if not logicals:
                # silent no-op here would read as "merge happened"
                raise ValueError(
                    f"branches {src_br.name!r} and {dst_br.name!r} "
                    "share no tables — nothing to merge")
            for lg in logicals:
                if lg not in src_br.tables or lg not in dst_br.tables:
                    raise ValueError(
                        f"table {lg!r} is not on both branches "
                        f"{src_br.name!r} and {dst_br.name!r}")
            # Sibling of PullRequest.publish's atomic protocol (plan every
            # table onto ONE tx, commit at ONE ts) — kept separate because
            # the WAL semantics differ on purpose: publish is one
            # replayable record with unlogged sub-commits, while a branch
            # merge replays from its plainly-logged commit records. Keep
            # the two in sync when touching either.
            tx = engine.begin()
            planned: Dict[str, tuple] = {}
            for lg in logicals:
                target = dst_br.tables[lg]
                src_snap = engine.current_snapshot(src_br.tables[lg])
                base = (engine.find_common_base(target, src_snap.table)
                        or src_br.base.get(lg))
                report = MergeReport(used_base=base is not None)
                plan_merge(engine, target, src_snap, base, mode, report, tx)
                planned[lg] = (report, src_snap, target)
            with engine.op_kind("merge"):
                ts = tx.commit() if tx.staged else None
            out = {}
            for lg, (report, src_snap, target) in planned.items():
                report.commit_ts = ts
                if src_snap.table != target and src_snap.table in engine.tables:
                    engine.set_common_base(target, src_snap.table, src_snap)
                    engine.wal.append("set_base", a=target, b=src_snap.table,
                                      snap=src_snap)
                out[lg] = report
            return out
        target = self._table_name(into)
        src_snap = self.resolve(src, table=target).snapshot
        return three_way_merge(engine, target, src_snap, mode=mode)

    # ------------------------------------------------------ pull requests
    def open_pr(self, head: RefLike, base: Optional[RefLike] = None):
        """OPEN PR FROM head [INTO base] (base defaults to the trunk)."""
        return self.engine.open_pr(self._branch_name(base),
                                   self._branch_name(head))

    def pr(self, pr_id: int):
        from .refs import _pr
        return _pr(self.engine, int(pr_id), f"pr:{pr_id}")

    def check(self, pr_id: int, mode=None) -> list:
        """CHECK PR n — run the PR's CI checks against the ephemeral merged
        preview (a conflicting preview surfaces as one synthetic failure)."""
        return self.pr(pr_id).run_checks(parse_mode(mode))

    def publish(self, pr_id: int, mode=None) -> Dict[str, MergeReport]:
        return self.pr(pr_id).publish(mode=parse_mode(mode))

    def revert_pr(self, pr_id: int) -> Optional[int]:
        return self.pr(pr_id).revert_publish()

    def close_pr(self, pr_id: int) -> None:
        self.pr(pr_id).close()

    # ------------------------------------------------------------- revert
    def revert(self, table_ref: RefLike, from_ref: RefLike,
               to_ref: RefLike) -> Optional[int]:
        """REVERT TABLE t FROM 'a' TO 'b' — apply inverse Δ(a -> b) as a
        new commit (history-preserving, Δ-sized, strict by value)."""
        return self.engine.revert(self._table_name(table_ref),
                                  from_ref, to_ref)

    # ---------------------------------------------------------------- log
    def log(self, table_ref: RefLike,
            limit: Optional[int] = None) -> List[CommitRecord]:
        """LOG TABLE t — commit history of one table, newest first.

        Every entry is a :class:`CommitRecord` (ts, op kind, rows
        inserted/deleted) appended by the engine at apply time and
        reproduced identically by WAL replay."""
        table = self._table_name(table_ref)
        out = [r for r in reversed(self.engine.commit_log)
               if r.table == table]
        return out[:limit] if limit is not None else out

    # ------------------------------------------------------------- status
    def status(self) -> dict:
        """One deterministic summary of the repo: tables (head ts, retained
        versions), branches, snapshots, PRs, and the full telemetry
        registry snapshot (every registered counter, zeros included — the
        zero-rehash invariant is inspectable without a debugger), the
        crc32c implementation and the store's tier occupancy."""
        from .wal import CRC32C_IMPL
        e = self.engine
        st = e.store
        return {
            "ts": e.ts,
            "tables": [(n, e.tables[n].directory.ts,
                        len(e.tables[n].history))
                       for n in sorted(e.tables)],
            "branches": self.branches(),
            "snapshots": self.snapshots(),
            "prs": [(i, p.base_name, p.head_name, p.status)
                    for i, p in sorted(e.prs.items())],
            # integrity backend: which crc32c does the framing — the
            # pure-python fallback is ~100x slower and should be visible
            "crc32c": CRC32C_IMPL,
            "store": {
                "resident": len(st._objects),
                "packed": len(st._packed),
                "packs": st.packs.root if st.packs is not None else None,
            },
            "metrics": dict(sorted(self.stats().items())),
        }

    # -------------------------------------------------------- telemetry
    def trace(self):
        """``with repo.trace() as t:`` — arm the span tracer for the block;
        ``t.roots`` holds the span forest afterwards (see
        :mod:`core.telemetry`)."""
        return telemetry.trace(self.engine)

    def stats(self) -> Dict[str, int]:
        """Snapshot of every registered metric (stable key set — the
        ``datagit stats`` schema)."""
        return telemetry.metrics_snapshot(self.engine)

    # ------------------------------------------------------------ remotes
    def push(self, remote: str) -> dict:
        """PUSH TO 'dir' — ship missing pack objects + the WAL to a remote
        directory and swing its refs (fast-forward only)."""
        from ..store.remote import push as _push
        return _push(self.engine, remote)

    def fetch(self, remote: str, pack_dir: Optional[str] = None) -> dict:
        """FETCH FROM 'dir' — copy missing pack objects locally without
        changing any repo state (warm-up for shallow clones and pulls)."""
        from ..store.remote import fetch as _fetch
        return _fetch(self.engine, remote, pack_dir)

    def pull(self, remote: str, pack_dir: Optional[str] = None) -> dict:
        """PULL FROM 'dir' — fast-forward this repo to the remote's state,
        fetching only missing objects; swaps ``self.engine`` (same
        device). Carried signatures are imported verbatim
        (``rows_rehashed`` stays 0)."""
        from ..store.remote import pull as _pull
        self.engine, stats = _pull(self.engine, remote, pack_dir)
        return stats

    # ----------------------------------------------------------------- gc
    def gc(self) -> GCStats:
        return self.engine.gc()

    def fsck(self, *, sample: float = 1.0, check_replay: bool = True,
             repair: bool = False):
        """FSCK [REPAIR] — verify carried signatures, reachability, refs,
        packs and WAL-replay equivalence; ``repair`` quarantines and
        rebuilds (see :func:`core.fsck.fsck`). Returns an
        :class:`FsckReport`."""
        from .fsck import fsck as _fsck
        return _fsck(self.engine, sample=sample, check_replay=check_replay,
                     repair=repair)

    # ------------------------------------------------------------ helpers
    def _table_name(self, ref: RefLike) -> str:
        """Resolve a TABLE-position argument: an exact table name wins
        outright (``LOG TABLE orders`` must not go ambiguous because a
        snapshot shares the name); anything else takes the ref resolver."""
        if isinstance(ref, str) and ref in self.engine.tables:
            return ref
        return self.resolve(ref).table

    def _branch_name(self, ref: Optional[RefLike]) -> Optional[str]:
        """Branch NAME from a ref ('dev' / 'branch:dev'); None passes."""
        if ref is None:
            return None
        from .refs import BareRef, BranchRef
        r = parse_ref(ref) if isinstance(ref, str) else ref
        if isinstance(r, (BranchRef, BareRef)):
            return r.name
        raise RefSyntaxError(
            r.format() if isinstance(r, Ref) else str(ref),
            "expected a branch name ref (dev / branch:dev)")
