"""Workflow porcelain: branch refs, data pull requests, atomic publish, and
Δ-based revert — the team layer over the clone/diff/merge plumbing (paper
§1/§6: "creating branches for isolated experimentation, submitting pull
requests for change review ... published to production in atomic
transactions").

The port's copy of ``repro.core.workspace``; every per-row step runs on
tensors on the engine's device. Design invariants:

* **Branch** = a named set of metadata-only table clones plus the recorded
  branch-point snapshots. Creating/dropping a branch is ONE WAL record; the
  per-table clones are unlogged sub-operations.
* **Pull request** = head branch -> base branch with the base horizon
  *pinned* at open time: review diffs are stable while the base moves on,
  and ``Engine.gc`` keeps both the pinned objects and the PITR history
  entries backing every pin.
* **Atomic publish** = plan-then-commit: every table's merge edits are
  staged on ONE transaction (``merge.plan_merge``) and committed at ONE
  timestamp; any conflict or failing CI check raises before the commit, and
  the two-phase ``Engine._commit`` unwinds seal-time failures — so a
  partial publish is impossible. The WAL carries a single ``publish``
  record.
* **CI checks** run against an *ephemeral isolated preview*: a scratch
  engine on the same device sharing the immutable object store, holding
  metadata clones of the base tables with the PR merged in. On exit every
  preview object is deleted (which notifies the visibility and delta
  caches) and the oid counter rolled back, so previews are invisible to
  the WAL and the live timestamp sequence.
* **Revert** applies the *inverse* signed delta as a NEW commit — history
  is preserved (the published state stays reachable via PITR) and the work
  is ∝ Δ, never ∝ table size. Strict by value: if the current row is no
  longer the one being reverted away, ``RevertConflict`` raises.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import ops
from . import telemetry
from .delta import signed_delta
from .diff import DiffResult, gather_payload, gather_rowsigs, snapshot_diff
from .directory import Snapshot
from .faults import crash_point, register
from .merge import (_NONE, OP_DEL, OP_INS, ConflictMode, MergeConflictError,
                    MergeReport, _seg_min, collapse_pk, plan_merge)
from .refs import (UnknownRefError, require, resolve as resolve_ref,
                   suggest, validate_name)
from .sigs import SigBatch
from .table import Table

CP_TORCH_PUBLISH_PLANNED = register(
    "torch.workspace.publish.planned",
    "after every table's merge is planned but before the multi-table "
    "commit — nothing durable yet, recovery must show no publish")
CP_TORCH_PUBLISH_PRE_LOG = register(
    "torch.workspace.publish.pre_log",
    "after the publish commit swung the live directories but before the "
    "single 'publish' WAL record — the record IS the commit point")
CP_TORCH_REVERT_PUBLISH_PRE_LOG = register(
    "torch.workspace.revert_publish.pre_log",
    "after the inverse-delta commit but before the 'publish_revert' "
    "record — recovery must show the PR still published")
CP_TORCH_REVERT_PRE_LOG = register(
    "torch.workspace.revert.pre_log",
    "after the inverse-delta commit but before the 'revert' record — "
    "recovery must show the revert absent")

SP_PUBLISH = telemetry.register_span(
    "publish", "atomic publish of a PR: checks, per-table planning, one "
    "multi-table commit")
SP_REVERT_PUBLISH = telemetry.register_span(
    "revert_publish", "undo a publish with inverse signed deltas at one "
    "shared timestamp")
SP_REVERT = telemetry.register_span(
    "revert", "one-table inverse-Δ revert applied as a new commit")

TRUNK = "main"


class RevertConflict(Exception):
    """The current state no longer carries the change being reverted."""


class PublishBlocked(Exception):
    """Publish refused: one or more CI checks failed (or the merge preview
    itself conflicted). ``checks`` holds every CheckResult of the run."""

    def __init__(self, pr: "PullRequest", checks: List["CheckResult"]):
        failed = [c.name for c in checks if not c.ok]
        super().__init__(
            f"PR #{pr.id} {pr.head_name}->{pr.base_name}: "
            f"{len(failed)} failing check(s): {', '.join(failed)}")
        self.pr = pr
        self.checks = checks


@dataclass
class CheckResult:
    name: str
    ok: bool
    error: Optional[str] = None
    # True only for the synthetic result run_checks emits when the merge
    # preview itself conflicts: publish routes it to MergeConflictError,
    # and a user check named "merge" must not be mistaken for it
    synthetic: bool = False


@dataclass
class Branch:
    """A named set of metadata-only clones + their branch-point snapshots."""
    name: str
    tables: Dict[str, str]        # logical name -> physical table name
    base: Dict[str, Snapshot]     # logical name -> branch-point snapshot
    parent: Optional[str]         # parent branch name (None = trunk)
    created_ts: int

    def physical(self, logical: str) -> str:
        return self.tables[logical]


# --------------------------------------------------------------------------
# branch refs
# --------------------------------------------------------------------------

def branch_table_name(branch: str, logical: str) -> str:
    return f"{branch}/{logical}"


def resolve_branch(engine, name: Optional[str]) -> Branch:
    """A registered branch, or the synthesized trunk view (physical ==
    logical over the engine's plain tables). UnknownRefError otherwise."""
    if name in (None, TRUNK) and TRUNK not in engine.branches:
        # index aux tables are internal: branching one as a first-class
        # table would orphan it
        aux = {spec.aux_table for specs in engine.indices.values()
               for spec in specs}
        plain = {n: n for n in engine.tables
                 if "/" not in n and n not in aux}
        return Branch(TRUNK, plain, {}, None, 0)
    name = name if name is not None else TRUNK
    return require(engine.branches, name, "branch", f"branch:{name}")


def create_branch(engine, name: str, tables: Sequence[str],
                  from_ref: Optional[str] = None, *, _log=True) -> Branch:
    """Clone ``tables`` under the ``name/`` namespace in one WAL-logged
    operation, recording the branch-point snapshot per table."""
    if _log:
        validate_name(name, "branch name")
    if not name or name == TRUNK or "/" in name:
        raise ValueError(f"invalid branch name {name!r}")
    if name in engine.branches:
        raise ValueError(f"branch {name} exists")
    tables = tuple(tables)
    if from_ref in (None, TRUNK):
        parent, src = None, {lg: lg for lg in tables}
    else:
        parent_branch = resolve_branch(engine, from_ref)
        parent = from_ref
        src = {}
        for lg in tables:
            if lg not in parent_branch.tables:
                raise UnknownRefError(
                    lg, f"branch {from_ref!r} has no table {lg!r}",
                    suggest(lg, parent_branch.tables))
            src[lg] = parent_branch.physical(lg)
    for lg in tables:
        require(engine.tables, src[lg], "table")
        if branch_table_name(name, lg) in engine.tables:
            raise ValueError(f"table {branch_table_name(name, lg)} exists")
    mapping, bases = {}, {}
    for lg in tables:
        snap = engine.current_snapshot(src[lg])
        phys = branch_table_name(name, lg)
        engine.clone_table(phys, snap, _log=False)
        mapping[lg] = phys
        bases[lg] = snap
    br = Branch(name, mapping, bases, parent, engine.ts)
    engine.branches[name] = br
    if _log:
        engine.wal.append("create_branch", name=name, tables=tables,
                          from_ref=parent)
    return br


def drop_branch(engine, name: str, *, _log=True) -> None:
    br = require(engine.branches, name, "branch", f"branch:{name}")
    # open PRs still need the branch for review/publish; published-but-not
    # -closed PRs still need it for revert_publish
    holders = [pr.id for pr in engine.prs.values()
               if pr.status in ("open", "published")
               and name in (pr.base_name, pr.head_name)]
    if holders:
        raise ValueError(f"branch {name} is referenced by live PR(s) "
                         f"{holders}; close or revert them first")
    for phys in br.tables.values():
        if phys in engine.tables:
            engine.drop_table(phys, _log=False)
    del engine.branches[name]
    if _log:
        engine.wal.append("drop_branch", name=name)


# --------------------------------------------------------------------------
# pull requests
# --------------------------------------------------------------------------

class CheckContext:
    """Read view a CI check gets: the ephemeral merged preview tables."""

    def __init__(self, engine, tables: Dict[str, str]):
        self.engine = engine
        self.tables = tables            # logical -> preview physical

    def table(self, logical: str) -> Table:
        return self.engine.table(self.tables[logical])

    def scan(self, logical: str):
        return self.table(logical).scan()

    def count(self, logical: str) -> int:
        return self.table(logical).count()


class PullRequest:
    """A data pull request: merge ``head`` branch into ``base``.

    The base horizon is pinned at open time (review stability + GC pin);
    ``publish`` lands every table at one commit timestamp or not at all."""

    def __init__(self, engine, pr_id: int, base_name: str, head_name: str):
        self.engine = engine
        self.id = pr_id
        self.base_name = base_name
        self.head_name = head_name
        head = engine.branches[head_name]
        self.tables: Dict[str, str] = dict(head.tables)
        base_branch = resolve_branch(engine, base_name)
        for lg in self.tables:
            if lg not in base_branch.tables:
                raise UnknownRefError(
                    lg, f"base branch {base_name!r} has no table {lg!r}",
                    suggest(lg, base_branch.tables))
        # pinned base horizon: review is against the base AS OF open time
        self.base_pins: Dict[str, Snapshot] = {
            lg: engine.current_snapshot(self._base_physical(lg))
            for lg in self.tables}
        self.checks: List[Tuple[str, Callable]] = []
        self.status = "open"            # open | published | reverted | closed
        self.publish_ts: Optional[int] = None
        self.pre_publish: Dict[str, Snapshot] = {}
        self.post_publish: Dict[str, Snapshot] = {}
        self.publish_reports: Dict[str, MergeReport] = {}

    # ------------------------------------------------------------ helpers
    def _base_physical(self, logical: str) -> str:
        return resolve_branch(self.engine, self.base_name).physical(logical)

    def _merge_base(self, logical: str) -> Optional[Snapshot]:
        """Three-way base: lineage first (kept fresh by publishes), falling
        back to the head branch's recorded branch point."""
        base = self.engine.find_common_base(self._base_physical(logical),
                                            self.tables[logical])
        if base is None:
            base = self.engine.branches[self.head_name].base.get(logical)
        return base

    # ------------------------------------------------------------- review
    def diff(self) -> Dict[str, DiffResult]:
        """Per-table review diff: pinned base horizon vs head current.
        Repeated review rounds are served by the delta cache."""
        return {lg: snapshot_diff(self.engine.store, self.base_pins[lg],
                                  self.engine.current_snapshot(phys))
                for lg, phys in self.tables.items()}

    def dry_run_merge(self, mode: ConflictMode = ConflictMode.FAIL
                      ) -> Dict[str, MergeReport]:
        """Plan every table's merge into a discarded transaction: the full
        conflict report with zero mutation (no objects sealed, no commit)."""
        reports = {}
        for lg, phys in self.tables.items():
            report = MergeReport()
            base = self._merge_base(lg)
            report.used_base = base is not None
            tx = self.engine.begin()    # discarded: plan-only
            try:
                plan_merge(self.engine, self._base_physical(lg),
                           self.engine.current_snapshot(phys), base, mode,
                           report, tx)
            except MergeConflictError as exc:
                report = exc.report
            reports[lg] = report
        return reports

    # ----------------------------------------------------------- CI gates
    def add_check(self, fn: Callable, name: Optional[str] = None) -> None:
        """Register a CI check. ``fn(ctx)`` sees the merged preview via a
        CheckContext; returning falsy (other than None) or raising fails."""
        self.checks.append((name or getattr(fn, "__name__", "check"), fn))

    @contextlib.contextmanager
    def _merged_preview(self, mode: ConflictMode):
        """Ephemeral isolated clone of the base tables with this PR merged
        in, on the live engine's device. Shares the immutable object store;
        on exit every object sealed for the preview is deleted and the oid
        counter rolled back, so the preview never perturbs the WAL or the
        timestamp sequence."""
        from .engine import Engine
        engine = self.engine
        store = engine.store
        oid0 = store._next_oid
        scratch = Engine(device=engine.device)
        scratch.store = store
        scratch.ts = engine.ts
        mapping: Dict[str, str] = {}
        merge_err: Optional[MergeConflictError] = None
        try:
            for lg in self.tables:
                t_src = engine.table(self._base_physical(lg))
                t = Table(lg, t_src.schema, store, t_src.directory.ts)
                t.directory = t_src.directory
                t.history = [(t_src.directory.ts, t_src.directory)]
                scratch.tables[lg] = t
                mapping[lg] = lg
            tx = scratch.begin()
            try:
                for lg, phys in self.tables.items():
                    plan_merge(scratch, lg,
                               engine.current_snapshot(phys),
                               self._merge_base(lg), mode, MergeReport(), tx)
                if tx.staged:
                    tx.commit(_log=False)
            except MergeConflictError as exc:
                merge_err = exc
            yield scratch, mapping, merge_err
        finally:
            for oid in range(oid0, store._next_oid):
                if store.has(oid):
                    store.delete(oid)
            store._next_oid = oid0

    def run_checks(self, mode: ConflictMode = ConflictMode.FAIL
                   ) -> List[CheckResult]:
        """Run every registered check against the ephemeral merged preview."""
        results: List[CheckResult] = []
        with self._merged_preview(mode) as (scratch, mapping, merge_err):
            if merge_err is not None:
                return [CheckResult(
                    "merge", False,
                    f"{merge_err.report.true_conflicts} true conflict(s)",
                    synthetic=True)]
            ctx = CheckContext(scratch, mapping)
            for name, fn in self.checks:
                try:
                    ok = fn(ctx)
                    ok = True if ok is None else bool(ok)
                    results.append(CheckResult(
                        name, ok, None if ok else "check returned falsy"))
                except Exception as exc:       # a failing check, not a bug
                    results.append(CheckResult(
                        name, False, f"{type(exc).__name__}: {exc}"))
        return results

    # ------------------------------------------------------------ publish
    def publish(self, mode: ConflictMode = ConflictMode.FAIL, *,
                _log=True, _skip_checks=False) -> Dict[str, MergeReport]:
        """Merge every table of the PR into the base branch atomically.

        Order of gates: CI checks (ephemeral preview) -> per-table merge
        planning (conflicts raise with nothing staged) -> ONE multi-table
        commit at ONE timestamp (two-phase, unwinds on seal-time failure).
        The WAL carries a single replayable ``publish`` record; replay
        re-applies it with ``_skip_checks=True`` (checks are in-process
        callables and were already run live)."""
        with telemetry.span(SP_PUBLISH):
            return self._publish(mode, _log, _skip_checks)

    def _publish(self, mode: ConflictMode, _log: bool,
                 _skip_checks: bool) -> Dict[str, MergeReport]:
        if self.status != "open":
            raise ValueError(f"PR #{self.id} is {self.status}, not open")
        engine = self.engine
        if self.checks and not _skip_checks:
            results = self.run_checks(mode)
            # a conflicting preview (the synthetic result) falls through to
            # planning below, which raises the genuine MergeConflictError
            # with the full report
            if any(not r.ok and not r.synthetic for r in results):
                raise PublishBlocked(self, results)
        pre = {lg: engine.current_snapshot(self._base_physical(lg))
               for lg in self.tables}
        tx = engine.begin()
        planned: Dict[str, Tuple[MergeReport, Snapshot]] = {}
        for lg, phys in self.tables.items():
            report = MergeReport()
            base = self._merge_base(lg)
            report.used_base = base is not None
            src = engine.current_snapshot(phys)
            plan_merge(engine, self._base_physical(lg), src, base, mode,
                       report, tx)
            planned[lg] = (report, src)
        crash_point(CP_TORCH_PUBLISH_PLANNED)
        with engine.op_kind("publish"):
            ts = tx.commit(_log=False) if tx.staged else None
        for lg, (report, src) in planned.items():
            report.commit_ts = ts
            target = self._base_physical(lg)
            if src.table != target and src.table in engine.tables:
                engine.set_common_base(target, src.table, src)
        self.status = "published"
        self.publish_ts = ts
        self.pre_publish = pre
        self.post_publish = {
            lg: engine.current_snapshot(self._base_physical(lg))
            for lg in self.tables}
        self.publish_reports = {lg: r for lg, (r, _) in planned.items()}
        if _log:
            crash_point(CP_TORCH_PUBLISH_PRE_LOG)
            engine.wal.append("publish", pr=self.id, mode=mode.value, ts=ts)
        return self.publish_reports

    def revert_publish(self, *, _log=True) -> Optional[int]:
        """Undo this PR's publish with inverse signed deltas: every base
        table gets the Δ(post -> pre) applied as a NEW commit at one shared
        timestamp. History-preserving and Δ-sized."""
        with telemetry.span(SP_REVERT_PUBLISH):
            if self.status != "published":
                raise ValueError(f"PR #{self.id} is {self.status}, "
                                 "not published")
            engine = self.engine
            tx = engine.begin()
            for lg in self.tables:
                plan_revert(engine, self._base_physical(lg),
                            self.pre_publish[lg], self.post_publish[lg], tx)
            with engine.op_kind("revert-publish"):
                ts = tx.commit(_log=False) if tx.staged else None
            self.status = "reverted"
            if _log:
                crash_point(CP_TORCH_REVERT_PUBLISH_PRE_LOG)
                engine.wal.append("publish_revert", pr=self.id, ts=ts)
            return ts

    def close(self, *, _log=True) -> None:
        """Abandon an open PR, or release a published PR's pins."""
        if self.status not in ("open", "published"):
            raise ValueError(f"PR #{self.id} is already {self.status}")
        self.status = "closed"
        if _log:
            self.engine.wal.append("close_pr", pr=self.id)


def open_pr(engine, base: Optional[str], head: str, *,
            _log=True) -> PullRequest:
    """Open a pull request merging branch ``head`` into ``base`` (None or
    "main" = the trunk tables). Pins the base horizon."""
    require(engine.branches, head, "branch", f"branch:{head}")
    base_name = base if base is not None else TRUNK
    if base_name != TRUNK:
        require(engine.branches, base_name, "branch",
                f"branch:{base_name}")
    if base_name == head:
        raise ValueError("PR base and head are the same branch")
    pr = PullRequest(engine, engine._next_pr_id, base_name, head)
    engine._next_pr_id += 1
    engine.prs[pr.id] = pr
    if _log:
        engine.wal.append("open_pr", pr=pr.id, base=base_name, head=head)
    return pr


# --------------------------------------------------------------------------
# Δ-based revert
# --------------------------------------------------------------------------

def plan_revert(engine, table: str, from_snap: Snapshot, to_snap: Snapshot,
                tx) -> bool:
    """Stage the inverse of Δ(from -> to) against ``table``'s CURRENT state.

    Strict by value: a row the revert would delete must still carry the
    to-side value (by 128-bit row signature), and a key it would re-insert
    must not have been re-taken since — otherwise ``RevertConflict``.
    Returns True iff anything was staged. Every step is Δ-sized; the
    guards read one flag each from the device."""
    t = engine.table(table)
    if not (t.schema.compatible_with(from_snap.schema)
            and t.schema.compatible_with(to_snap.schema)):
        raise ValueError("revert: incompatible schemas")
    # the inverse shares every tensor but its signs with the (possibly
    # cached) stream: nothing below writes into them
    inv = signed_delta(engine.store, from_snap.directory,
                       to_snap.directory).inverse()
    if inv.n == 0:
        return False
    store = engine.store
    if t.schema.has_pk:
        # per key: − rows are the to-side state to remove, + rows the
        # from-side state to restore (collapse drops pure moves)
        ch, _ = collapse_pk(inv)
        needs_del = ch.op != OP_INS
        rid = t.locate_keys(ch.key_lo[needs_del], ch.key_hi[needs_del])
        gone = rid == 0
        if bool(gone.any()):
            raise RevertConflict(
                f"{table}: {int(gone.sum())} reverted key(s) no "
                "longer present")
        cur_lo, cur_hi = gather_rowsigs(store, rid)
        exp_lo, exp_hi = gather_rowsigs(store, ch.minus_rowid[needs_del])
        moved = (cur_lo != exp_lo) | (cur_hi != exp_hi)
        if bool(moved.any()):
            raise RevertConflict(
                f"{table}: {int(moved.sum())} key(s) changed since the "
                "reverted state")
        re_ins = ch.op == OP_INS       # key was deleted from->to: restore it
        if bool(re_ins.any()):
            back = t.locate_keys(ch.key_lo[re_ins], ch.key_hi[re_ins])
            taken = back != 0
            if bool(taken.any()):
                raise RevertConflict(
                    f"{table}: {int(taken.sum())} reverted key(s) "
                    "re-taken since")
        if rid.shape[0]:
            tx.delete_rowids(table, rid)
        ins_rowids = ch.plus_rowid[ch.op != OP_DEL]
        if ins_rowids.shape[0]:
            # ch is key-sorted and the mask preserves order: one run —
            # lint: runs-ok a mask of the key-sorted collapsed change set
            runs = SigBatch.sorted_run()
            payload, sigs = gather_payload(store, t.schema, ins_rowids,
                                           with_sigs=True, runs=runs)
            # lint: runs-ok signatures gathered verbatim from sealed objects
            tx.insert(table, payload, sigs=sigs)
        return bool(rid.shape[0] or ins_rowids.shape[0])
    # NoPK: per value group, net > 0 restores copies of the from-side
    # value, net < 0 deletes that many visible duplicates
    s = inv.merge_by_key()
    _, agg = ops.diff_aggregate(s.row_lo, s.row_hi, s.sign, presorted=True)
    starts = agg.run_starts
    nets = agg.run_sums.to(torch.int64)     # widen before negating/summing
    pos = torch.arange(s.n, dtype=torch.int64, device=s.sign.device)
    first_plus = _seg_min(torch.where(s.sign > 0, pos, _NONE), agg.run_ids,
                          starts.shape[0])
    ins_g = torch.nonzero(nets > 0).flatten()
    del_g = torch.nonzero(nets < 0).flatten()
    staged = False
    if del_g.shape[0]:
        need = -nets[del_g]
        g = starts[del_g]
        rids = t.locate_rowsig_multi(s.row_lo[g], s.row_hi[g], need,
                                     flat=True)
        short = int(need.sum()) - int(rids.shape[0])
        if short:
            raise RevertConflict(
                f"{table}: {short} reverted row(s) no longer present")
        tx.delete_rowids(table, rids)
        staged = True
    if ins_g.shape[0]:
        rep = s.rowid[first_plus[ins_g].clamp(max=s.n - 1)]
        ins_rowids = torch.repeat_interleave(rep, nets[ins_g])
        # groups ascend in value(=key) order and repeats are adjacent:
        # lint: runs-ok the rowid sequence is one key-sorted run
        runs = SigBatch.sorted_run()
        payload, sigs = gather_payload(store, t.schema, ins_rowids,
                                       with_sigs=True, runs=runs)
        # lint: runs-ok signatures gathered verbatim from sealed objects
        tx.insert(table, payload, sigs=sigs)
        staged = True
    return staged


def revert(engine, table: str, from_ref, to_ref, *,
           _log=True) -> Optional[int]:
    """``engine.revert``: one-table inverse-Δ revert as a new commit.
    Refs resolve against ``table`` (so ts:/HEAD/~n forms work); returns
    the commit ts (None when Δ(from -> to) is empty)."""
    with telemetry.span(SP_REVERT):
        require(engine.tables, table, "table")
        from_snap = resolve_ref(engine, from_ref, table=table).snapshot
        to_snap = resolve_ref(engine, to_ref, table=table).snapshot
        tx = engine.begin()
        staged = plan_revert(engine, table, from_snap, to_snap, tx)
        with engine.op_kind("revert"):
            ts = tx.commit(_log=False) if staged else None
        if _log:
            crash_point(CP_TORCH_REVERT_PRE_LOG)
            engine.wal.append("revert", table=table, snap_from=from_snap,
                              snap_to=to_snap, ts=ts)
        return ts
