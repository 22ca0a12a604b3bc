"""SNAPSHOT MERGE (paper §3, §5.2, §5.3).

Three-way merge of a source snapshot into the *current* version of a
target table, with an explicit or implicit (lineage) common base
revision, or with an empty base when none exists (§5.3). Conflict modes:
FAIL / SKIP (keep target's version) / ACCEPT (take source's version) /
CELL (beyond the paper: column-wise auto-merge of update-vs-update).

Implementation follows §5.2:
  1. signed Δ streams of each branch vs. the base (cost ∝ changed data),
  2. per-branch collapse per key: DEL / INS / UPD, with *move* detection,
  3. cancellation of identical changes across branches,
  4. residual keys changed by both branches = true conflicts;
     single-branch keys = false conflicts, auto-applied,
  5. all edits applied to the target in ONE transaction.

NoPK tables use the §3 cardinality rules (δ arithmetic per value group)
on the residuals after cancellation. Every per-row step runs on tensors
on the store's device; the segmented reductions of the reference
(``reduceat``) become scatter reductions over run ids.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import telemetry
from .delta import DeltaStats, SignedStream, signed_delta
from .diff import gather_payload
from .directory import Snapshot
from .engine import Engine
from .schema import is_lob
from .sigs import SigBatch

SP_PLAN_MERGE = telemetry.register_span(
    "plan_merge", "plan one table's merge: Δ streams, classification, "
    "staging edits on the transaction")
SP_MERGE = telemetry.register_span(
    "merge", "three-way merge of a source snapshot into a target table")

_NONE = torch.iinfo(torch.int64).max  # "no entry" for position reductions

OP_DEL, OP_INS, OP_UPD = 0, 1, 2


def _i64(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.int64, device=device)


def _seg_min(vals: torch.Tensor, run_ids: torch.Tensor, k: int):
    """Per-run minimum of ``vals`` (``_NONE`` for an empty run)."""
    return torch.full((k,), _NONE, dtype=torch.int64,
                      device=vals.device).scatter_reduce(
        0, run_ids, vals, reduce="amin")


def _seg_sum(vals: torch.Tensor, run_ids: torch.Tensor, k: int):
    return _i64(k, vals.device).index_add_(0, run_ids, vals.to(torch.int64))


def _piece_runs(pieces) -> np.ndarray:
    """Run-start offsets for a concatenation of key-sorted pieces (each
    piece is an ascending subset of a key-sorted change set)."""
    offs, off = [], 0
    for p in pieces:
        if p.shape[0]:
            offs.append(off)
            off += p.shape[0]
    return np.asarray(offs if offs else [0], np.int64)


class ConflictMode(enum.Enum):
    FAIL = "fail"
    SKIP = "skip"      # keep target's version ("accept yours")
    ACCEPT = "accept"  # take source's version ("accept mine")
    CELL = "cell"      # auto-merge update-vs-update conflicts per column


class MergeConflictError(Exception):
    def __init__(self, report: "MergeReport"):
        super().__init__(
            f"merge failed: {report.true_conflicts} true conflict(s)")
        self.report = report


@dataclass
class MergeReport:
    true_conflicts: int = 0
    cell_merged: int = 0       # CELL mode: row conflicts merged column-wise
    false_conflicts: int = 0
    moves_ignored: int = 0
    inserted: int = 0
    deleted: int = 0
    commit_ts: Optional[int] = None
    used_base: bool = True
    # the true-conflict keys, in EVERY mode; NoPK paths report value
    # signatures here
    conflict_key_lo: Optional[torch.Tensor] = None
    conflict_key_hi: Optional[torch.Tensor] = None
    stats: DeltaStats = field(default_factory=DeltaStats)


@dataclass
class PKChanges:
    """Per-key collapsed change set of one branch vs. the base (§5.2)."""
    key_lo: torch.Tensor       # (k,) words, sorted by (lo, hi)
    key_hi: torch.Tensor
    op: torch.Tensor           # (k,) int8: OP_DEL / OP_INS / OP_UPD
    minus_rowid: torch.Tensor  # base row deleted (0 if none)
    plus_rowid: torch.Tensor   # new visible row (0 if none)
    plus_row_lo: torch.Tensor  # value signature of the new row (0 if none)
    plus_row_hi: torch.Tensor

    @property
    def k(self) -> int:
        return int(self.key_lo.shape[0])


def collapse_pk(stream: SignedStream) -> Tuple[PKChanges, int]:
    """Collapse a branch Δ stream per primary key; drop pure moves.

    Returns (changes, n_moves_dropped). PK uniqueness guarantees at most
    one − and one + per key; the stream arrives key-sorted, so the
    collapse is sort-free."""
    dev = stream.sign.device
    if stream.n == 0:
        z = _i64(0, dev)
        return PKChanges(z, z, torch.zeros((0,), dtype=torch.int8,
                                           device=dev),
                         z, z, z, z), 0
    s = stream.merge_by_key()
    _, agg = ops.diff_aggregate(s.key_lo, s.key_hi, s.sign, presorted=True)
    n = s.n
    k = agg.run_starts.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first_minus = _seg_min(torch.where(s.sign < 0, pos, _NONE),
                           agg.run_ids, k)
    first_plus = _seg_min(torch.where(s.sign > 0, pos, _NONE),
                          agg.run_ids, k)
    has_minus = first_minus != _NONE
    has_plus = first_plus != _NONE
    fm = first_minus.clamp(max=n - 1)
    fp = first_plus.clamp(max=n - 1)
    moved = (has_minus & has_plus
             & (s.row_lo[fm] == s.row_lo[fp])
             & (s.row_hi[fm] == s.row_hi[fp]))
    keep = ~moved
    op = torch.where(has_minus & has_plus, OP_UPD,
                     torch.where(has_plus, OP_INS, OP_DEL)).to(torch.int8)
    starts = agg.run_starts
    ch = PKChanges(
        key_lo=s.key_lo[starts][keep],
        key_hi=s.key_hi[starts][keep],
        op=op[keep],
        minus_rowid=torch.where(has_minus, s.rowid[fm], 0)[keep],
        plus_rowid=torch.where(has_plus, s.rowid[fp], 0)[keep],
        plus_row_lo=torch.where(has_plus, s.row_lo[fp], 0)[keep],
        plus_row_hi=torch.where(has_plus, s.row_hi[fp], 0)[keep],
    )
    return ch, int(moved.sum())


def _align_keys(t: PKChanges, s: PKChanges):
    """Linear merge-join of the two branches' (key-sorted) change sets.

    Both are sorted by (key_lo, key_hi) with unique keys, so the union is
    one searchsorted128 probe plus a stable 2-run merge. Returns (t_idx,
    s_idx) over the key-sorted union; -1 where that branch has no
    change for the key."""
    dev = t.key_lo.device
    if t.k == 0:
        return (torch.full((s.k,), -1, dtype=torch.int64, device=dev),
                torch.arange(s.k, dtype=torch.int64, device=dev))
    if s.k == 0:
        return (torch.arange(t.k, dtype=torch.int64, device=dev),
                torch.full((t.k,), -1, dtype=torch.int64, device=dev))
    pos = ops.searchsorted128(t.key_lo, t.key_hi, s.key_lo, s.key_hi)
    posc = pos.clamp(max=t.k - 1)
    matched = ((pos < t.k) & (t.key_lo[posc] == s.key_lo)
               & (t.key_hi[posc] == s.key_hi))
    s_at_t = torch.full((t.k,), -1, dtype=torch.int64, device=dev)
    s_at_t[pos[matched]] = torch.nonzero(matched).flatten()
    only = torch.nonzero(~matched).flatten()
    lo = torch.cat([t.key_lo, s.key_lo[only]])
    hi = torch.cat([t.key_hi, s.key_hi[only]])
    order = ops.merge128_runs(lo, hi, np.array([0, t.k], np.int64))
    from_t = order < t.k
    t_idx = torch.where(from_t, order, -1)
    s_idx = torch.empty(order.shape, dtype=torch.int64, device=dev)
    s_idx[from_t] = s_at_t[order[from_t]]
    s_idx[~from_t] = only[order[~from_t] - t.k]
    return t_idx, s_idx


def _cat(xs, device) -> torch.Tensor:
    return torch.cat(xs) if xs else _i64(0, device)


# --------------------------------------------------------------------------
# PK paths
# --------------------------------------------------------------------------

def _merge_pk(engine: Engine, target: str, source: Snapshot,
              base_dir, mode: ConflictMode, report: MergeReport):
    """Three-way PK merge. Returns (del_key_lo, del_key_hi, ins_rowids,
    ins_runs, merged_batch)."""
    dev = engine.device
    t_tab = engine.table(target)
    d_t = signed_delta(engine.store, base_dir, t_tab.directory, report.stats)
    d_s = signed_delta(engine.store, base_dir, source.directory, report.stats)
    ch_t, mv_t = collapse_pk(d_t)
    ch_s, mv_s = collapse_pk(d_s)
    report.moves_ignored = mv_t + mv_s

    t_idx, s_idx = _align_keys(ch_t, ch_s)
    both = (t_idx >= 0) & (s_idx >= 0)
    only_s = (t_idx < 0) & (s_idx >= 0)

    # identical changes cancel (no conflict, already reflected in target)
    ti, si = t_idx[both], s_idx[both]
    same_del = (ch_t.op[ti] == OP_DEL) & (ch_s.op[si] == OP_DEL)
    same_val = ((ch_t.op[ti] != OP_DEL) & (ch_s.op[si] != OP_DEL)
                & (ch_t.plus_row_lo[ti] == ch_s.plus_row_lo[si])
                & (ch_t.plus_row_hi[ti] == ch_s.plus_row_hi[si]))
    identical = same_del | same_val
    conflict_ti, conflict_si = ti[~identical], si[~identical]
    report.false_conflicts += int(identical.sum()) + int(only_s.sum())
    report.true_conflicts = int(conflict_si.shape[0])
    report.conflict_key_lo = ch_s.key_lo[conflict_si]
    report.conflict_key_hi = ch_s.key_hi[conflict_si]

    if report.true_conflicts and mode is ConflictMode.FAIL:
        raise MergeConflictError(report)

    del_lo, del_hi, ins = [], [], []

    # false conflicts: apply source's op (scenarios 2 & 4)
    fi = s_idx[only_s]
    ops_s = ch_s.op[fi]
    needs_del = ops_s != OP_INS
    del_lo.append(ch_s.key_lo[fi][needs_del])
    del_hi.append(ch_s.key_hi[fi][needs_del])
    ins.append(ch_s.plus_rowid[fi][ops_s != OP_DEL])

    # true conflicts under ACCEPT: force source's version (scenarios 3 & 6)
    if report.true_conflicts and mode is ConflictMode.ACCEPT:
        t_has_row = ch_t.op[conflict_ti] != OP_DEL
        del_lo.append(ch_s.key_lo[conflict_si][t_has_row])
        del_hi.append(ch_s.key_hi[conflict_si][t_has_row])
        ins.append(ch_s.plus_rowid[conflict_si][
            ch_s.op[conflict_si] != OP_DEL])

    # CELL mode: merge UPD-vs-UPD conflicts per column against the base
    # row; fail on same-cell divergence or on structural conflicts
    merged_batch = None
    if report.true_conflicts and mode is ConflictMode.CELL:
        updud = ((ch_t.op[conflict_ti] == OP_UPD)
                 & (ch_s.op[conflict_si] == OP_UPD))
        if not bool(updud.all()):
            report.conflict_key_lo = ch_s.key_lo[conflict_si][~updud]
            report.conflict_key_hi = ch_s.key_hi[conflict_si][~updud]
            raise MergeConflictError(report)
        schema = engine.table(target).schema
        base_rows = gather_payload(engine.store, schema,
                                   ch_t.minus_rowid[conflict_ti])
        t_rows = gather_payload(engine.store, schema,
                                ch_t.plus_rowid[conflict_ti])
        s_rows = gather_payload(engine.store, schema,
                                ch_s.plus_rowid[conflict_si])
        merged = {}
        cell_conflict = torch.zeros((conflict_ti.shape[0],),
                                    dtype=torch.bool, device=dev)
        for col in schema.names:
            b_c, t_c, s_c = base_rows[col], t_rows[col], s_rows[col]
            if is_lob(b_c):  # LOB: bytes equality on the host
                t_chg = np.asarray([x != y for x, y in zip(t_c, b_c)], bool)
                s_chg = np.asarray([x != y for x, y in zip(s_c, b_c)], bool)
                t_ne_s = np.asarray([x != y for x, y in zip(t_c, s_c)],
                                    bool)
                merged[col] = np.where(s_chg, s_c, t_c)
                cell_conflict |= torch.from_numpy(
                    t_chg & s_chg & t_ne_s).to(dev)
            else:
                t_chg = t_c != b_c
                s_chg = s_c != b_c
                merged[col] = torch.where(s_chg, s_c, t_c)
                cell_conflict |= t_chg & s_chg & (t_c != s_c)
        if bool(cell_conflict.any()):
            report.conflict_key_lo = ch_s.key_lo[conflict_si][cell_conflict]
            report.conflict_key_hi = ch_s.key_hi[conflict_si][cell_conflict]
            raise MergeConflictError(report)
        report.cell_merged = int(conflict_ti.shape[0])
        del_lo.append(ch_s.key_lo[conflict_si])
        del_hi.append(ch_s.key_hi[conflict_si])
        merged_batch = merged

    # each ins piece is key-ascending (it walks the key-sorted union), so
    # the concat carries an exact runs claim into the zero-rehash seal
    return (_cat(del_lo, dev), _cat(del_hi, dev), _cat(ins, dev),
            _piece_runs(ins), merged_batch)


def _merge_pk_nobase(engine: Engine, target: str, source: Snapshot,
                     mode: ConflictMode, report: MergeReport):
    """§5.3 no-base PK merge on ONE cross delta (shared objects skipped).

    Per key: − only ⇒ target-only (keep); + only ⇒ source-only (insert);
    both with equal values ⇒ no-op; both with different values ⇒ true
    conflict. Returns (del_rowids, ins_rowids, ins_runs)."""
    dev = engine.device
    t_tab = engine.table(target)
    cross = signed_delta(engine.store, t_tab.directory, source.directory,
                         report.stats)
    ch, moves = collapse_pk(cross)  # "moved" == value-identical in both
    report.moves_ignored = moves
    conflicts = ch.op == OP_UPD
    inserts = ch.op == OP_INS
    report.false_conflicts += int(inserts.sum()) + moves
    report.true_conflicts = int(conflicts.sum())
    report.conflict_key_lo = ch.key_lo[conflicts]
    report.conflict_key_hi = ch.key_hi[conflicts]
    if report.true_conflicts and mode is ConflictMode.FAIL:
        raise MergeConflictError(report)
    del_rowids = [_i64(0, dev)]
    ins_rowids = [ch.plus_rowid[inserts]]
    if report.true_conflicts and mode is ConflictMode.ACCEPT:
        del_rowids.append(ch.minus_rowid[conflicts])
        ins_rowids.append(ch.plus_rowid[conflicts])
    return (torch.cat(del_rowids), torch.cat(ins_rowids),
            _piece_runs(ins_rowids))


# --------------------------------------------------------------------------
# NoPK paths
# --------------------------------------------------------------------------

def _merge_nopk(engine: Engine, target: str, source: Snapshot,
                base_dir, mode: ConflictMode, report: MergeReport):
    """Three-way NoPK merge (§3 cardinality rules on post-cancel
    residuals). Returns (del_sig_lo, del_sig_hi, del_need, ins_rowids):
    delete ``del_need[i]`` visible duplicates of value-signature i; insert
    the (possibly repeated) payload rowids."""
    dev = engine.device
    t_tab = engine.table(target)
    d_t = signed_delta(engine.store, base_dir, t_tab.directory, report.stats)
    d_s = signed_delta(engine.store, base_dir, source.directory, report.stats)

    # cancellation #1: deletions of the same base row (same rowid)
    common_del = _i64(0, dev)
    if d_t.n and d_s.n:
        t_minus = d_t.rowid[d_t.sign < 0]
        s_minus = d_s.rowid[d_s.sign < 0]
        if t_minus.shape[0] and s_minus.shape[0]:
            # lint: sort-ok the reference's np.intersect1d
            # (src/repro/core/merge.py:346) sorts and dedups this set too;
            # it holds only the rowids both sides deleted
            common_del = torch.unique(t_minus[torch.isin(t_minus, s_minus)])

    def residual(stream: SignedStream) -> SignedStream:
        if common_del.shape[0] == 0 or stream.n == 0:
            return stream
        drop = (stream.sign < 0) & torch.isin(stream.rowid, common_del)
        return stream.filter_mask(~drop)  # order-preserving: stays sorted

    d_t, d_s = residual(d_t), residual(d_s)

    combined = SignedStream.concat([d_t, d_s], dev)
    if combined.n == 0:
        z = _i64(0, dev)
        return z, z, z, z
    side = torch.cat([torch.zeros((d_t.n,), dtype=torch.int8, device=dev),
                      torch.ones((d_s.n,), dtype=torch.int8, device=dev)])
    # both branch streams are value-sorted (NoPK key == value), so the
    # combined stream is a stable 2-run merge and aggregation is sort-free
    if combined.sorted_by_key:
        st = combined
    else:
        from ..distributed import sharding as ksh
        shards = ksh.key_shard_count(combined.n)
        cuts = None
        if shards > 1 and combined.runs is not None:
            cuts = ksh.plan_key_cuts(combined.key_lo, combined.key_hi,
                                     combined.runs, shards)
            if cuts is not None:
                engine.store.metrics.add("probe.shard_parts",
                                         cuts[0].shape[0] + 1)
        order = (ops.merge128_runs(combined.key_lo, combined.key_hi,
                                   combined.runs, cuts=cuts)
                 if combined.runs is not None
                 else ops._sort128(combined.row_lo, combined.row_hi))
        st, side = combined.take(order), side[order]
    _, agg = ops.diff_aggregate(st.row_lo, st.row_hi,
                                torch.ones_like(st.sign), presorted=True)
    ro_lo, ro_hi = st.row_lo, st.row_hi
    sd, sg, rid = side, st.sign, st.rowid
    starts = agg.run_starts
    run = agg.run_ids
    k = starts.shape[0]
    sg64 = sg.to(torch.int64)
    t_side, s_side = sd == 0, sd == 1
    plus_t = _seg_sum(t_side & (sg > 0), run, k)
    net_t = _seg_sum(torch.where(t_side, sg64, 0), run, k)
    plus_s = _seg_sum(s_side & (sg > 0), run, k)
    net_s = _seg_sum(torch.where(s_side, sg64, 0), run, k)
    # cancellation #2: insertions of identical values on both branches
    c_ins = torch.minimum(plus_t, plus_s)
    dt = net_t - c_ins   # residual δ_T per value group
    ds = net_s - c_ins   # residual δ_TClone

    conflict = (dt != 0) & (ds != 0)
    false_c = (dt == 0) & (ds != 0)
    report.true_conflicts = int(conflict.sum())
    report.false_conflicts += int(false_c.sum())
    report.conflict_key_lo = ro_lo[starts][conflict]
    report.conflict_key_hi = ro_hi[starts][conflict]
    if report.true_conflicts and mode is ConflictMode.FAIL:
        raise MergeConflictError(report)

    apply_net = torch.where(false_c, ds, 0)
    if mode is ConflictMode.ACCEPT:
        # force target to the source's count: N3 − N2 == net_s − net_t
        apply_net = torch.where(conflict, net_s - net_t, apply_net)

    # representative payload rowid per group: prefer a source + row, else
    # a − row (base object — the paper's base-revision lookup)
    n = sg.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    first_sp = _seg_min(torch.where(s_side & (sg > 0), pos, _NONE), run, k)
    first_mn = _seg_min(torch.where(sg < 0, pos, _NONE), run, k)
    rep_pos = torch.where(first_sp != _NONE, first_sp, first_mn)
    rep_rowid = rid[rep_pos.clamp(max=n - 1)]

    ins = torch.nonzero(apply_net > 0).flatten()
    dele = torch.nonzero(apply_net < 0).flatten()
    ins_rowids = torch.repeat_interleave(rep_rowid[ins], apply_net[ins])
    return (ro_lo[starts][dele], ro_hi[starts][dele], -apply_net[dele],
            ins_rowids)


def _merge_nopk_nobase(engine: Engine, target: str, source: Snapshot,
                       mode: ConflictMode, report: MergeReport):
    """§5.3 no-base NoPK merge on one cross delta.

    Per value group of the cross stream (net = N_source − N_target):
    net == 0 ⇒ cancelled; only-− ⇒ target-only value (keep); only-+ ⇒
    source-only value (insert all); mixed ⇒ true conflict. Returns
    (del_rowids, ins_rowids)."""
    dev = engine.device
    t_tab = engine.table(target)
    cross = signed_delta(engine.store, t_tab.directory, source.directory,
                         report.stats)
    if cross.n == 0:
        z = _i64(0, dev)
        return z, z
    s = cross.merge_by_key()  # NoPK: key order IS value order
    _, agg = ops.diff_aggregate(s.row_lo, s.row_hi, s.sign, presorted=True)
    starts, nets = agg.run_starts, agg.run_sums.to(torch.int64)
    run = agg.run_ids
    k = starts.shape[0]
    minus_cnt = _seg_sum(s.sign < 0, run, k)
    plus_cnt = _seg_sum(s.sign > 0, run, k)
    mixed = (minus_cnt > 0) & (plus_cnt > 0) & (nets != 0)
    pure_ins = (minus_cnt == 0) & (nets > 0)
    report.true_conflicts = int(mixed.sum())
    report.false_conflicts += int(pure_ins.sum())
    report.conflict_key_lo = s.row_lo[starts][mixed]
    report.conflict_key_hi = s.row_hi[starts][mixed]
    if report.true_conflicts and mode is ConflictMode.FAIL:
        raise MergeConflictError(report)

    apply_net = torch.where(pure_ins, nets, 0)
    if mode is ConflictMode.ACCEPT:
        apply_net = torch.where(mixed, nets, apply_net)

    # element-wise selection: within each run take the first |net| rows of
    # the needed sign (ranks via run-relative cumulative counts)
    is_plus = (s.sign > 0).to(torch.int64)
    is_minus = (s.sign < 0).to(torch.int64)
    cp, cm = torch.cumsum(is_plus, 0), torch.cumsum(is_minus, 0)
    base_p = cp[starts] - is_plus[starts]
    base_m = cm[starts] - is_minus[starts]
    rank_p = cp - base_p[run]   # 1-based among + within run
    rank_m = cm - base_m[run]
    net_e = apply_net[run]
    take_ins = (s.sign > 0) & (net_e > 0) & (rank_p <= net_e)
    take_del = (s.sign < 0) & (net_e < 0) & (rank_m <= -net_e)
    return s.rowid[take_del], s.rowid[take_ins]


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def plan_merge(engine: Engine, target: str, source: Snapshot,
               base: Optional[Snapshot], mode: ConflictMode,
               report: MergeReport, tx) -> None:
    """Stage the merge edits of ``source`` into ``target`` on ``tx``.

    Pure planning: reads the engine, fills ``report``, stages deletes and
    inserts on the caller's transaction — but never commits. Conflicts
    under FAIL/CELL raise *before* anything is staged."""
    with telemetry.span(SP_PLAN_MERGE):
        _plan_merge(engine, target, source, base, mode, report, tx)


def _plan_merge(engine: Engine, target: str, source: Snapshot,
                base: Optional[Snapshot], mode: ConflictMode,
                report: MergeReport, tx) -> None:
    t_tab = engine.table(target)
    if not t_tab.schema.compatible_with(source.schema):
        raise ValueError("SNAPSHOT MERGE: incompatible schemas")
    if mode is ConflictMode.CELL and (not t_tab.schema.has_pk
                                      or base is None):
        raise ValueError("CELL conflict mode needs a primary key and a "
                         "common base revision")
    schema = t_tab.schema
    merged_batch = None
    # every merge path emits its insert rowids as (a few) key-ascending
    # pieces — the runs claim lets the seal skip or k-way-merge, and the
    # gathered SigBatch means the apply path never rehashes a row
    if schema.has_pk:
        if base is not None:
            del_lo, del_hi, ins_rowids, ins_runs, merged_batch = _merge_pk(
                engine, target, source, base.directory, mode, report)
            if del_lo.shape[0]:
                rid = t_tab.locate_keys(del_lo, del_hi)
                tx.delete_rowids(target, rid[rid != 0])
                report.deleted = int((rid != 0).sum())
        else:
            del_rowids, ins_rowids, ins_runs = _merge_pk_nobase(
                engine, target, source, mode, report)
            if del_rowids.shape[0]:
                tx.delete_rowids(target, del_rowids)
                report.deleted = int(del_rowids.shape[0])
    else:
        # lint: runs-ok NoPK merge paths emit their inserts value-sorted
        ins_runs = SigBatch.sorted_run()
        if base is not None:
            sig_lo, sig_hi, need, ins_rowids = _merge_nopk(
                engine, target, source, base.directory, mode, report)
            if sig_lo.shape[0]:
                rids = t_tab.locate_rowsig_multi(sig_lo, sig_hi, need,
                                                 flat=True)
                if rids.shape[0]:
                    tx.delete_rowids(target, rids)
                report.deleted = int(rids.shape[0])
        else:
            del_rowids, ins_rowids = _merge_nopk_nobase(
                engine, target, source, mode, report)
            if del_rowids.shape[0]:
                tx.delete_rowids(target, del_rowids)
                report.deleted = int(del_rowids.shape[0])

    if ins_rowids.shape[0]:
        payload, sigs = gather_payload(engine.store, schema, ins_rowids,
                                       with_sigs=True, runs=ins_runs)
        # lint: runs-ok signatures gathered verbatim from sealed objects
        tx.insert(target, payload, sigs=sigs)
        report.inserted = int(ins_rowids.shape[0])
    if merged_batch is not None and len(next(iter(merged_batch.values()))):
        # CELL-merged rows are freshly constructed values — genuinely new
        # data, so they take the hashing path
        tx.insert(target, merged_batch)
        report.inserted += int(len(next(iter(merged_batch.values()))))


def three_way_merge(engine: Engine, target: str, source: Snapshot,
                    base: Optional[Snapshot] = None,
                    mode: ConflictMode = ConflictMode.FAIL) -> MergeReport:
    """SNAPSHOT MERGE TABLE target FROM source [BASED ON base]
    [WHEN CONFLICT FAIL|SKIP|ACCEPT|CELL]."""
    with telemetry.span(SP_MERGE):
        if base is None:
            base = engine.find_common_base(target, source.table)
        report = MergeReport(used_base=base is not None)
        tx = engine.begin()
        plan_merge(engine, target, source, base, mode, report, tx)
        if report.inserted or report.deleted:
            with engine.op_kind("merge"):
                report.commit_ts = tx.commit()
        # lineage: the merged-in source snapshot becomes the new common base
        if source.table != target and source.table in engine.tables:
            engine.set_common_base(target, source.table, source)
            engine.wal.append("set_base", a=target, b=source.table,
                              snap=source)
        return report


def two_way_merge(engine: Engine, target: str, source: Snapshot,
                  mode: ConflictMode = ConflictMode.FAIL) -> MergeReport:
    """Merge without BASED ON: lineage gives the implicit base (§5.3),
    else the empty-base cross-delta path (shared objects skipped)."""
    return three_way_merge(engine, target, source, base=None, mode=mode)


# --------------------------------------------------------------------------
# Three-way diff (beyond the paper): per-key classification of how two
# branches diverged from a common base — the PR-review view.
# --------------------------------------------------------------------------

TW_TARGET_ONLY, TW_SOURCE_ONLY, TW_BOTH_SAME, TW_BOTH_DIFFER = 0, 1, 2, 3


@dataclass
class ThreeWayDiff:
    key_lo: torch.Tensor    # (k,) keys changed by either branch
    key_hi: torch.Tensor
    status: torch.Tensor    # (k,) int8 — TW_* classification
    t_op: torch.Tensor      # (k,) int8 — OP_DEL/INS/UPD or -1 (untouched)
    s_op: torch.Tensor
    t_rowid: torch.Tensor   # payload rows for review (0 = none)
    s_rowid: torch.Tensor

    @property
    def k(self) -> int:
        return int(self.key_lo.shape[0])


def three_way_diff(engine: Engine, base: Snapshot, target: Snapshot,
                   source: Snapshot) -> ThreeWayDiff:
    """Classify every key changed by either branch vs. the base."""
    if not (base.schema.compatible_with(target.schema)
            and base.schema.compatible_with(source.schema)):
        raise ValueError("three_way_diff: incompatible schemas")
    d_t = signed_delta(engine.store, base.directory, target.directory)
    d_s = signed_delta(engine.store, base.directory, source.directory)
    ch_t, _ = collapse_pk(d_t)
    ch_s, _ = collapse_pk(d_s)
    t_idx, s_idx = _align_keys(ch_t, ch_s)
    ht, hs = t_idx >= 0, s_idx >= 0
    ti, si = t_idx.clamp(min=0), s_idx.clamp(min=0)

    def pick(a, b):
        """Per union key: the target's value where it changed the key,
        else the source's (either branch may be empty)."""
        av = a[ti] if a.shape[0] else torch.zeros_like(t_idx, dtype=a.dtype)
        bv = b[si] if b.shape[0] else torch.zeros_like(s_idx, dtype=b.dtype)
        return torch.where(ht, av, bv)

    key_lo = pick(ch_t.key_lo, ch_s.key_lo)
    key_hi = pick(ch_t.key_hi, ch_s.key_hi)
    t_op = torch.where(ht, ch_t.op[ti] if ch_t.k else -1, -1)
    s_op = torch.where(hs, ch_s.op[si] if ch_s.k else -1, -1)
    t_rowid = torch.where(ht, ch_t.plus_rowid[ti] if ch_t.k else 0, 0)
    s_rowid = torch.where(hs, ch_s.plus_rowid[si] if ch_s.k else 0, 0)
    both = ht & hs
    same = torch.zeros_like(both)
    if ch_t.k and ch_s.k:
        same = both & (
            ((ch_t.op[ti] == OP_DEL) & (ch_s.op[si] == OP_DEL))
            | ((ch_t.op[ti] != OP_DEL) & (ch_s.op[si] != OP_DEL)
               & (ch_t.plus_row_lo[ti] == ch_s.plus_row_lo[si])
               & (ch_t.plus_row_hi[ti] == ch_s.plus_row_hi[si])))
    status = torch.full(t_idx.shape, TW_TARGET_ONLY, dtype=torch.int8,
                        device=t_idx.device)
    status[~ht] = TW_SOURCE_ONLY
    status[same] = TW_BOTH_SAME
    status[both & ~same] = TW_BOTH_DIFFER
    return ThreeWayDiff(key_lo, key_hi, status, t_op.to(torch.int8),
                        s_op.to(torch.int8), t_rowid, s_rowid)
