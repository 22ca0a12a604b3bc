"""Byte-identity digests of the diff/merge path, on the port.

The same fixed-seed workloads as the reference's regression guard
(``tests/test_diff_digest.py``): a PK and a NoPK lineitem table, an update
on a clone, then built-in and SQL diffs, a three-way merge, a post-merge
scan and a PITR diff; and the apply path — merges in every conflict mode,
a Δ-revert, a publish through a pull request and its revert — each hashed with sha256 over the bytes of its
lanes (uint64 words hash as the same 8 bytes as int64). Equal digests
mean the port produced byte-identical results to the reference, on
whichever device it ran. With ``pack_root`` the apply path runs over an
evicted store: every engine spills to a pack tier and evicts its device
lanes before and after each apply, so the same digests also pin that
spill, evict and fault-in are byte-invisible.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from ..core import ConflictMode, snapshot_diff, sql_diff, three_way_merge
from ..core.refs import AtRef, resolve
from ..core.schema import is_lob
from ..interop import from_numpy, to_numpy
from .vcs_tables import _mk_engine, _random_update


def _h(update, t) -> None:
    update(np.ascontiguousarray(to_numpy(t)).tobytes())


def diff_digest(d) -> str:
    h = hashlib.sha256()
    for f in ("diff_cnt", "key_lo", "key_hi", "row_lo", "row_hi", "rowid"):
        _h(h.update, getattr(d, f))
    return h.hexdigest()[:16]


def scan_digest(engine, table) -> str:
    batch, rowids, lo, hi = engine.table(table).scan(with_sigs=True)
    h = hashlib.sha256()
    for t in (rowids, lo, hi):
        _h(h.update, t)
    for name in sorted(batch):
        col = batch[name]
        if is_lob(col):
            h.update(b"\x00".join(bytes(x) for x in col))
        else:
            _h(h.update, col)
    return h.hexdigest()[:16]


def run_workload(pk: bool, n_rows: int = 50_000, csize: int = 2_000,
                 device=None) -> dict:
    """Diff, SQL diff, merge, scan and PITR digests of one update."""
    rng = np.random.default_rng([csize] + list(b"DIG"))
    engine, base = _mk_engine(n_rows, pk, device=device)
    sn1 = engine.create_snapshot("sn1", "lineitem")
    engine.clone_table("t", sn1)
    _random_update(engine, "t", base, csize, rng, pk)
    sn3 = engine.create_snapshot("sn3", "t")
    cur = engine.current_snapshot("lineitem")
    d_b = snapshot_diff(engine.store, cur, sn3)
    d_s = sql_diff(engine.store, cur, sn3)
    rep = three_way_merge(engine, "lineitem", sn3, base=sn1,
                          mode=ConflictMode.ACCEPT)
    d_pitr = snapshot_diff(engine.store,
                           resolve(engine, AtRef("lineitem", 1)).snapshot,
                           engine.current_snapshot("lineitem"))
    return {
        "diff": diff_digest(d_b),
        "sql_diff": diff_digest(d_s),
        "merge": f"{rep.inserted}/{rep.deleted}/{rep.true_conflicts}",
        "scan": scan_digest(engine, "lineitem"),
        "pitr": diff_digest(d_pitr),
    }


def _rows(batch, idx: np.ndarray):
    """Rows ``idx`` of a scanned batch, as fresh (uncarried) values."""
    return {c: (v[idx] if is_lob(v) else v[from_numpy(idx, v.device)])
            for c, v in batch.items()}


def _edit(engine, table, base, idx, pk, col="l_quantity", tag=1):
    """Deterministic update of ``base[idx]`` rows on ``table``."""
    newvals = {k: v[idx].copy() for k, v in base.items()}
    if col == "l_quantity":
        newvals["l_quantity"] = newvals["l_quantity"] + 1.0 + tag
    else:
        newvals["l_comment"] = np.array(
            [b"edit-%d-%d" % (tag, i) for i in range(idx.shape[0])],
            dtype=object)
    tx = engine.begin()
    if pk:
        tx.update_by_keys(table, newvals)
    else:
        _, rowids = engine.table(table).scan()
        tx.delete_rowids(table, rowids[from_numpy(idx, rowids.device)])
        tx.insert(table, newvals)
    tx.commit()


def _apply_setup(pk, overlap, n_rows=30_000, csize=1_500, cell_cols=False,
                 device=None):
    """Engine with target ('lineitem') and source ('t') edits vs sn1;
    ``overlap`` rows are edited by BOTH branches."""
    engine, base = _mk_engine(n_rows, pk, device=device)
    sn1 = engine.create_snapshot("sn1", "lineitem")
    engine.clone_table("t", sn1)
    rng = np.random.default_rng([n_rows, csize, int(overlap * 1000), int(pk)])
    idx = rng.choice(n_rows, size=2 * csize, replace=False)
    t_idx, s_rest = np.sort(idx[:csize]), np.sort(idx[csize:])
    k = int(overlap * csize)
    ov = t_idx[:k]                       # rows both branches touch
    if pk:
        _edit(engine, "lineitem", base, t_idx, pk, tag=1,
              col="l_comment" if cell_cols else "l_quantity")
        _edit(engine, "t", base, np.sort(np.concatenate([ov, s_rest])),
              pk, tag=2, col="l_quantity")
    else:
        # NoPK §3 cardinality conflict: the target gains a duplicate copy
        # of each overlap row's VALUE while the source deletes that row
        scan_batch, rowids = engine.table("t").scan()  # pristine == sn1
        _edit(engine, "lineitem", base, t_idx[k:], pk, tag=1)
        if k:
            engine.insert("lineitem", _rows(scan_batch, ov))
        tx = engine.begin()
        if k:
            tx.delete_rowids("t", rowids[from_numpy(ov, rowids.device)])
        newvals = _rows(scan_batch, s_rest)
        newvals["l_quantity"] = newvals["l_quantity"] + 5.0
        tx.delete_rowids("t", rowids[from_numpy(s_rest, rowids.device)])
        tx.insert("t", newvals)
        tx.commit()
    sn3 = engine.create_snapshot("sn3", "t")
    return engine, sn1, sn3


def _evictor(pack_root):
    """``tier(engine)``: attach a fresh pack directory under ``pack_root``
    once per engine, then evict every object (a no-op without a root)."""
    seq = [0]

    def tier(engine):
        if pack_root is None:
            return
        from ..store import attach_packs
        if engine.store.packs is None:
            seq[0] += 1
            attach_packs(engine.store,
                         os.path.join(str(pack_root), f"p{seq[0]}"))
        engine.store.evict_all()
    return tier


def run_merge_workload(pk: bool, device=None, tier=None) -> dict:
    """Apply-path digests: merge in every conflict mode, with a base and
    without (the report counters plus the post-merge table bytes).
    ``tier(engine)`` runs before and after each merge (``_evictor``)."""
    tier = tier or _evictor(None)
    out = {}
    modes = [("fail", ConflictMode.FAIL, 0.0, False),
             ("skip", ConflictMode.SKIP, 0.5, False),
             ("accept", ConflictMode.ACCEPT, 0.5, False)]
    if pk:
        modes.append(("cell", ConflictMode.CELL, 0.5, True))
    for name, mode, overlap, cell_cols in modes:
        engine, sn1, sn3 = _apply_setup(pk, overlap, cell_cols=cell_cols,
                                        device=device)
        tier(engine)
        rep = three_way_merge(engine, "lineitem", sn3, base=sn1, mode=mode)
        tier(engine)
        out[f"merge_{name}"] = (
            f"{rep.inserted}/{rep.deleted}/{rep.true_conflicts}/"
            f"{rep.false_conflicts}/{rep.cell_merged}/"
            + scan_digest(engine, "lineitem"))
    engine, sn1, sn3 = _apply_setup(pk, 0.5, device=device)
    engine._base.clear()
    tier(engine)
    rep = three_way_merge(engine, "lineitem", sn3, base=None,
                          mode=ConflictMode.ACCEPT)
    tier(engine)
    out["merge_nobase"] = (f"{rep.inserted}/{rep.deleted}/"
                           f"{rep.true_conflicts}/"
                           + scan_digest(engine, "lineitem"))
    return out


def run_apply_workload(pk: bool, device=None, pack_root=None) -> dict:
    """Every apply-path digest of ``GOLDEN_APPLY``: the merges of
    ``run_merge_workload``, a revert of an ACCEPT merge by its inverse Δ,
    and a publish of a branch edit through a pull request and its
    revert (the post-apply table bytes each). ``pack_root``: every engine
    is fully evicted to a pack tier before and after each apply."""
    tier = _evictor(pack_root)
    out = run_merge_workload(pk, device=device, tier=tier)
    engine, sn1, sn3 = _apply_setup(pk, 0.0, device=device)
    pre = engine.create_snapshot("pre", "lineitem")
    tier(engine)
    three_way_merge(engine, "lineitem", sn3, base=sn1,
                    mode=ConflictMode.ACCEPT)
    post = engine.create_snapshot("post", "lineitem")
    engine.revert("lineitem", pre, post)
    tier(engine)
    out["revert"] = scan_digest(engine, "lineitem")
    engine, base = _mk_engine(30_000, pk, device=device)
    engine.create_branch("dev", ["lineitem"])
    rng = np.random.default_rng([77, pk])
    idx = np.sort(rng.choice(30_000, size=1_500, replace=False))
    _edit(engine, "dev/lineitem", base, idx, pk, tag=3)
    pr = engine.open_pr("main", "dev")
    tier(engine)
    pr.publish()
    out["publish"] = scan_digest(engine, "lineitem")
    pr.revert_publish()
    tier(engine)
    out["publish_revert"] = scan_digest(engine, "lineitem")
    return out
