"""The port's workflow porcelain against the reference: branch refs, pull
requests, CI gating, atomic publish, Δ-based revert, GC pins, and the
engine verbs they stand on (restore, drop, snapshots).

Every scenario runs on ``repro_torch`` with ``device="cpu"``; where it
ends in a state, the same numpy inputs also go through ``repro`` and the
two tables must hold the same rows by 128-bit row signature (the
reference's ``content_digest``). The apply-path digests of
``GOLDEN_APPLY`` (``revert``, ``publish``, ``publish_revert``) are pinned
both to the recorded goldens and to a live reference run.
"""
import collections
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
import repro.core as R
import repro_torch.core as P
from conftest import VCS_SCHEMA, VCS_SCHEMA_NOPK
from conftest import kv_batch as _batch
from repro_torch.benchmarks import digests, vcs_tables
from repro_torch.core import (AmbiguousRefError, Branch, CheckResult,
                              Column, CommitStats, ConflictMode, CType,
                              Engine, FaultPlan, GCStats, InjectedCrash,
                              MergeConflictError, PKViolation,
                              PublishBlocked, PullRequest, RevertConflict,
                              Schema, UnknownRefError, as_branch, inject,
                              resolve, snapshot_diff, telemetry,
                              three_way_merge)
from repro_torch.core.delta import _FIELDS, signed_delta
from repro_torch.core.diff import gather_rowsigs
from repro_torch.interop import from_numpy, to_numpy
from repro_torch.kernels import build, ops
from test_diff_digest import GOLDEN_APPLY
from test_diff_digest import _apply_setup as r_apply_setup
from test_diff_digest import _edit as r_edit
from test_diff_digest import scan_digest as r_scan_digest

SCH = Schema((Column("k", CType.I64), Column("v", CType.F64),
              Column("doc", CType.LOB)), primary_key=("k",))
SCH_NOPK = Schema(SCH.columns, primary_key=None)

# each package's API, engine factory and schemas: a scenario runs on both
API = {"ref": R, "port": P}
SIDES = {
    "ref": (lambda **kw: R.Engine(**kw), VCS_SCHEMA, VCS_SCHEMA_NOPK),
    "port": (lambda **kw: Engine(device="cpu", **kw), SCH, SCH_NOPK),
}


@pytest.fixture(autouse=True)
def _reset_port_globals():
    build.reset_launches()
    yield
    telemetry._ACTIVE = None
    build.reset_launches()


def U(x):
    return np.asarray(to_numpy(x, u64=True))


def digest(engine, table, directory=None):
    """Order-independent content digest over full-row signatures — the
    reference's ``conftest.content_digest``, for either package (of the
    current state, or of ``directory``)."""
    _, _, lo, hi = engine.table(table).scan(directory, with_sigs=True)
    lo, hi = U(lo), U(hi)
    order = np.lexsort((hi, lo))
    h = hashlib.sha256(lo[order].tobytes())
    h.update(hi[order].tobytes())
    return h.hexdigest()


def mk_engine(side="port", nopk=False, **kw):
    new, sch, sch_nopk = SIDES[side]
    e = new(**kw)
    e.create_table("t", sch_nopk if nopk else sch)
    e.create_table("u", sch)
    e.insert("t", _batch([1, 2, 3]))
    e.insert("u", _batch([10, 20]))
    return e


def both(scenario, *args):
    """Run ``scenario(side, *args)`` on each package; returns both results."""
    return [scenario(side, *args) for side in SIDES]


def keys(engine, table):
    return sorted(to_numpy(engine.table(table).scan()[0]["k"]).tolist())


# ------------------------------------------------------------ golden digests

def _revert_publish_digests(side, pk):
    """The revert and publish entries of ``run_apply_workload``."""
    if side == "ref":
        from benchmarks.vcs_tables import _mk_engine
        setup, edit, scan, kw = r_apply_setup, r_edit, r_scan_digest, {}
    else:
        _mk_engine = vcs_tables._mk_engine
        setup, edit, scan = (digests._apply_setup, digests._edit,
                             digests.scan_digest)
        kw = {"device": "cpu"}
    api, out = API[side], {}
    engine, sn1, sn3 = setup(pk, 0.0, **kw)
    pre = engine.create_snapshot("pre", "lineitem")
    api.three_way_merge(engine, "lineitem", sn3, base=sn1,
                        mode=api.ConflictMode.ACCEPT)
    post = engine.create_snapshot("post", "lineitem")
    engine.revert("lineitem", pre, post)
    out["revert"] = scan(engine, "lineitem")
    engine, base = _mk_engine(30_000, pk, **kw)
    engine.create_branch("dev", ["lineitem"])
    rng = np.random.default_rng([77, pk])
    idx = np.sort(rng.choice(30_000, size=1_500, replace=False))
    edit(engine, "dev/lineitem", base, idx, pk, tag=3)
    pr = engine.open_pr("main", "dev")
    pr.publish()
    out["publish"] = scan(engine, "lineitem")
    pr.revert_publish()
    out["publish_revert"] = scan(engine, "lineitem")
    return out


@pytest.mark.parametrize("pk", [True, False])
def test_revert_and_publish_digests_match_golden_and_a_live_reference(pk):
    ref, port = both(_revert_publish_digests, pk)
    want = {k: GOLDEN_APPLY[pk][k]
            for k in ("revert", "publish", "publish_revert")}
    assert port == want, port
    assert ref == want, ref


# ------------------------------------------------------------- branch refs

def test_branch_is_metadata_only_and_namespaced():
    e = mk_engine()
    bytes_before = e.store.bytes_written
    br = e.create_branch("dev", ["t", "u"])
    assert isinstance(br, Branch)
    assert e.store.bytes_written == bytes_before      # zero data copied
    assert br.tables == {"t": "dev/t", "u": "dev/u"}
    assert set(br.base) == {"t", "u"}
    assert [b.name for b in e.list_branches()] == ["dev"]
    assert e.branch("dev") is br and e.branch("main").tables == \
        {"t": "t", "u": "u"}
    # branch isolation both ways
    e.insert("dev/t", _batch([4]))
    e.delete_by_keys("t", {"k": np.asarray([1])})
    assert e.table("dev/t").count() == 4
    assert e.table("t").count() == 2
    e.drop_branch("dev")
    assert "dev/t" not in e.tables and "dev/u" not in e.tables
    assert e.list_branches() == []
    assert [r.kind for r in e.wal if r.kind.endswith("branch")] == \
        ["create_branch", "drop_branch"]


def test_branch_from_branch_and_name_validation():
    e = mk_engine()
    e.create_branch("dev", ["t"])
    e.insert("dev/t", _batch([4]))
    br2 = e.create_branch("dev2", ["t"], from_ref="dev")
    assert br2.parent == "dev"
    assert e.table("dev2/t").count() == 4
    with pytest.raises(ValueError):
        e.create_branch("dev", ["t"])         # exists
    with pytest.raises(ValueError):
        e.create_branch("main", ["t"])        # reserved
    with pytest.raises(ValueError):
        e.create_branch("a/b", ["t"])         # namespace separator
    with pytest.raises(KeyError):
        e.create_branch("x", ["missing"])
    with pytest.raises(UnknownRefError):
        e.create_branch("y", ["u"], from_ref="dev")   # dev has no u


def test_snapshots_list_drop_and_legacy_resolve():
    e = mk_engine()
    e.create_snapshot("s1", "t")
    e.create_snapshot("s2", "u")
    rows = e.list_snapshots()
    assert [r[0] for r in rows] == ["s1", "s2"]
    assert rows[0][1] == "t"
    assert e.resolve_snapshot("s1") is e.snapshots["s1"]
    assert e.resolve_snapshot("snap:s2") is e.snapshots["s2"]
    with pytest.raises(UnknownRefError):
        e.resolve_snapshot("t")          # a bare name is a snapshot name
    e.clone_table("c", "s1")
    assert e.find_common_base("c", "t") is e.snapshots["s1"]
    e.drop_snapshot("s1")
    assert [r[0] for r in e.list_snapshots()] == ["s2"]
    assert e.find_common_base("c", "t") is None
    with pytest.raises(UnknownRefError):
        e.drop_snapshot("s1")


def _restore_drop(side):
    e = mk_engine(side)
    ts1 = e.ts
    e.insert("t", _batch([4, 5]))
    e.clone_table("c", e.current_snapshot("t"))
    e.restore_table("t", f"ts:{ts1}")
    restored = digest(e, "t")
    e.restore_table("c", f"t@{{{ts1}}}")
    e.drop_table("u")
    return (restored, digest(e, "c"), sorted(e.tables),
            e.find_common_base("c", "t") is not None,
            [r.kind for r in e.wal])


def test_restore_and_drop_table_match_the_reference():
    ref, port = both(_restore_drop)
    assert port == ref
    e = mk_engine()
    e.restore_table("t", e.current_snapshot("u"))   # compatible schemas
    assert keys(e, "t") == [10, 20]
    with pytest.raises(ValueError):
        nopk = mk_engine(nopk=True)
        nopk.restore_table("t", nopk.current_snapshot("u"))
    with pytest.raises(UnknownRefError):
        e.drop_table("nope")


# ------------------------------------------------------ PR review surfaces

def test_pr_diff_pins_base_horizon():
    e = mk_engine()
    e.create_branch("dev", ["t"])
    e.update_by_keys("dev/t", _batch([2], vals=[99.0]))
    pr = e.open_pr("main", "dev")
    assert isinstance(pr, PullRequest)
    d1 = pr.diff()["t"].n_groups
    # base moves AFTER open: the review diff must not shift
    e.insert("t", _batch([7]))
    assert pr.diff()["t"].n_groups == d1 == 2
    # second review round hits the delta cache
    d = pr.diff()["t"]
    assert d.stats.delta_cache_hits >= 1
    with pytest.raises(ValueError):
        e.open_pr("dev", "dev")
    with pytest.raises(UnknownRefError):
        e.open_pr("main", "nope")


def test_dry_run_merge_reports_conflicts_without_mutation():
    e = mk_engine()
    e.create_branch("dev", ["t"])
    e.update_by_keys("dev/t", _batch([2], vals=[99.0]))
    e.update_by_keys("t", _batch([2], vals=[55.0]))    # conflicting base edit
    pr = e.open_pr("main", "dev")
    before = digest(e, "t"), digest(e, "dev/t")
    wal_len = len(e.wal)
    oids = set(e.store.oids())
    rep = pr.dry_run_merge()["t"]
    assert rep.true_conflicts == 1
    assert rep.commit_ts is None
    assert (digest(e, "t"), digest(e, "dev/t")) == before
    assert len(e.wal) == wal_len and set(e.store.oids()) == oids


# ------------------------------------------------- CI checks gate publish

def _blocked_then_published(side):
    e = mk_engine(side)
    e.create_branch("dev", ["t", "u"])
    e.update_by_keys("dev/t", _batch([2], vals=[999.0]))
    e.insert("dev/u", _batch([30]))
    pr = e.open_pr("main", "dev")
    pr.add_check(lambda ctx: bool((ctx.scan("t")[0]["v"] < 100).all()),
                 "v-limit")
    before = digest(e, "t"), digest(e, "u")
    ts0, oids0, wal0 = e.ts, set(e.store.oids()), len(e.wal)
    with pytest.raises(API[side].PublishBlocked) as exc:
        pr.publish()
    assert [c.name for c in exc.value.checks if not c.ok] == ["v-limit"]
    # blocked publish left EVERYTHING untouched: state, ts, store, WAL
    assert (digest(e, "t"), digest(e, "u")) == before
    assert e.ts == ts0 and set(e.store.oids()) == oids0
    assert len(e.wal) == wal0 and pr.status == "open"
    # fix on the branch -> checks pass -> atomic publish
    e.update_by_keys("dev/t", _batch([2], vals=[42.0]))
    reports = pr.publish()
    assert pr.status == "published" and pr.publish_ts is not None
    # every table landed at ONE commit timestamp
    assert e.table("t").directory.ts == pr.publish_ts
    assert e.table("u").directory.ts == pr.publish_ts
    assert reports["t"].commit_ts == reports["u"].commit_ts == pr.publish_ts
    assert keys(e, "u") == [10, 20, 30]
    assert 42.0 in to_numpy(e.table("t").scan()[0]["v"]).tolist()
    return (digest(e, "t"), digest(e, "u"), pr.publish_ts,
            {lg: (r.inserted, r.deleted) for lg, r in reports.items()})


def test_failing_check_blocks_publish_then_fix_publishes():
    ref, port = both(_blocked_then_published)
    assert port == ref


def test_check_exception_is_a_failure_and_preview_is_ephemeral():
    e = mk_engine()
    e.create_branch("dev", ["t"])
    e.insert("dev/t", _batch([4]))
    pr = e.open_pr("main", "dev")

    def boom(ctx):
        raise RuntimeError("bad data")

    pr.add_check(boom)
    seen = {}

    def peek(ctx):
        seen["count"] = ctx.count("t")
        seen["device"] = ctx.scan("t")[1].device
        return True

    pr.add_check(peek, "peek")
    state = (e.ts, e.store._next_oid, set(e.store.oids()), len(e.wal))
    results = pr.run_checks()
    assert [r.ok for r in results] == [False, True]
    assert all(isinstance(r, CheckResult) for r in results)
    assert "RuntimeError" in results[0].error
    # the check saw the MERGED preview (3 base rows + 1 branch row) on the
    # live engine's device ...
    assert seen["count"] == 4 and seen["device"] == e.device
    # ... but the preview never escaped: ts, oid counter, objects, WAL
    assert e.table("t").count() == 3
    assert (e.ts, e.store._next_oid, set(e.store.oids()),
            len(e.wal)) == state


# -------------------------------------------------- publish atomicity

def test_conflict_in_second_table_unwinds_whole_publish():
    e = mk_engine()
    e.create_branch("dev", ["t", "u"])
    e.insert("dev/t", _batch([4]))                        # clean change
    e.update_by_keys("dev/u", _batch([10], vals=[1.0]))   # will conflict
    e.update_by_keys("u", _batch([10], vals=[2.0]))       # divergent base
    pr = e.open_pr("main", "dev")
    before = digest(e, "t"), digest(e, "u")
    ts0, oids0 = e.ts, set(e.store.oids())
    with pytest.raises(MergeConflictError):
        pr.publish(mode=ConflictMode.FAIL)
    # the clean table did NOT land: all-or-nothing
    assert (digest(e, "t"), digest(e, "u")) == before
    assert e.ts == ts0 and set(e.store.oids()) == oids0
    assert pr.status == "open"
    # force-resolve and the same PR publishes atomically
    reports = pr.publish(mode=ConflictMode.ACCEPT)
    assert reports["u"].true_conflicts == 1
    assert e.table("t").directory.ts == e.table("u").directory.ts


def test_publish_crash_before_the_commit_leaves_nothing():
    e = mk_engine()
    e.create_branch("dev", ["t", "u"])
    e.insert("dev/t", _batch([4]))
    e.insert("dev/u", _batch([30]))
    pr = e.open_pr("main", "dev")
    before = digest(e, "t"), digest(e, "u"), e.ts, set(e.store.oids())
    with pytest.raises(InjectedCrash):
        with inject(FaultPlan.at("torch.workspace.publish.planned")):
            pr.publish()
    assert (digest(e, "t"), digest(e, "u"), e.ts,
            set(e.store.oids())) == before
    with inject(FaultPlan()) as plan:
        pr.publish()
        pr.revert_publish()
        e.revert("t", e.current_snapshot("t"), e.current_snapshot("t"))
    for cp in ("torch.workspace.publish.planned",
               "torch.workspace.publish.pre_log",
               "torch.workspace.revert_publish.pre_log",
               "torch.workspace.revert.pre_log"):
        assert plan.hits[cp] == 1, cp


def test_publish_conflict_raises_merge_error_even_with_checks():
    e = mk_engine()
    e.create_branch("dev", ["t"])
    e.update_by_keys("dev/t", _batch([2], vals=[9.0]))
    e.update_by_keys("t", _batch([2], vals=[5.0]))     # divergent base
    pr = e.open_pr("main", "dev")
    pr.add_check(lambda ctx: True, "always-green")
    with pytest.raises(MergeConflictError) as exc:
        pr.publish(mode=ConflictMode.FAIL)
    assert exc.value.report.true_conflicts == 1
    assert pr.status == "open"


def test_user_check_named_merge_still_gates_publish():
    e = mk_engine()
    e.create_branch("dev", ["t"])
    e.insert("dev/t", _batch([4]))
    pr = e.open_pr("main", "dev")

    def merge(ctx):          # fn.__name__ == "merge"
        return False

    pr.add_check(merge)
    with pytest.raises(PublishBlocked):
        pr.publish()
    assert pr.status == "open"
    assert e.table("t").count() == 3


def test_multi_table_commit_unwinds_on_seal_failure():
    e = mk_engine()
    oids0 = set(e.store.oids())
    d_t = e.table("t").directory
    tx = e.begin()
    assert not tx.staged
    tx.insert("t", _batch([100]))
    tx.insert("u", _batch([10]))       # duplicate PK in "u"
    assert tx.staged
    with pytest.raises(PKViolation):
        tx.commit()
    assert e.table("t").directory is d_t
    assert e.table("t").count() == 3
    assert set(e.store.oids()) == oids0


# ------------------------------------------------------- Δ-based revert

def _revert_publish(side, nopk):
    e = mk_engine(side, nopk=nopk)
    e.create_branch("dev", ["t", "u"])
    if nopk:
        _, rowids = e.table("dev/t").scan()
        tx = e.begin()
        tx.delete_rowids("dev/t", rowids[:1])
        tx.insert("dev/t", _batch([8, 8], vals=[7.0, 7.0],
                                  docs=[b"x", b"x"]))
        tx.commit()
    else:
        e.update_by_keys("dev/t", _batch([2], vals=[99.0]))
        e.delete_by_keys("dev/t", {"k": np.asarray([3])})
        e.insert("dev/t", _batch([8]))
    e.insert("dev/u", _batch([30]))
    pr = e.open_pr("main", "dev")
    pre = digest(e, "t"), digest(e, "u")
    history_len = len(e.table("t").history)
    pr.publish()
    post = digest(e, "t"), digest(e, "u")
    assert post != pre
    ts_rev = pr.revert_publish()
    assert pr.status == "reverted"
    # base is byte-identical to the pre-publish state ...
    assert (digest(e, "t"), digest(e, "u")) == pre
    # ... via NEW commits, not a head rewrite: history grew and the
    # published state is still reachable through PITR
    assert ts_rev > pr.publish_ts
    assert len(e.table("t").history) > history_len
    api = API[side]
    snap = api.resolve(e, f"t@{{{pr.publish_ts}}}").snapshot
    assert api.snapshot_diff(e.store, snap,
                             e.current_snapshot("t")).n_groups > 0
    return pre, post, ts_rev, [(c.ts, c.table, c.kind, c.inserted,
                                c.deleted) for c in e.commit_log]


@pytest.mark.parametrize("nopk", [False, True])
def test_revert_publish_restores_base_and_preserves_history(nopk):
    ref, port = both(_revert_publish, nopk)
    assert port == ref


def test_engine_revert_is_delta_sized_and_strict():
    e = Engine(device="cpu")
    e.create_table("t", SCH)
    e.insert("t", _batch(np.arange(1000)))
    s1 = e.current_snapshot("t")
    e.update_by_keys("t", _batch([5], vals=[99.0]))
    s2 = e.current_snapshot("t")
    rows0 = e.store.metrics.counters.get("delta.rows_scanned", 0)
    ts = e.revert("t", s1, s2)
    assert ts == e.ts
    # Δ-sized: the revert scanned the changed rows, not the 1000-row table
    assert e.store.metrics.counters["delta.rows_scanned"] - rows0 <= 4
    assert snapshot_diff(e.store, s1, e.current_snapshot("t")).is_empty()
    # inverse of an empty delta is a no-op (no commit)
    s3 = e.current_snapshot("t")
    assert e.revert("t", s3, s3) is None
    # strictness: if the key moved on since, the revert conflicts
    e.update_by_keys("t", _batch([5], vals=[99.0]))
    s4 = e.current_snapshot("t")
    e.update_by_keys("t", _batch([5], vals=[123.0]))   # concurrent edit
    with pytest.raises(RevertConflict):
        e.revert("t", s3, s4)
    # refs resolve against the table: HEAD~1 forms and ts:N
    e.revert("t", "t~1", "HEAD")
    batch = e.table("t").scan()[0]
    assert to_numpy(batch["v"])[to_numpy(batch["k"]) == 5].tolist() == [99.0]


def test_revert_conflict_on_retaken_key():
    e = Engine(device="cpu")
    e.create_table("t", SCH)
    e.insert("t", _batch([1, 2]))
    s1 = e.current_snapshot("t")
    e.delete_by_keys("t", {"k": np.asarray([2])})
    s2 = e.current_snapshot("t")
    e.insert("t", _batch([2], vals=[77.0]))     # key re-taken since
    with pytest.raises(RevertConflict):
        e.revert("t", s1, s2)


def test_nopk_revert_conflicts_when_rows_are_gone():
    e = Engine(device="cpu")
    e.create_table("t", SCH_NOPK)
    e.insert("t", _batch([1, 2, 2]))
    s1 = e.current_snapshot("t")
    e.insert("t", _batch([2, 3]))
    s2 = e.current_snapshot("t")
    _, rowids = e.table("t").scan()
    tx = e.begin()
    tx.delete_rowids("t", rowids[3:])            # the rows the revert wants
    tx.commit()
    with pytest.raises(RevertConflict):
        e.revert("t", s1, s2)


def _nopk_duplicates(side):
    """NoPK revert with value groups of several copies on both sides."""
    e = mk_engine(side, nopk=True)
    e.insert("t", _batch([5, 5, 5, 6], vals=[1.0] * 4, docs=[b"d"] * 4))
    s1 = e.current_snapshot("t")
    _, rowids = e.table("t").scan()
    tx = e.begin()
    tx.delete_rowids("t", rowids[3:5])           # two of the three copies
    tx.insert("t", _batch([6, 6, 7], vals=[1.0] * 3, docs=[b"d"] * 3))
    tx.commit()
    s2 = e.current_snapshot("t")
    e.revert("t", s1, s2)
    return digest(e, "t"), digest(e, "t", s1.directory)


def test_nopk_revert_restores_duplicate_counts_like_the_reference():
    ref, port = both(_nopk_duplicates)
    assert port == ref
    # the reverted table holds the pre-change multiset, copies included
    assert port[0] == port[1]


@pytest.mark.parametrize("pk", [True, False])
def test_revert_leaves_the_cached_signed_stream_unchanged(pk):
    engine, sn1, sn3 = digests._apply_setup(pk, 0.0, n_rows=3_000,
                                            csize=200, device="cpu")
    pre = engine.create_snapshot("pre", "lineitem")
    three_way_merge(engine, "lineitem", sn3, base=sn1,
                    mode=ConflictMode.ACCEPT)
    post = engine.create_snapshot("post", "lineitem")
    store = engine.store
    stream = signed_delta(store, pre.directory, post.directory)
    kept = {f: getattr(stream, f).clone() for f in _FIELDS}
    runs = None if stream.runs is None else stream.runs.copy()
    d0 = digests.diff_digest(snapshot_diff(store, pre, post))
    assert engine.revert("lineitem", pre, post) is not None
    again = signed_delta(store, pre.directory, post.directory)
    assert again is stream                    # served from the delta cache
    for f in _FIELDS:
        assert torch.equal(getattr(again, f), kept[f]), f
    assert (again.runs is None) == (runs is None)
    if runs is not None:
        np.testing.assert_array_equal(again.runs, runs)
    assert digests.diff_digest(snapshot_diff(store, pre, post)) == d0
    # a second revert of the same pair re-reads the same cached stream
    inv = stream.inverse()
    assert inv.key_lo is stream.key_lo and inv.rowid is stream.rowid
    assert torch.equal(inv.sign, -kept["sign"])
    assert torch.equal(stream.sign, kept["sign"])


def test_gather_rowsigs_matches_the_reference():
    from benchmarks.vcs_tables import _mk_engine as r_mk
    ref_e, _ = r_mk(3_000, True)
    port_e, _ = vcs_tables._mk_engine(3_000, True, device="cpu")
    _, r_rid = ref_e.table("lineitem").scan()
    rng = np.random.default_rng(3)
    pick = rng.permutation(r_rid.shape[0])[:500]
    r_lo, r_hi = R.gather_rowsigs(ref_e.store, r_rid[pick])
    p_lo, p_hi = gather_rowsigs(port_e.store, from_numpy(r_rid[pick]))
    np.testing.assert_array_equal(U(p_lo), r_lo)
    np.testing.assert_array_equal(U(p_hi), r_hi)
    one = from_numpy(r_rid[:3])                   # single-object fast path
    np.testing.assert_array_equal(U(gather_rowsigs(port_e.store, one)[0]),
                                  R.gather_rowsigs(ref_e.store,
                                                   r_rid[:3])[0])


# ------------------------------------------------- zero-rehash apply pins

def _carry_update(engine, table, base, idx, pk, tag):
    newvals = {k: v[idx].copy() for k, v in base.items()}
    newvals["l_quantity"] = newvals["l_quantity"] + 1.0 + tag
    newvals["l_comment"] = np.array(
        [b"carry-%d-%d" % (tag, i) for i in range(idx.shape[0])], object)
    tx = engine.begin()
    if pk:
        tx.update_by_keys(table, newvals)
    else:
        _, rowids = engine.table(table).scan()
        sel = idx if isinstance(rowids, np.ndarray) else from_numpy(idx)
        tx.delete_rowids(table, rowids[sel])
        tx.insert(table, newvals)
    tx.commit()


def _mk(side, pk, n=4000):
    if side == "ref":
        from benchmarks.vcs_tables import _mk_engine
        return _mk_engine(n, pk)
    return vcs_tables._mk_engine(n, pk, device="cpu")


def _revert_carry(side, pk):
    engine, base = _mk(side, pk)
    sn1 = engine.create_snapshot("sn1", "lineitem")
    engine.clone_table("t", sn1)
    rng = np.random.default_rng([7, int(pk)])
    idx = np.sort(rng.choice(4000, size=300, replace=False))
    _carry_update(engine, "t", base, idx, pk, tag=2)
    sn3 = engine.create_snapshot("sn3", "t")
    pre = engine.create_snapshot("pre", "lineitem")
    api = API[side]
    api.three_way_merge(engine, "lineitem", sn3, base=sn1,
                        mode=api.ConflictMode.ACCEPT)
    post = engine.create_snapshot("post", "lineitem")
    engine.commit_stats = type(engine.commit_stats)()
    assert engine.revert("lineitem", pre, post) is not None
    st = engine.commit_stats
    assert st.rows_rehashed == 0 and st.lob_rows_hashed == 0
    assert st.rows_carried > 0 and st.apply_sorts == 0
    assert api.snapshot_diff(engine.store, pre,
                             engine.current_snapshot("lineitem")).is_empty()
    return vars(st), digest(engine, "lineitem")


@pytest.mark.parametrize("pk", [True, False])
def test_revert_apply_never_rehashes(pk):
    ref, port = both(_revert_carry, pk)
    assert port == ref


def _publish_carry(side, pk):
    engine, base = _mk(side, pk)
    engine.create_branch("dev", ["lineitem"])
    rng = np.random.default_rng([11, int(pk)])
    idx = np.sort(rng.choice(4000, size=250, replace=False))
    _carry_update(engine, "dev/lineitem", base, idx, pk, tag=5)
    pr = engine.open_pr("main", "dev")
    pr.add_check(lambda ctx: ctx.count("lineitem") == 4000, "rows")
    engine.commit_stats = type(engine.commit_stats)()
    pr.publish()
    st = engine.commit_stats
    assert st.rows_rehashed == 0 and st.lob_rows_hashed == 0
    assert st.rows_carried > 0
    published = dict(vars(st))
    pr.revert_publish()
    # the CI preview merge runs on a scratch engine with its OWN stats
    assert engine.commit_stats.rows_rehashed == 0
    assert engine.commit_stats.lob_rows_hashed == 0
    return published, vars(engine.commit_stats), digest(engine, "lineitem")


@pytest.mark.parametrize("pk", [True, False])
def test_publish_and_revert_publish_never_rehash(pk):
    ref, port = both(_publish_carry, pk)
    assert port == ref
    assert CommitStats(**port[1]).rows_carried > 0


# ----------------------------------------------------------- GC pinning

def _gc_pins(side):
    e = mk_engine(side, retention_versions=1)
    e.create_branch("dev", ["t"])
    e.update_by_keys("dev/t", _batch([2], vals=[9.0]))
    pr = e.open_pr("main", "dev")
    pin_ts = pr.base_pins["t"].created_ts
    for i in range(5):          # base churns past the retention window
        e.update_by_keys("t", _batch([1], vals=[float(i)]))
    stats = e.gc()
    assert stats.pinned_horizons >= 1 and stats.versions_pruned > 0
    # the pinned horizon is still resolvable AND scannable after GC
    batch, _ = e.table("t").scan(e.table("t").directory_at(pin_ts))
    assert sorted(to_numpy(batch["k"]).tolist()) == [1, 2, 3]
    # review + publish still work after GC
    assert pr.diff()["t"].n_groups == 2
    pr.publish(mode=API[side].ConflictMode.ACCEPT)
    pr.close()
    e.drop_branch("dev")
    last = e.gc()
    assert e.table("t").count() == 3
    return (vars(stats), vars(last), digest(e, "t"),
            sorted(e.store.oids()))


def test_gc_honors_pr_pinned_horizons():
    ref, port = both(_gc_pins)
    assert port == ref
    assert port[1]["objects_freed"] > 0         # the branch's objects went


def test_gc_stats_and_metrics():
    e = mk_engine(retention_versions=1)
    for i in range(3):
        e.update_by_keys("t", _batch([1], vals=[float(i)]))
    e.create_branch("dev", ["t"])
    e.insert("dev/t", _batch([4]))
    e.drop_branch("dev")                     # its object is garbage now
    with telemetry.trace(e) as tr:
        st = e.gc()
    assert isinstance(st, GCStats)
    assert [s.name for s in tr.roots] == ["gc"]
    snap = telemetry.metrics_snapshot(e)
    assert snap["gc.objects_freed"] == st.objects_freed == 1
    assert snap["gc.versions_pruned"] == st.versions_pruned > 0
    assert snap["gc.pinned_horizons"] == st.pinned_horizons
    # GC is not logged: a crash mid-sweep leaves garbage, never a change
    e.create_branch("dev", ["t"])
    e.insert("dev/t", _batch([4, 5]))
    e.update_by_keys("dev/t", _batch([4], vals=[1.0]))
    e.drop_branch("dev")
    before = digest(e, "t")
    with pytest.raises(InjectedCrash):
        with inject(FaultPlan.at("torch.engine.gc.mid_sweep", n=2)):
            e.gc()
    assert digest(e, "t") == before
    assert e.gc().objects_freed == 2


def test_gc_keeps_published_pr_revertible():
    e = Engine(device="cpu", retention_versions=1)
    e.create_table("t", SCH)
    e.insert("t", _batch([1, 2, 3]))
    e.create_branch("dev", ["t"])
    e.update_by_keys("dev/t", _batch([2], vals=[9.0]))
    pr = e.open_pr("main", "dev")
    pre = digest(e, "t")
    pr.publish()
    e.gc()                       # published PR pins pre/post states
    pr.revert_publish()
    assert digest(e, "t") == pre


def test_gc_retention_zero_keeps_all_history():
    e = Engine(device="cpu", retention_versions=0)
    e.create_table("t", SCH)
    e.insert("t", _batch([1]))
    ts1 = e.ts
    for i in range(5):
        e.insert("t", _batch([10 + i]))
    e.gc()
    batch, _ = e.table("t").scan(e.table("t").directory_at(ts1))
    assert to_numpy(batch["k"]).tolist() == [1]


def test_drop_branch_refused_while_pr_live():
    e = mk_engine()
    e.create_branch("dev", ["t"])
    pr = e.open_pr("main", "dev")
    with pytest.raises(ValueError):
        e.drop_branch("dev")                 # open PR holds the branch
    e.insert("dev/t", _batch([4]))
    pr.publish()
    with pytest.raises(ValueError):
        e.drop_branch("dev")                 # published PR must stay
    #                                          revertible until closed
    pr.close()
    e.drop_branch("dev")
    assert pr.status == "closed"
    with pytest.raises(ValueError):
        pr.close()


def test_noop_publish_and_revert():
    e = mk_engine()
    e.create_branch("dev", ["t"])
    pr = e.open_pr("main", "dev")
    ts0 = e.ts
    reports = pr.publish()
    assert pr.publish_ts is None and e.ts == ts0
    assert reports["t"].inserted == reports["t"].deleted == 0
    assert pr.revert_publish() is None
    with pytest.raises(ValueError):
        pr.publish()                          # reverted, not open


def _full_workflow(side):
    e = mk_engine(side)
    e.create_branch("dev", ["t", "u"])
    e.update_by_keys("dev/t", _batch([2], vals=[999.0]))
    e.insert("dev/u", _batch([30]))
    pr = e.open_pr("main", "dev")
    pr.add_check(lambda ctx: bool((ctx.scan("t")[0]["v"] < 100).all()))
    with pytest.raises(API[side].PublishBlocked):
        pr.publish()
    e.update_by_keys("dev/t", _batch([2], vals=[42.0]))
    pr.publish()
    pr.revert_publish()
    e.drop_branch("dev")
    return (e.ts, sorted(e.tables), {t: digest(e, t) for t in e.tables},
            {i: p.status for i, p in e.prs.items()},
            [(r.kind, r.payload.get("ts")) for r in e.wal],
            [(c.ts, c.table, c.kind, c.inserted, c.deleted)
             for c in e.commit_log])


def test_full_workflow_matches_the_reference():
    ref, port = both(_full_workflow)
    assert port == ref


# ------------------------------------------------------------------- refs

def _refs_engine():
    e = mk_engine()
    e.create_snapshot("night", "t")
    e.create_branch("dev", ["t"])
    return e


def test_resolver_branch_forms():
    e = _refs_engine()
    rr = resolve(e, "branch:dev", table="t")
    assert rr.table == "dev/t"
    assert rr.snapshot.directory is e.table("dev/t").directory
    assert resolve(e, "dev", table="t").table == "dev/t"
    assert resolve(e, "branch:dev", table="dev/t").table == "dev/t"
    assert resolve(e, "main", table="t").table == "t"
    assert resolve(e, "branch:main", table="u").table == "u"
    assert resolve(e, "night").snapshot is e.snapshots["night"]
    assert resolve(e, "u").table == "u"
    with pytest.raises(UnknownRefError):
        resolve(e, "branch:dev")                  # needs a table context
    with pytest.raises(UnknownRefError):
        resolve(e, "branch:dev", table="u")       # dev has no u
    with pytest.raises(UnknownRefError) as exc:
        resolve(e, "branch:dve", table="t")
    assert "dev" in exc.value.suggestions
    assert as_branch(e, "branch:dev") is e.branches["dev"]
    assert as_branch(e, "dev") is e.branches["dev"]
    assert as_branch(e, "main").tables == {"t": "t", "u": "u"}
    assert as_branch(e, "night") is None


def test_resolver_pr_roles():
    e = _refs_engine()
    e.update_by_keys("dev/t", _batch([2], vals=[9.0]))
    pr = e.open_pr("main", "dev")
    base = resolve(e, f"pr:{pr.id}:base").snapshot
    assert base.directory.data_oids == pr.base_pins["t"].directory.data_oids
    assert resolve(e, f"pr:{pr.id}:head").table == "dev/t"
    assert resolve(e, f"pr:{pr.id}").table == "dev/t"       # head default
    with pytest.raises(UnknownRefError):      # not published yet
        resolve(e, f"pr:{pr.id}:merged")
    with pytest.raises(UnknownRefError):
        resolve(e, "pr:9:base")
    with pytest.raises(UnknownRefError):
        resolve(e, f"pr:{pr.id}:base", table="u")
    pr.publish()
    merged = resolve(e, f"pr:{pr.id}:merged").snapshot
    assert merged.directory.data_oids == \
        pr.post_publish["t"].directory.data_oids


def test_bare_name_ambiguity_and_suggestions():
    e = _refs_engine()
    e.create_snapshot("dev", "u")       # a branch and a snapshot share "dev"
    with pytest.raises(AmbiguousRefError) as exc:
        resolve(e, "dev", table="t")
    assert set(exc.value.suggestions) >= {"branch:dev", "snap:dev"}
    with pytest.raises(AmbiguousRefError):
        as_branch(e, "dev")
    assert resolve(e, "branch:dev", table="t").table == "dev/t"
    assert resolve(e, "snap:dev").table == "u"
    with pytest.raises(UnknownRefError) as exc:
        resolve(e, "nigth")
    assert "night" in exc.value.suggestions


def _ref_tables(side):
    e = mk_engine(side)
    e.create_snapshot("night", "t")
    e.create_branch("dev", ["t"])
    e.update_by_keys("dev/t", _batch([2], vals=[9.0]))
    pr = e.open_pr("main", "dev")
    pr.publish()
    res, out = API[side].resolve, []
    for ref, table in (("branch:dev", "t"), ("dev", "t"), ("main", "t"),
                       ("night", None), (f"pr:{pr.id}:base", None),
                       (f"pr:{pr.id}:head", None),
                       (f"pr:{pr.id}:merged", None), ("t~1", None)):
        rr = res(e, ref, table=table)
        out.append((ref, rr.table, rr.snapshot.directory.data_oids,
                    rr.snapshot.directory.tomb_oids))
    return out


def test_ref_forms_resolve_like_the_reference():
    ref, port = both(_ref_tables)
    assert port == ref


# ------------------------------------------- chip_smoke's workflow records

def test_smoke_shape_record_sums_each_kernel_to_its_count():
    C = collections.Counter
    ss, win = C({(262_144, 705): 3, (100_000, 46): 1}), C({(100_000, 46): 2})
    pr = C({(262_144, 4_333): 4})
    seg = C({(200_000, False): 2, (200_000, True): 1})
    launches = {"searchsorted": 6, "probe": 4, "segsum_diff": 3}
    rec = chip_smoke.shape_record(launches, ss, win, pr, seg)
    assert rec["searchsorted_shapes"] == [[100_000, 46, 3],
                                          [262_144, 705, 3]]
    assert rec["zone_window_launches"] == 2
    assert chip_smoke.shape_hist([rec, rec], "segsum_shapes") == C(
        {(200_000, False): 4, (200_000, True): 2})
    # a launch outside the recorded shapes fails the run
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.shape_record(dict(launches, probe=5), ss, win, pr, seg)


def test_smoke_exact_sweep_covers_every_shape_and_launch():
    C = collections.Counter
    hists = {"searchsorted": C({(64, 5): 2, (64, 9): 1, (100, 1): 4}),
             "zone_windows": C({(100, 1): 1}),
             "probe": C({(64, 7): 3, (80, 1): 1}),
             "segsum_diff": C({(50, True): 1, (50, False): 2})}
    out = chip_smoke.exact_sweep(torch, hists, seed=0, device="cpu")
    assert {k: (v["shapes"], v["launches"]) for k, v in out.items()} == {
        k: (len(h), sum(h.values())) for k, h in hists.items()}
    assert all(v["max_abs_err"] == 0.0 for v in out.values())


def test_smoke_path_shapes_record_cpu_calls_as_no_launch():
    names = ("_searchsorted_kernel", "_searchsorted_sides_kernel",
             "_probe_kernel", "_segsum_kernel")
    entries = [getattr(ops, n) for n in names]
    q = from_numpy(np.sort(np.random.default_rng(3).integers(
        0, 2**64 - 1, 32, dtype=np.uint64)))
    with chip_smoke.path_shapes(ops) as hists:
        ops.lower_bound(q, q[::2])
        ops.lower_upper_bound(q, q[:4], 2)
        ops.probe128(q, q, q[::3], q[::3])
    assert not any(hists)
    assert [getattr(ops, n) for n in names] == entries
