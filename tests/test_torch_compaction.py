"""The port's compaction and ``DiffResult.per_key_conflicts`` against the
reference.

Counterparts of ``tests/test_property.py::test_compaction_preserves_
content_and_diffs`` (hypothesis, the same edit scripts on both packages),
``tests/test_diff_merge.py::test_compaction_move_is_false_conflict`` and
``tests/test_visibility_cache.py``'s compaction and per-key-conflict
tests; the compacted objects' sealed bytes (oids, lanes, payload) must
equal the reference's.
"""
from collections import Counter

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.compaction as R_comp
import repro_torch.core.compaction as P_comp
from conftest import kv_batch
from test_torch_indices import (PKG, A, L, both, digest, log_of,
                                new_engine, schema, sealed)

KV = (("k", "I64"), ("v", "I64"))


COMPACTION = {"ref": R_comp, "port": P_comp}


def _compaction(side):
    return COMPACTION[side].compact_objects


def rows_multiset(e, table, directory=None) -> Counter:
    batch, _ = e.table(table).scan(directory)
    return Counter(zip(A(batch["k"]).tolist(), A(batch["v"]).tolist()))


def fresh(side, pk=True, n=10):
    e = new_engine(side)
    e.create_table("T", schema(side, KV, ("k",) if pk else None))
    e.insert("T", {"k": np.arange(n), "v": np.full(n, 100)})
    return e


def apply_script(e, table, script, model: Counter):
    """``tests/test_property.py``'s edit-script driver (PK tables)."""
    for op, key, val in script:
        present = [kv for kv in model if kv[0] == key]
        if op == "ins" and not present:
            e.insert(table, {"k": [key], "v": [val]})
            model[(key, val)] += 1
        elif op == "del" and present:
            e.delete_by_keys(table, {"k": np.asarray([key])})
            for kv in present:
                del model[kv]
        elif op == "upd" and present:
            e.update_by_keys(table, {"k": [key], "v": [val]})
            for kv in present:
                del model[kv]
            model[(key, val)] += 1


edit = st.tuples(st.sampled_from(["ins", "del", "upd"]),
                 st.integers(0, 39), st.integers(0, 5))
scripts = st.lists(edit, max_size=12)


def _compact_script(side, script):
    e = fresh(side)
    e.create_snapshot("s", "T")
    e.clone_table("U", "s")
    model = Counter({(k, 100): 1 for k in range(10)})
    apply_script(e, "T", script, model)
    before = rows_multiset(e, "T")
    d_before = PKG[side][0].snapshot_diff(e.store, e.snapshots["s"],
                                          e.current_snapshot("T"))
    written = _compaction(side)(e, "T", list(e.table("T").directory.data_oids))
    assert rows_multiset(e, "T") == before == model
    d_after = PKG[side][0].snapshot_diff(e.store, e.snapshots["s"],
                                         e.current_snapshot("T"))
    assert L(d_before.diff_cnt) == L(d_after.diff_cnt)
    assert rows_multiset(e, "T", e.snapshots["s"].directory) == \
        Counter({(k, 100): 1 for k in range(10)})
    return (written, e.ts, log_of(e), e.table("T").directory.tomb_oids,
            digest(e, "T"), sealed(e, "T"), [r.kind for r in e.wal])


@settings(max_examples=25, deadline=None)
@given(scripts)
def test_compaction_preserves_content_and_diffs(script):
    ref, port = both(_compact_script, script)
    assert port == ref


def _move(side):
    api = PKG[side][0]
    e = new_engine(side)
    sch = schema(side, (("a", "I64"), ("v", "F64"), ("doc", "LOB")),
                 ("a",))
    e.create_table("T", sch)
    b = kv_batch(np.arange(50))
    e.insert("T", {"a": b["k"], "v": b["v"], "doc": b["doc"]})
    sn1 = e.create_snapshot("sn1", "T")
    e.clone_table("TClone", "sn1")
    e.delete_by_keys("T", {"a": np.asarray([49])})   # a dead row
    _compaction(side)(e, "T", list(e.table("T").directory.data_oids))
    e.update_by_keys("TClone", {"a": [10], "v": [1000.0], "doc": [b"d10"]})
    rep = api.three_way_merge(e, "T", e.current_snapshot("TClone"),
                              base=sn1, mode=api.ConflictMode.FAIL)
    batch, _ = e.table("T").scan()
    rows = dict(zip(A(batch["a"]).tolist(), A(batch["v"]).tolist()))
    return (rep.true_conflicts, rep.moves_ignored > 0, rows[10],
            sealed(e, "T"), digest(e, "T"))


def test_compaction_move_is_false_conflict():
    ref, port = both(_move)
    assert port[:3] == (0, True, 1000.0)          # update NOT lost
    assert port == ref


def _no_stale(side):
    e = fresh(side, n=40)
    e.delete_by_keys("T", {"k": np.array([3, 5, 7])})
    before, _ = e.table("T").scan()
    _compaction(side)(e, "T", list(e.table("T").directory.data_oids))
    after, _ = e.table("T").scan()
    assert L(before["k"]) == L(after["k"])
    assert e.table("T").directory.tomb_oids == ()  # tombs died with targets
    return sealed(e, "T"), e.ts


def test_no_stale_visibility_after_compaction():
    ref, port = both(_no_stale)
    assert port == ref


@pytest.mark.parametrize("pk", [True, False])
def test_compact_table_policy_and_replay_match_the_reference(pk):
    """Policy-driven compaction over several small objects with dead rows,
    then a replay of the WAL (the ``compact`` record carries its ts)."""
    def scenario(side):
        api = PKG[side][0]
        e = fresh(side, pk, n=60)
        rng = np.random.default_rng([11, int(pk)])
        for step in range(4):
            ks = np.sort(rng.choice(60, 6, replace=False))
            if pk:
                e.update_by_keys("T", {"k": ks, "v": np.full(6, step)})
            else:
                _, rid = e.table("T").scan()
                tx = e.begin()
                tx.delete_rowids("T", A(rid)[ks])
                tx.insert("T", {"k": ks, "v": np.full(6, step)})
                tx.commit()
        picked = list(COMPACTION[side].pick_compaction_sources(e, "T"))
        n_objs = len(e.table("T").directory.data_oids)
        written = api.compact_table(e, "T")
        assert len(e.table("T").directory.data_oids) < n_objs
        wal = e.wal.serialize() if side == "port" else None
        e2 = (api.Engine.replay(e.wal) if side == "ref" else
              api.Engine.replay(api.WAL.deserialize(wal), device="cpu"))
        assert (e2.ts, log_of(e2), sealed(e2, "T")) == (
            e.ts, log_of(e), sealed(e, "T"))
        return picked, written, e.ts, sealed(e, "T"), digest(e, "T")
    ref, port = both(scenario)
    assert port == ref


def _per_key(side):
    api = PKG[side][0]
    e = fresh(side, n=20)
    s1 = e.create_snapshot("s1", "T")
    e.clone_table("t2", s1)
    # T: update keys 0,1 ; t2: update keys 1,2 -> every touched key has a
    # version on both sides
    e.update_by_keys("T", {"k": np.array([0, 1]), "v": np.array([5, 5])})
    e.update_by_keys("t2", {"k": np.array([1, 2]), "v": np.array([6, 6])})
    d = api.snapshot_diff(e.store, e.current_snapshot("T"),
                          e.current_snapshot("t2"))
    groups = d.per_key_conflicts()
    for grp in groups:
        sg = np.sign(A(d.diff_cnt)[A(grp)])
        assert (sg > 0).any() and (sg < 0).any()
        assert np.unique(A(d.key_lo)[A(grp)]).shape[0] == 1
    empty = api.snapshot_diff(e.store, e.current_snapshot("T"),
                              e.current_snapshot("T"))
    assert empty.per_key_conflicts() == []
    return [A(g).tolist() for g in groups]


def test_per_key_conflicts_vectorized():
    ref, port = both(_per_key)
    assert len(port) == 3
    assert port == ref


@pytest.mark.parametrize("pk", [True, False])
def test_per_key_conflicts_on_larger_diffs_match_the_reference(pk):
    """Two clones of one snapshot, each updated on 60 keys, 30 of them
    shared: PK groups every touched key; NoPK keys are row values, so no
    key holds both signs."""
    def scenario(side):
        api = PKG[side][0]
        e = fresh(side, pk, n=400)
        s = e.create_snapshot("s", "T")
        e.clone_table("a", s)
        e.clone_table("b", s)
        for name, keys, v in (("a", np.arange(0, 60), 7),
                              ("b", np.arange(30, 90), 8)):
            if pk:
                e.update_by_keys(name, {"k": keys, "v": np.full(60, v)})
            else:
                _, rid = e.table(name).scan()
                tx = e.begin()
                tx.delete_rowids(name, A(rid)[keys])
                tx.insert(name, {"k": keys, "v": np.full(60, v)})
                tx.commit()
        d = api.snapshot_diff(e.store, e.current_snapshot("a"),
                              e.current_snapshot("b"))
        return d.n_groups, [A(g).tolist() for g in d.per_key_conflicts()]
    ref, port = both(scenario)
    assert len(port[1]) == (90 if pk else 0)
    assert port == ref
