"""The port's secondary indices, ALTER TABLE ADD COLUMN and materialized
clones against the reference.

Counterparts of every test of ``tests/test_indices_schema.py`` and of
``tests/test_apply_carry.py``'s LOB-default, materialize and materialize
replay tests. Each scenario runs on both packages (``repro`` and
``repro_torch`` with ``device="cpu"``) from the same seeded numpy inputs;
the results must be equal, the tables' content digests equal, and the
sealed objects (oids, lanes, payload bytes) equal byte for byte.
"""
import hashlib

import numpy as np
import pytest

import repro.core as R
import repro.core.indices as R_idx
import repro_torch.core as P
import repro_torch.core.indices as P_idx
from chip_smoke import content_digest as digest
from repro.configs.paper_vcs import gen_lineitem
from repro_torch.benchmarks.vcs_tables import _mk_engine as p_mk_lineitem
from repro_torch.interop import to_numpy

# each package: its core API and its indices module
PKG = {"ref": (R, R_idx), "port": (P, P_idx)}
SIDES = tuple(PKG)


def new_engine(side, **kw):
    api = PKG[side][0]
    return api.Engine(**kw) if side == "ref" else api.Engine(device="cpu",
                                                             **kw)


def lineitem_engine(side, pk, n, seed=0):
    if side == "ref":
        from benchmarks.vcs_tables import _mk_engine as r_mk_lineitem
        return r_mk_lineitem(n, pk, seed=seed)
    return p_mk_lineitem(n, pk, seed=seed, device="cpu")


def both(scenario, *args):
    """``scenario(side, *args)`` on each package; returns (ref, port)."""
    return tuple(scenario(side, *args) for side in SIDES)


def A(x) -> np.ndarray:
    """numpy of a column or lane of either package (uint64 words of the
    port, stored as int64, viewed back as uint64)."""
    return np.asarray(to_numpy(x, u64=True))


def L(x) -> list:
    return sorted(A(x).tolist())


def sealed(engine, table):
    """(oid, nrows, sha256) of every data object of ``table``'s head: the
    payload columns' bytes, commit ts, row/key signatures and LOB content
    signatures, in sealed order."""
    out = []
    for oid in engine.table(table).directory.data_oids:
        o = engine.store.get(oid)
        h = hashlib.sha256()
        for name in sorted(o.cols):
            v = o.cols[name]
            if isinstance(v, np.ndarray) and v.dtype == object:
                h.update(b"\0".join(v.tolist()))
            else:
                h.update(np.ascontiguousarray(A(v)).tobytes())
        for lane in (o.commit_ts, o.row_lo, o.row_hi, o.key_lo, o.key_hi):
            h.update(A(lane).astype(np.uint64).tobytes())
        for c in sorted(o.lob_sigs):
            h.update(A(o.lob_sigs[c]).tobytes())
        out.append((oid, o.nrows, h.hexdigest()))
    return out


def log_of(engine):
    return [(r.ts, r.table, r.kind, r.inserted, r.deleted)
            for r in engine.commit_log]


def schema(side, cols, pk):
    api = PKG[side][0]
    return api.Schema(tuple(api.Column(n, getattr(api.CType, t))
                            for n, t in cols), primary_key=pk)


SCH = (("id", "I64"), ("cat", "I32"), ("val", "F64"))


def _setup(side, n=100):
    e = new_engine(side)
    e.create_table("T", schema(side, SCH, ("id",)))
    e.insert("T", {"id": np.arange(n), "cat": np.arange(n) % 5,
                   "val": np.arange(n) * 1.0})
    return e


def _lookup(side, e, table, cat):
    return L(PKG[side][1].lookup_eq(e, table, "by_cat",
                                    {"cat": np.int32(cat)})["id"])


def _state(e, *tables):
    return (e.ts, log_of(e), {t: digest(e, t) for t in tables},
            {t: sealed(e, t) for t in tables})


# ------------------------------------------------------------ indices

def _backfill(side):
    e = _setup(side)
    spec = PKG[side][1].create_index(e, "T", "by_cat", ["cat"])
    return _lookup(side, e, "T", 3), _state(e, "T", spec.aux_table)


def test_index_backfill_and_lookup():
    ref, port = both(_backfill)
    assert port[0] == [i for i in range(100) if i % 5 == 3]
    assert port == ref


def _maintained(side):
    e = _setup(side)
    spec = PKG[side][1].create_index(e, "T", "by_cat", ["cat"])
    e.insert("T", {"id": [1000], "cat": [3], "val": [1.0]})
    e.update_by_keys("T", {"id": [3], "cat": [4], "val": [3.0]})
    e.delete_by_keys("T", {"id": np.asarray([8])})
    return (_lookup(side, e, "T", 3), _lookup(side, e, "T", 4),
            _state(e, "T", spec.aux_table))


def test_index_maintained_on_insert_update_delete():
    ref, port = both(_maintained)
    want = sorted([i for i in range(100) if i % 5 == 3
                   and i not in (3, 8)] + [1000])
    assert port[0] == want and 3 in port[1]
    assert port == ref


def _atomic(side):
    e = _setup(side)
    spec = PKG[side][1].create_index(e, "T", "by_cat", ["cat"])
    ts0 = e.ts
    tx = e.begin()
    tx.update_by_keys("T", {"id": [0], "cat": [9], "val": [0.0]})
    tx.insert("T", {"id": [2000], "cat": [9], "val": [2.0]})
    tx.commit()
    return (_lookup(side, e, "T", 9), e.ts - ts0,
            _state(e, "T", spec.aux_table))


def test_index_maintenance_is_atomic_with_base_commit():
    ref, port = both(_atomic)
    assert port[0] == [0, 2000] and port[1] == 1   # ONE commit, base + aux
    assert port == ref


def _clone_with_indices(side):
    e = _setup(side)
    PKG[side][1].create_index(e, "T", "by_cat", ["cat"])
    e.create_snapshot("s", "T")
    e.clone_table("C", "s", with_indices=True)
    e.update_by_keys("C", {"id": [0], "cat": [7], "val": [0.0]})
    return (_lookup(side, e, "C", 7), _lookup(side, e, "T", 7),
            sorted(e.tables), _state(e, "C", "__idx_C_by_cat"))


def test_clone_with_indices_is_independent():
    ref, port = both(_clone_with_indices)
    assert port[0] == [0] and port[1] == []
    assert port == ref


def _replayed_index(side):
    e = _setup(side, 20)
    PKG[side][1].create_index(e, "T", "by_cat", ["cat"])
    e.insert("T", {"id": [500], "cat": [2], "val": [5.0]})
    api = PKG[side][0]
    if side == "ref":
        e2 = api.Engine.replay(e.wal)
    else:
        e2 = api.Engine.replay(e.wal, device="cpu")
        # and through the durable format
        e3 = api.Engine.replay(api.WAL.deserialize(e.wal.serialize()),
                               device="cpu")
        assert _state(e3, "T", "__idx_T_by_cat") == _state(
            e, "T", "__idx_T_by_cat")
    assert _lookup(side, e2, "T", 2) == _lookup(side, e, "T", 2)
    return _lookup(side, e2, "T", 2), _state(e2, "T", "__idx_T_by_cat")


def test_index_survives_wal_replay():
    ref, port = both(_replayed_index)
    assert 500 in port[0]
    assert port == ref


def _dropped(side):
    e = _setup(side, 10)
    idx = PKG[side][1]
    spec = idx.create_index(e, "T", "by_cat", ["cat"])
    assert spec.aux_table in e.tables
    idx.drop_index(e, "T", "by_cat")
    assert spec.aux_table not in e.tables
    # a dropped base table takes its remaining indices with it
    idx.create_index(e, "T", "by_val", ["val"])
    e.drop_table("T")
    return sorted(e.tables), dict(e.indices), [r.kind for r in e.wal]


def test_drop_index():
    ref, port = both(_dropped)
    assert port[0] == [] and port[1] == {}
    assert port == ref


def test_lookup_eq_is_a_device_mask_of_the_aux_table():
    e = _setup("port", 50)
    P_idx.create_index(e, "T", "by_cat", ["cat"])
    hits = P_idx.lookup_eq(e, "T", "by_cat", {"cat": 2})
    assert hits["id"].device == e.device
    assert L(hits["id"]) == list(range(2, 50, 5))
    # a one-element array or tensor probes the same value
    assert L(P_idx.lookup_eq(e, "T", "by_cat",
                             {"cat": np.asarray([2])})["id"]) == L(hits["id"])


# ------------------------------------------------------------ ALTER TABLE

def _alter_pitr(side):
    api = PKG[side][0]
    e = _setup(side, 10)
    pre = e.create_snapshot("pre-alter", "T")
    e.alter_table_add_column("T", api.Column("note", api.CType.LOB), b"-")
    batch, _ = e.table("T").scan()
    assert "note" in batch and all(v == b"-" for v in batch["note"])
    altered = _state(e, "T")
    e.insert("T", {"id": [99], "cat": [1], "val": [9.0], "note": [b"hi"]})
    assert e.table("T").count() == 11
    with pytest.raises(ValueError):
        api.snapshot_diff(e.store, pre, e.current_snapshot("T"))
    e.restore_table("T", "pre-alter")
    batch, _ = e.table("T").scan()
    assert "note" not in batch
    return altered, e.table("T").count(), _state(e, "T")


def test_alter_add_column_and_pitr_restore():
    ref, port = both(_alter_pitr)
    assert port[1] == 10
    assert port == ref


def _alter_identity(side):
    api = PKG[side][0]
    e = _setup(side, 10)
    e.alter_table_add_column("T", api.Column("flag", api.CType.BOOL), False)
    s1 = e.create_snapshot("s1", "T")
    e.clone_table("C", "s1")
    e.update_by_keys("C", {"id": [2], "cat": [2], "val": [22.0],
                           "flag": [True]})
    d = api.snapshot_diff(e.store, s1, e.current_snapshot("C"))
    return d.n_groups, L(d.diff_cnt), _state(e, "T", "C")


def test_alter_preserves_row_identity_within_new_schema():
    ref, port = both(_alter_identity)
    assert port[0] == 2
    assert port == ref


def _alter_lob_default(side):
    api = PKG[side][0]
    engine, _ = lineitem_engine(side, True, 300)
    engine.commit_stats = api.CommitStats()
    engine.alter_table_add_column("lineitem", api.Column("note",
                                                         api.CType.LOB),
                                  "hello")
    batch, _ = engine.table("lineitem").scan()
    assert batch["note"][0] == b"hello" and isinstance(batch["note"][0],
                                                      bytes)
    with pytest.raises(TypeError):
        engine.alter_table_add_column("lineitem",
                                      api.Column("n2", api.CType.LOB), 7)
    return vars(engine.commit_stats), _state(engine, "lineitem")


def test_alter_add_lob_column_normalizes_str_default():
    ref, port = both(_alter_lob_default)
    st = port[0]
    assert st["rows_rehashed"] == 300      # row sigs genuinely change
    assert st["lob_rows_hashed"] == 300    # only the NEW column hashes
    assert st["apply_sorts"] == 0          # PK runs carried through
    assert port == ref


@pytest.mark.parametrize("pk", [True, False])
def test_alter_on_a_multi_object_table_matches_the_reference(pk):
    """ALTER after updates (several objects, tombstones): PK keeps its
    key signatures and runs, NoPK re-sorts on its new row signatures."""
    def scenario(side):
        api = PKG[side][0]
        engine, base = lineitem_engine(side, pk, 1200)
        rng = np.random.default_rng([4, int(pk)])
        _update(side, engine, "lineitem", base,
                np.sort(rng.choice(1200, 150, False)), pk)
        engine.commit_stats = api.CommitStats()
        engine.alter_table_add_column("lineitem",
                                      api.Column("l_flag", api.CType.I64), 0)
        return vars(engine.commit_stats), _state(engine, "lineitem")
    ref, port = both(scenario)
    assert port[0]["rows_rehashed"] == 1200
    assert port[0]["lob_rows_hashed"] == 0
    assert port == ref


# ------------------------------------------------------ materialized clone

def _update(side, engine, table, base, idx, pk, tag=1):
    """``tests/test_apply_carry.py``'s update, on either package."""
    newvals = {k: v[idx].copy() for k, v in base.items()}
    newvals["l_quantity"] = newvals["l_quantity"] + 1.0 + tag
    newvals["l_comment"] = np.array(
        [b"carry-%d-%d" % (tag, i) for i in range(idx.shape[0])], object)
    tx = engine.begin()
    if pk:
        tx.update_by_keys(table, newvals)
    else:
        _, rowids = engine.table(table).scan()
        rowids = A(rowids)
        tx.delete_rowids(table, rowids[idx])
        tx.insert(table, newvals)
    tx.commit()


def _materialize(side, pk):
    api = PKG[side][0]
    engine, base = lineitem_engine(side, pk, 3000)
    rng = np.random.default_rng([3, int(pk)])
    _update(side, engine, "lineitem", base,
            np.sort(rng.choice(3000, 200, False)), pk)
    snap = engine.create_snapshot("s", "lineitem")
    engine.commit_stats = api.CommitStats()
    engine.clone_table("mat", snap, materialize=True)
    st = vars(engine.commit_stats)
    assert not (set(engine.table("mat").directory.data_oids)
                & set(engine.table("lineitem").directory.data_oids))
    d = api.snapshot_diff(engine.store, engine.current_snapshot("lineitem"),
                          engine.current_snapshot("mat"))
    assert d.is_empty()
    return st, digest(engine, "lineitem"), _state(engine, "mat")


@pytest.mark.parametrize("pk", [True, False])
def test_clone_materialize_zero_rehash_and_equal(pk):
    ref, port = both(_materialize, pk)
    st = port[0]
    assert st["rows_rehashed"] == 0 and st["lob_rows_hashed"] == 0
    assert st["rows_carried"] == 3000
    assert port[1] == port[2][2]["mat"]    # same content as the source
    assert port == ref


def _materialize_replay(side):
    api = PKG[side][0]
    engine, _ = lineitem_engine(side, True, 800)
    snap = engine.create_snapshot("s", "lineitem")
    engine.clone_table("mat", snap, materialize=True)
    extra = {k: v[:5].copy() for k, v in gen_lineitem(900, seed=9).items()}
    extra["l_orderkey"] = extra["l_orderkey"] + 10_000_000  # fresh keys
    engine.insert("mat", extra)
    if side == "ref":
        replayed = api.Engine.replay(engine.wal)
    else:
        replayed = api.Engine.replay(
            api.WAL.deserialize(engine.wal.serialize()), device="cpu")
    a = engine.table("mat").scan(with_sigs=True)
    b = replayed.table("mat").scan(with_sigs=True)
    assert np.array_equal(A(a[1]), A(b[1]))
    assert np.array_equal(A(a[2]), A(b[2]))
    return _state(replayed, "lineitem", "mat")


def test_clone_materialize_wal_replay():
    ref, port = both(_materialize_replay)
    assert port == ref


def test_lob_index_lookup_by_str_equals_lookup_by_bytes():
    """A LOB-indexed lookup takes a str as its bytes, as an insert does;
    the reference raises TypeError there (``bytes(str)`` without an
    encoding, ``src/repro/core/indices.py:117-121``; ROADMAP Queue 3)."""
    got = {}
    for side in SIDES:
        api, idx = PKG[side]
        e = new_engine(side)
        e.create_table("D", schema(side, (("id", "I64"), ("doc", "LOB")),
                                   ("id",)))
        e.insert("D", {"id": np.arange(6),
                       "doc": [b"a", b"b", b"a", b"c", b"a", b"b"]})
        idx.create_index(e, "D", "by_doc", ["doc"])
        got[side] = L(idx.lookup_eq(e, "D", "by_doc", {"doc": b"a"})["id"])
        if side == "ref":
            with pytest.raises(TypeError):
                idx.lookup_eq(e, "D", "by_doc", {"doc": "a"})
        else:
            assert L(idx.lookup_eq(e, "D", "by_doc",
                                   {"doc": "a"})["id"]) == got[side]
    assert got["port"] == got["ref"] == [0, 2, 4]
