"""The port's durable WAL and ``Engine.replay`` against the reference.

Counterparts of ``tests/test_wal_roundtrip.py`` (every record kind, aborted
transactions, seeded random histories), ``tests/test_core_engine.py``'s
replay test, ``tests/test_telemetry.py``'s clean-metrics replay,
``tests/test_workspace.py``'s two replay tests and
``tests/test_sortfree.py``'s two index replay tests: each history runs on
both packages from the same numpy inputs, the port's through
``WAL.serialize`` -> ``WAL.deserialize`` -> ``Engine.replay``, and the
replayed states (ts, commit log, table digests, registries) must equal
the live ones and the reference's. Then the DGWS frames and CRC32C
themselves, held against the reference's bytes.
"""
import pickle
import struct

import numpy as np
import pytest
import torch

import repro.core.compaction as R_comp
import repro.core.wal as R_wal
import repro_torch.core.compaction as P_comp
import repro_torch.core.wal as P_wal
from conftest import kv_batch as _batch
from repro_torch.core import telemetry as p_telemetry
from test_telemetry import PINNED_METRICS
from test_torch_indices import PKG, A, both, digest, log_of, schema, sealed

SCH = (("k", "I64"), ("v", "F64"), ("doc", "LOB"))
WAL_MOD = {"ref": R_wal, "port": P_wal}
COMP = {"ref": R_comp, "port": P_comp}


def engine(side, **kw):
    api = PKG[side][0]
    return api.Engine(**kw) if side == "ref" else api.Engine(device="cpu",
                                                             **kw)


def replay(side, wal):
    api = PKG[side][0]
    if side == "ref":
        return api.Engine.replay(wal)
    return api.Engine.replay(wal, device="cpu")


def roundtrip(side, e):
    """Replay of ``e``'s WAL through its serialized bytes."""
    return replay(side, WAL_MOD[side].WAL.deserialize(e.wal.serialize()))


def digests(e):
    out = {"__ts__": e.ts,
           "__tables__": tuple(sorted(e.tables)),
           "__snapshots__": tuple(sorted(e.snapshots)),
           "__branches__": tuple(sorted(e.branches)),
           "__prs__": tuple(sorted((i, p.status) for i, p in e.prs.items())),
           "__log__": tuple(log_of(e))}
    for name in e.tables:
        out[name] = digest(e, name)
    return out


def assert_replay_equivalent(side, e):
    e2 = roundtrip(side, e)
    assert digests(e2) == digests(e)
    return digests(e2)


def sch(side, pk=True):
    return schema(side, SCH, ("k",) if pk else None)


# ----------------------------------------------------------- histories

def _every_kind(side):
    api, idx = PKG[side]
    e = engine(side)
    e.create_table("t", sch(side))
    e.create_table("n", sch(side, pk=False))
    e.insert("t", _batch([1, 2, 3, 4]))
    e.insert("n", _batch([1, 1, 2], docs=[b"x", b"x", b"y"]))
    e.delete_by_keys("t", {"k": np.asarray([4])})
    e.create_snapshot("s1", "t")
    e.clone_table("c", "s1")
    e.update_by_keys("c", _batch([2], vals=[77.0]))
    api.three_way_merge(e, "t", e.current_snapshot("c"),
                        mode=api.ConflictMode.ACCEPT)
    e.restore_table("c", "s1")
    idx.create_index(e, "t", "by_v", ["v"])
    e.insert("t", _batch([10]))
    idx.drop_index(e, "t", "by_v")
    e.alter_table_add_column("n", api.Column("tag", api.CType.I64), 0)
    COMP[side].compact_objects(e, "t", list(e.table("t").directory.data_oids))
    e.create_snapshot("tmp", "t")
    e.drop_snapshot("tmp")
    e.drop_table("c")
    e.create_branch("dev", ["t"])
    e.update_by_keys("dev/t", _batch([2], vals=[5.0]))
    pr = e.open_pr("main", "dev")
    pr.publish()
    pr.revert_publish()
    pr2 = e.open_pr(None, "dev")
    pr2.close()
    s_a = e.current_snapshot("t")
    e.update_by_keys("t", _batch([1], vals=[44.0]))
    s_b = e.current_snapshot("t")
    e.revert("t", s_a, s_b)
    e.drop_branch("dev")
    assert {r.kind for r in e.wal} == WAL_MOD[side].KINDS, (
        "history must exercise every WAL record kind")
    return assert_replay_equivalent(side, e), sealed(e, "t")


def test_every_record_kind_round_trips():
    assert P_wal.KINDS == R_wal.KINDS
    ref, port = both(_every_kind)
    assert port == ref


def _aborted(side):
    api = PKG[side][0]
    e = engine(side)
    e.create_table("t", sch(side))
    e.insert("t", _batch([1, 2, 3]))
    ts0, oid0 = e.ts, e.store._next_oid
    with pytest.raises(api.PKViolation):
        e.insert("t", _batch([1]))
    assert (e.ts, e.store._next_oid) == (ts0, oid0)
    _, rowids = e.table("t").scan()
    e.delete_by_keys("t", {"k": np.asarray([3])})
    tx = e.begin()
    tx.delete_rowids("t", rowids[-1:])
    with pytest.raises(api.TxnConflict):
        tx.commit()
    assert (e.ts, e.store._next_oid) == (ts0 + 1, oid0 + 1)
    e.update_by_keys("t", _batch([2], vals=[9.0]))
    e.delete_by_keys("t", {"k": np.asarray([1])})
    return assert_replay_equivalent(side, e)


def test_aborted_transactions_leave_no_replay_trace():
    ref, port = both(_aborted)
    assert port == ref


def _random_history(side, seed):
    api = PKG[side][0]
    rng = np.random.default_rng(seed)
    e = engine(side)
    e.create_table("t", sch(side))
    e.create_table("n", sch(side, pk=False))
    next_key = [0]
    live_keys = []
    snap_i = [0]
    open_prs = []
    published = []

    def fresh(nrows):
        ks = list(range(next_key[0], next_key[0] + nrows))
        next_key[0] += nrows
        live_keys.extend(ks)
        return ks

    def op_insert():
        e.insert("t", _batch(fresh(int(rng.integers(1, 20)))))

    def op_insert_nopk():
        k = int(rng.integers(0, 5))
        e.insert("n", _batch([k, k], docs=[b"z", b"z"]))

    def op_update():
        if not live_keys:
            return
        ks = rng.choice(live_keys, size=min(3, len(live_keys)),
                        replace=False)
        e.update_by_keys("t", _batch(ks, vals=rng.random(ks.shape[0])))

    def op_delete():
        if len(live_keys) < 2:
            return
        k = live_keys.pop(int(rng.integers(0, len(live_keys))))
        e.delete_by_keys("t", {"k": np.asarray([k])})

    def op_snapshot():
        e.create_snapshot(f"s{snap_i[0]}", "t")
        snap_i[0] += 1

    def op_drop_snapshot():
        if e.snapshots:
            name = sorted(e.snapshots)[int(rng.integers(0, len(e.snapshots)))]
            e.drop_snapshot(name)

    def op_compact():
        COMP[side].compact_objects(e, "t",
                                   list(e.table("t").directory.data_oids))

    def op_gc():
        e.gc()

    def op_branch_cycle():
        if "dev" in e.branches or not live_keys:
            return
        e.create_branch("dev", ["t"])
        ks = rng.choice(live_keys, size=min(2, len(live_keys)),
                        replace=False)
        e.update_by_keys("dev/t", _batch(ks, vals=rng.random(ks.shape[0])))
        open_prs.append(e.open_pr("main", "dev"))

    def op_publish():
        if not open_prs:
            return
        pr = open_prs.pop()
        pr.publish(mode=api.ConflictMode.ACCEPT)
        if rng.random() < 0.5:
            pr.revert_publish()
        else:
            published.append(pr)

    def op_drop_branch():
        if "dev" not in e.branches:
            return
        for pr in list(open_prs):
            pr.close()
            open_prs.remove(pr)
        for pr in list(published):
            pr.close()
            published.remove(pr)
        e.drop_branch("dev")

    menu = [op_insert, op_insert, op_insert_nopk, op_update, op_update,
            op_delete, op_snapshot, op_drop_snapshot, op_compact, op_gc,
            op_branch_cycle, op_publish, op_drop_branch]
    op_insert()
    for _ in range(40):
        menu[int(rng.integers(0, len(menu)))]()
    return assert_replay_equivalent(side, e)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_history_round_trips(seed):
    ref, port = both(_random_history, seed)
    assert port == ref


def _logical_state(side):
    e = engine(side)
    e.create_table("t", sch(side))
    e.insert("t", _batch([1, 2, 3]))
    e.create_snapshot("s1", "t")
    e.clone_table("c", "s1")
    e.update_by_keys("c", _batch([2], vals=[77.0]))
    e.delete_by_keys("t", {"k": np.asarray([3])})
    e.restore_table("t", "s1")
    e2 = roundtrip(side, e)
    out = {}
    for tbl in ("t", "c"):
        b1, _ = e.table(tbl).scan()
        b2, _ = e2.table(tbl).scan()
        o1, o2 = np.argsort(A(b1["k"])), np.argsort(A(b2["k"]))
        assert np.array_equal(A(b1["k"])[o1], A(b2["k"])[o2])
        assert np.array_equal(A(b1["v"])[o1], A(b2["v"])[o2])
        assert [b1["doc"][i] for i in o1] == [b2["doc"][i] for i in o2]
        out[tbl] = (A(b2["k"])[o2].tolist(), A(b2["v"])[o2].tolist())
    assert e2.ts == e.ts
    return out, e2.ts


def test_wal_replay_reproduces_logical_state():
    ref, port = both(_logical_state)
    assert port == ref


def test_replayed_engine_reports_clean_metrics():
    repo = PKG["port"][0].Repo(device="cpu")
    e = repo.engine
    e.create_table("t", sch("port"))
    tx = e.begin()
    tx.insert("t", _batch(range(1000)))
    tx.commit()
    tx = e.begin()
    tx.update_by_keys("t", _batch(range(50), vals=np.arange(50) * 2.0))
    tx.commit()
    e.create_snapshot("s", "t")
    repo.diff("snap:s", "HEAD", table="t")        # accumulate counters
    assert any(p_telemetry.metrics_snapshot(e).values())
    e2 = roundtrip("port", e)
    snap = p_telemetry.metrics_snapshot(e2)
    assert sorted(snap) == PINNED_METRICS
    assert not any(snap.values()), {k: v for k, v in snap.items() if v}
    assert p_telemetry.current() is None          # no tracer leaked


def _noop_publish(side):
    e = engine(side)
    e.create_table("t", sch(side))
    e.create_table("u", sch(side))
    e.insert("t", _batch([1, 2, 3]))
    e.insert("u", _batch([10, 20]))
    e.create_branch("dev", ["t"])
    pr = e.open_pr("main", "dev")
    reports = pr.publish()
    assert pr.publish_ts is None
    assert reports["t"].inserted == reports["t"].deleted == 0
    assert pr.revert_publish() is None
    return assert_replay_equivalent(side, e)


def test_noop_publish_and_revert_replay():
    ref, port = both(_noop_publish)
    assert port == ref


def _full_workflow(side):
    api = PKG[side][0]
    e = engine(side)
    e.create_table("t", sch(side))
    e.create_table("u", sch(side))
    e.insert("t", _batch([1, 2, 3]))
    e.insert("u", _batch([10, 20]))
    e.create_branch("dev", ["t", "u"])
    e.update_by_keys("dev/t", _batch([2], vals=[999.0]))
    e.insert("dev/u", _batch([30]))
    pr = e.open_pr("main", "dev")
    pr.add_check(lambda ctx: bool((ctx.scan("t")[0]["v"] < 100).all()))
    with pytest.raises(api.PublishBlocked):
        pr.publish()
    e.update_by_keys("dev/t", _batch([2], vals=[42.0]))
    pr.publish()
    pr.revert_publish()
    e.drop_branch("dev")
    # the replayed publish re-applies without its (in-process) checks
    return assert_replay_equivalent(side, e)


def test_full_workflow_e2e_wal_replay():
    ref, port = both(_full_workflow)
    assert port == ref


def test_replay_publishes_with_skip_checks():
    """A logged publish replays with ``_skip_checks=True``: a check that
    would now fail does not block the replayed publish."""
    api = PKG["port"][0]
    e = engine("port")
    e.create_table("t", sch("port"))
    e.insert("t", _batch([1, 2, 3]))
    e.create_branch("dev", ["t"])
    e.update_by_keys("dev/t", _batch([2], vals=[5.0]))
    pr = e.open_pr("main", "dev")
    pr.publish()
    e2 = roundtrip("port", e)
    assert e2.prs[1].status == "published"
    assert digests(e2) == digests(e)
    # the keyword itself: a registered failing check is skipped
    e3 = engine("port")
    e3.create_table("t", sch("port"))
    e3.insert("t", _batch([1]))
    e3.create_branch("dev", ["t"])
    e3.insert("dev/t", _batch([9]))
    pr3 = e3.open_pr("main", "dev")
    pr3.add_check(lambda ctx: False, "never")
    with pytest.raises(api.PublishBlocked):
        pr3.publish()
    pr3.publish(_skip_checks=True)
    assert pr3.status == "published"


def _indexed(side, n=50):
    api, idx = PKG[side]
    e = engine(side)
    e.create_table("T", schema(side, (("id", "I64"), ("cat", "I32"),
                                      ("val", "F64")), ("id",)))
    e.insert("T", {"id": np.arange(n), "cat": np.arange(n) % 5,
                   "val": np.arange(n) * 1.0})
    idx.create_index(e, "T", "by_cat", ["cat"])
    return e


def _lookup(side, e, table, cat):
    return sorted(A(PKG[side][1].lookup_eq(
        e, table, "by_cat", {"cat": np.int32(cat)})["id"]).tolist())


def _clone_indices_replay(side):
    e = _indexed(side)
    snap = e.create_snapshot("s", "T")
    e.clone_table("C", snap, with_indices=True)
    e2 = roundtrip(side, e)
    assert [s.name for s in e2.indices.get("C", [])] == ["by_cat"]
    assert _lookup(side, e2, "C", 3) == _lookup(side, e, "C", 3)
    return digests(e2), _lookup(side, e2, "C", 3)


def test_replay_preserves_clone_with_indices():
    ref, port = both(_clone_indices_replay)
    assert port == ref


def _clone_drop_replay(side):
    e = _indexed(side)
    e.create_snapshot("s", "T")
    e.clone_table("C", "s", with_indices=True)
    aux_t = e.indices["T"][0].aux_table
    e.drop_table("T")
    e2 = roundtrip(side, e)
    assert set(e2.tables) == set(e.tables)
    assert "T" not in e2.indices and aux_t not in e2.tables
    assert [s.name for s in e2.indices.get("C", [])] == ["by_cat"]
    assert _lookup(side, e2, "C", 2) == [i for i in range(50) if i % 5 == 2]
    return digests(e2)


def test_replay_roundtrip_clone_indices_and_drop_table():
    ref, port = both(_clone_drop_replay)
    assert port == ref


def test_torn_trailing_commit_group_is_dropped_whole():
    """A multi-table commit logged short of its ``ntab`` records at the
    tail is dropped whole (also from the adopted log); mid-log it is
    refused with ``TornTransaction``."""
    e = engine("port")
    e.create_table("a", sch("port"))
    e.create_table("b", sch("port"))
    e.insert("a", _batch([1]))
    before = digests(e)
    tx = e.begin()
    tx.insert("a", _batch([2]))
    tx.insert("b", _batch([3]))
    tx.commit()
    torn = P_wal.WAL()
    torn.records = list(e.wal.records[:-1])      # one of the group's two
    e2 = replay("port", torn)
    assert digests(e2) == before
    assert len(e2.wal.records) == len(e.wal.records) - 2
    mid = P_wal.WAL()
    mid.records = list(e.wal.records[:-1]) + [P_wal.WalRecord(
        "snapshot", {"name": "x", "table": "a"})]
    with pytest.raises(P_wal.TornTransaction):
        replay("port", mid)


def test_records_go_out_as_numpy_and_replay_onto_the_device():
    e = engine("port")
    e.create_table("t", sch("port"))
    e.insert("t", _batch([1, 2, 3]))
    e.delete_by_keys("t", {"k": np.asarray([2])})
    assert torch.is_tensor(e.wal.records[-1].payload["deletes"])
    w = P_wal.WAL.deserialize(e.wal.serialize())

    def tensors(x):
        if torch.is_tensor(x):
            return 1
        if isinstance(x, dict):
            return sum(tensors(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(tensors(v) for v in x)
        return 0
    assert sum(tensors(r.payload) for r in w.records) == 0
    ins = w.records[1].payload["inserts"][0]
    assert isinstance(ins["k"], np.ndarray) and ins["k"].tolist() == [1, 2, 3]
    e2 = replay("port", w)
    newest = e2.store.get(e2.table("t").directory.data_oids[-1])
    assert newest.row_lo.device == e2.device
    assert digests(e2) == digests(e)


def test_replay_defaults_to_the_card():
    """``Engine.replay(wal)`` without a device means the card: without one
    it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: replay would run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PKG["port"][0].Engine.replay(P_wal.WAL())


# ------------------------------------------------------------ frames

def test_frames_equal_the_reference_bytes():
    payload = bytes(np.random.default_rng(0).integers(0, 256, 777,
                                                      dtype=np.uint8))
    assert P_wal.STORE_HEADER == R_wal.STORE_HEADER
    assert P_wal.encode_frame(payload) == R_wal.encode_frame(payload)
    blob = P_wal.STORE_HEADER + P_wal.encode_frame(b"a") + \
        P_wal.encode_frame(b"bc")
    assert list(P_wal.iter_frames(blob, 8)) == list(R_wal.iter_frames(blob,
                                                                      8))
    assert P_wal.check_store_header(blob) == R_wal.check_store_header(blob)


def test_typed_frame_errors():
    blob = P_wal.STORE_HEADER + P_wal.encode_frame(b"first") + \
        P_wal.encode_frame(b"second")
    # a torn tail: the last frame cut short, and a torn length prefix
    for cut in (3, len(blob) - 8 - 13 - 2):
        with pytest.raises(P_wal.TornFrame) as exc:
            list(P_wal.iter_frames(blob[:-cut], 8))
        assert exc.value.clean_end == 8 + P_wal.FRAME_OVERHEAD + 5
        assert blob[:-cut][exc.value.clean_end:] == exc.value.tail
    # a flipped bit inside the second frame's payload
    bad = bytearray(blob)
    bad[-2] ^= 0x01
    with pytest.raises(P_wal.CorruptFrame) as exc:
        list(P_wal.iter_frames(bytes(bad), 8))
    assert exc.value.frame_index == 1
    assert exc.value.offset == 8 + P_wal.FRAME_OVERHEAD + 5
    # other versions and other files
    with pytest.raises(P_wal.StoreVersionError, match="version 2"):
        P_wal.check_store_header(b"DGWS\x02\x00\x00\x00")
    with pytest.raises(P_wal.StoreVersionError, match="bad magic"):
        P_wal.check_store_header(b"NOPE....")
    with pytest.raises(P_wal.StoreVersionError, match="truncated"):
        P_wal.check_store_header(b"DGWS\x01")
    assert issubclass(P_wal.TornFrame, P_wal.StoreFormatError)
    # the legacy headerless pickle path
    legacy = pickle.dumps([P_wal.WalRecord("snapshot", {"name": "s",
                                                       "table": "t"})])
    assert P_wal.check_store_header(legacy) == -1
    assert [r.kind for r in P_wal.WAL.deserialize(legacy)] == ["snapshot"]
    # a corrupt serialized WAL refuses to deserialize
    e = engine("port")
    e.create_table("t", sch("port"))
    raw = bytearray(e.wal.serialize())
    raw[-1] ^= 0xFF
    with pytest.raises(P_wal.CorruptFrame):
        P_wal.WAL.deserialize(bytes(raw))
    assert struct.calcsize("<II") == P_wal.FRAME_OVERHEAD


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1000, 4097])
def test_crc32c_equals_the_reference_under_both_implementations(n):
    data = bytes(np.random.default_rng(n).integers(0, 256, n,
                                                   dtype=np.uint8))
    want = R_wal.crc32c(data)
    assert P_wal.crc32c(data) == want
    assert P_wal._py_crc32c(data) == want
    assert P_wal.CRC32C_IMPL == R_wal.CRC32C_IMPL
    # the standard check value of CRC-32C
    assert P_wal._py_crc32c(b"123456789") == 0xE3069283
