"""The port's tiered store and remotes, side by side with the reference.

Counterparts of ``tests/test_store_tiers.py``: tier transparency (spill,
evict and fault-in never change what a reader sees; LRU ``shrink_heap``;
GC releases pack files; a recycled oid never serves stale bytes; an
evicted object's device lanes are no longer reachable from the store or
its caches); remote exchange (push, pull and fetch move only the missing
objects, with the reference's counts and bytes; diverged pushes and
pulls are refused; a shallow clone faults objects in on first read; pulls
rehash no row); the crash sweeps of every ``torch.store.*`` point at every
hit, all-or-nothing with fsck clean; the status surface and the CLI's
two-repo round trip; and ``GOLDEN_APPLY`` from an evicted store.
"""
import gc
import os
import weakref

import numpy as np
import pytest
import torch

import repro.core as R
import repro.store as RS
import repro.store.remote as R_remote
import repro_torch.core as P
import repro_torch.core.wal as P_wal
import repro_torch.store as PS
import repro_torch.store.remote as P_remote
import repro_torch.vcs_cli as P_cli
from conftest import kv_batch as _batch
from repro_torch.benchmarks import digests as p_digests
from repro_torch.core import faults, telemetry
from test_diff_digest import GOLDEN_APPLY
from test_torch_indices import digest, schema
from test_torch_wal import digests

SCH = (("k", "I64"), ("v", "F64"), ("doc", "LOB"))
API = {"ref": R, "port": P}
STORE = {"ref": RS, "port": PS}
REMOTE = {"ref": R_remote, "port": P_remote}
STORE_POINTS = sorted(p for p in faults.registered()
                      if p.startswith("torch.store."))


def engine(side):
    return R.Engine() if side == "ref" else P.Engine(device="cpu")


def seed(side, root=None, rows=60):
    e = engine(side)
    if root is not None:
        STORE[side].attach_packs(e.store, root)
    e.create_table("t", schema(side, SCH, ("k",)))
    e.insert("t", _batch(range(rows)))
    return e


def pull(side, e, remote, pack_dir=None):
    return REMOTE[side].pull(e, remote, pack_dir)


def counters(e):
    return telemetry.stats_json(e)["metrics"]


# --------------------------------------------------------------------------
# tier transparency
# --------------------------------------------------------------------------

def test_spill_evict_fault_digest_identity(tmp_path):
    e = seed("port", str(tmp_path / "packs"))
    e.create_snapshot("s1", "t")
    e.update_by_keys("t", _batch(range(10), vals=np.arange(10) * 3.0))
    before = digest(e, "t")
    e.store.spill_all()
    e.store.evict_all()
    assert not e.store._objects and e.store._packed
    assert digest(e, "t") == before                   # faulted back in
    c = counters(e)
    assert c["store.spills"] > 0 and c["store.evictions"] > 0
    assert c["store.faults"] > 0 and c["store.bytes_packed"] > 0
    n_faults = c["store.faults"]
    assert digest(e, "t") == before                   # all heap hits now
    c2 = counters(e)
    assert c2["store.faults"] == n_faults and c2["store.hits"] > c["store.hits"]
    # the same pack bytes as the reference's, object for object
    r = seed("ref", str(tmp_path / "rpacks"))
    r.create_snapshot("s1", "t")
    r.update_by_keys("t", _batch(range(10), vals=np.arange(10) * 3.0))
    r.store.spill_all()
    assert e.store._packed == r.store._packed
    assert c["store.bytes_packed"] == counters(r)["store.bytes_packed"]


def test_oids_live_bytes_and_delete_span_both_tiers(tmp_path):
    got = {}
    for side in ("ref", "port"):
        e = seed(side, str(tmp_path / side), rows=20)
        e.delete_by_keys("t", {"k": np.arange(5, dtype=np.int64)})
        all_oids = sorted(e.store.oids())
        live = e.store.live_bytes()
        e.store.evict_all()
        assert sorted(e.store.oids()) == all_oids
        assert e.store.live_bytes() == live > 0
        victim = all_oids[0]
        dg = e.store.digest_of(victim)
        assert e.store.packs.has(dg)
        e.store.delete(victim)
        assert not e.store.has(victim) and not e.store.packs.has(dg)
        got[side] = (all_oids, live, e.store.live_bytes())
    assert got["port"] == got["ref"]


def test_shrink_heap_evicts_lru_first(tmp_path):
    e = engine("port")
    PS.attach_packs(e.store, str(tmp_path / "packs"))
    e.create_table("t", schema("port", SCH, ("k",)))
    for i in range(4):
        e.insert("t", _batch(range(i * 10, i * 10 + 10)))
    oids = sorted(e.store._objects)
    e.store.shrink_heap(0)
    assert not e.store._objects
    for o in oids[1:]:
        e.store.get(o)
    keep = e.store.get(oids[0]).nbytes              # the oldest oid is MRU
    assert e.store.shrink_heap(keep) == 3
    assert list(e.store._objects) == [oids[0]]
    assert sorted(e.store.oids()) == oids


def test_gc_prunes_pack_files(tmp_path):
    e = seed("port", str(tmp_path / "packs"), rows=30)
    e.store.spill_all()
    e.update_by_keys("t", _batch(range(30), vals=np.arange(30) * 2.0))
    e.store.spill_all()
    e.create_table("u", schema("port", SCH, ("k",)))
    e.insert("u", _batch(range(5)))
    e.store.spill_all()
    dead = e.store.digest_of(e.table("u").directory.data_oids[0])
    e.drop_table("u")
    assert e.gc().objects_freed == 1 and not e.store.packs.has(dead)
    assert e.store.packs.digests() == \
        {ent[0] for ent in e.store._packed.values()}
    for _, ent in sorted(e.store._packed.items()):
        assert e.store.packs.verify(ent[0]) == []


@pytest.mark.parametrize("pk", [True, False])
def test_evicted_lanes_leave_the_store_and_its_caches(tmp_path, pk):
    """Eviction frees the device: after the caches have been filled by
    diffs, a SQL diff and a scan (a NoPK Δ of one new object is served as
    views of its lanes), no lane of an evicted object stays reachable
    (weak references die), and reads fault in equal content."""
    e = engine("port")
    PS.attach_packs(e.store, str(tmp_path / "packs"))
    e.create_table("t", schema("port", SCH, ("k",) if pk else None))
    e.insert("t", _batch(range(40)))
    s0 = e.create_snapshot("s0", "t")
    e.insert("t", _batch(range(100, 120)))
    if pk:
        e.delete_by_keys("t", {"k": np.arange(30, 35, dtype=np.int64)})
    s1 = e.current_snapshot("t")
    before = (P.snapshot_diff(e.store, s0, s1).n_groups,
              P.sql_diff(e.store, s0, s1).n_groups, digest(e, "t"))
    assert e.store.delta_cache is not None and e.store.vis_cache is not None
    refs = []
    for oid in e.store.oids():
        o = e.store.get(oid)
        ts = [v for v in vars(o).values() if torch.is_tensor(v)]
        ts += [v for d in (getattr(o, "cols", {}), getattr(o, "lob_sigs", {}))
               for v in d.values() if torch.is_tensor(v)]
        refs += [weakref.ref(t) for t in ts]
        del o, ts
    assert refs
    e.store.evict_all()
    gc.collect()
    assert [r for r in refs if r() is not None] == []
    assert (P.snapshot_diff(e.store, s0, s1).n_groups,
            P.sql_diff(e.store, s0, s1).n_groups, digest(e, "t")) == before


def test_oid_reuse_after_rollback_never_serves_stale_bytes(tmp_path):
    import dataclasses
    e = seed("port", str(tmp_path / "packs"), rows=5)
    oid = max(e.store._objects)
    d1 = e.store.spill(oid)
    e.store.delete(oid)                             # rollback analogue
    assert not e.store.packs.has(d1)
    donor_e = seed("port", rows=0)
    donor_e.insert("t", _batch(range(100, 105)))
    donor = donor_e.store.get(max(donor_e.store._objects))
    e.store.put(dataclasses.replace(donor, oid=oid))
    d2 = e.store.evict(oid)
    assert d2 != d1
    got = e.store.get(oid)
    assert sorted(got.cols["k"].tolist()) == list(range(100, 105))


# --------------------------------------------------------------------------
# crash sweep: every torch.store.* seam, all-or-nothing
# --------------------------------------------------------------------------

def store_script(box, root):
    """Spill/evict, push to a fresh remote, advance the remote through a
    second engine, pull back. Each yield is a legal recovery target."""
    e = box["e"]
    PS.attach_packs(e.store, os.path.join(root, "packs"))
    e.create_table("t", schema("port", SCH, ("k",)));  yield "create"
    e.insert("t", _batch(range(40)));                   yield "seed"
    e.store.spill_all();                                yield "spill"
    e.store.evict_all();                                yield "evict"
    e.insert("t", _batch(range(40, 50)));               yield "grow"
    remote = os.path.join(root, "remote")
    os.makedirs(remote, exist_ok=True)
    PS.push(e, remote);                                 yield "push"
    b, _ = PS.pull(engine("port"), remote,
                   pack_dir=os.path.join(root, "bpacks"))
    b.insert("t", _batch(range(50, 55)));               yield "b_grow"
    PS.push(b, remote);                                 yield "b_push"
    box["e"], _ = PS.pull(e, remote);                   yield "pull"


@pytest.fixture(scope="module")
def store_oracle(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("oracle"))
    box = {"e": engine("port")}
    plan = P.FaultPlan({})
    states = [digests(box["e"])]
    with P.inject(plan):
        for _ in store_script(box, root):
            states.append(digests(box["e"]))
    return states, dict(plan.hits)


def test_store_points_all_registered():
    assert STORE_POINTS == ["torch.store.pack.write", "torch.store.pull.apply",
                            "torch.store.push.manifest", "torch.store.spill"]


@pytest.mark.parametrize("point", STORE_POINTS)
def test_store_crash_sweep_all_or_nothing(point, store_oracle, tmp_path):
    states, hits = store_oracle
    assert hits.get(point, 0) > 0, \
        f"store script never reaches crash point {point!r}"
    for n in range(1, hits[point] + 1):
        root = str(tmp_path / f"run{n}")
        os.makedirs(root)
        box = {"e": engine("port")}
        tripped = False
        with P.inject(P.FaultPlan.at(point, n)) as plan:
            try:
                for _ in store_script(box, root):
                    pass
            except P.InjectedCrash as crash:
                tripped = True
                assert crash.point == point and crash.hit == n
        assert tripped and plan.tripped == point
        recovered = P.Engine.replay(
            P.WAL.deserialize(box["e"].wal.serialize()), device="cpu")
        assert digests(recovered) in states, (point, n)
        report = P.fsck(recovered)
        assert report.ok, (point, n, [str(i) for i in report.issues])


def test_push_manifest_crash_leaves_remote_at_old_state(tmp_path):
    e = seed("port", str(tmp_path / "packs"))
    remote = str(tmp_path / "remote")
    PS.push(e, remote)
    old_payload, old_records = PS.read_remote(remote)
    e.insert("t", _batch(range(60, 80)))
    with P.inject(P.FaultPlan.at("torch.store.push.manifest")):
        with pytest.raises(P.InjectedCrash):
            PS.push(e, remote)
    payload, records = PS.read_remote(remote)
    assert payload["n_records"] == old_payload["n_records"]
    assert len(records) == len(old_records)
    assert PS.push(e, remote)["records_pushed"] > 0
    assert PS.read_remote(remote)[0]["n_records"] > old_payload["n_records"]


def test_pull_apply_crash_leaves_local_untouched(tmp_path):
    e = seed("port", str(tmp_path / "packs"))
    remote = str(tmp_path / "remote")
    PS.push(e, remote)
    b, _ = PS.pull(engine("port"), remote, pack_dir=str(tmp_path / "bpacks"))
    b.insert("t", _batch(range(60, 70)))
    PS.push(b, remote)
    before = digests(e)
    with P.inject(P.FaultPlan.at("torch.store.pull.apply")):
        with pytest.raises(P.InjectedCrash):
            PS.pull(e, remote)
    assert digests(e) == before
    e2, stats = PS.pull(e, remote)
    assert stats["records_pulled"] > 0 and digests(e2) == digests(b)


def test_spill_crash_keeps_heap_authoritative(tmp_path):
    e = seed("port", str(tmp_path / "packs"), rows=10)
    before = digest(e, "t")
    with P.inject(P.FaultPlan.at("torch.store.spill")):
        with pytest.raises(P.InjectedCrash):
            e.store.spill_all()
    assert not e.store._packed and digest(e, "t") == before
    e.store.spill_all()
    assert len(e.store._packed) == len(e.store._objects) > 0


# --------------------------------------------------------------------------
# remote exchange: only-missing-objects, zero rehash, the reference's counts
# --------------------------------------------------------------------------

def _exchange(side, root):
    remote = os.path.join(root, "remote")
    os.makedirs(remote)
    a = seed(side, os.path.join(root, "apacks"))
    out = [REMOTE[side].push(a, remote)]
    out.append(REMOTE[side].push(a, remote))        # idempotent
    b, sp = pull(side, engine(side), remote, os.path.join(root, "bpacks"))
    out.append(sp)
    assert counters(b)["commit.rows_rehashed"] == 0
    b.insert("t", _batch(range(60, 70)))
    new = set(b.store.oids()) - set(a.store.oids())
    out.append(REMOTE[side].push(b, remote))
    assert out[-1]["objects_pushed"] == len(new)
    a2, s3 = pull(side, a, remote)
    out.append(s3)
    assert counters(a2)["store.objects_pulled"] == len(new)
    assert counters(a2)["commit.rows_rehashed"] == 0
    assert digest(a2, "t") == digest(b, "t")
    out.append(pull(side, a2, remote)[1])
    return out, digest(a2, "t")


def test_push_pull_move_only_missing_objects_as_the_reference(tmp_path):
    ref = _exchange("ref", str(tmp_path / "ref"))
    port = _exchange("port", str(tmp_path / "port"))
    assert port == ref
    assert port[0][0]["objects_pushed"] > 0 and port[0][1]["objects_pushed"] == 0
    assert port[0][-1]["up_to_date"]


def _refusals(side, root):
    remote = os.path.join(root, "remote")
    a = seed(side, os.path.join(root, "apacks"), rows=10)
    REMOTE[side].push(a, remote)
    b, _ = pull(side, engine(side), remote, os.path.join(root, "bpacks"))
    b.insert("t", _batch(range(10, 15)))
    REMOTE[side].push(b, remote)
    a.insert("t", _batch(range(20, 25)))            # diverge locally
    out = []
    for call in (lambda: REMOTE[side].push(a, remote),
                 lambda: pull(side, a, remote)):
        with pytest.raises(REMOTE[side].RemoteError) as exc:
            call()
        out.append(str(exc.value))
    return out


def test_push_refuses_diverged_pull_refuses_behind(tmp_path):
    ref = _refusals("ref", str(tmp_path / "ref"))
    port = _refusals("port", str(tmp_path / "port"))
    assert port == ref and "pull first" in port[0]


def test_fetch_prefetches_without_state_swing(tmp_path):
    got = {}
    for side in ("ref", "port"):
        remote = str(tmp_path / side / "remote")
        a = seed(side, str(tmp_path / side / "apacks"), rows=20)
        REMOTE[side].push(a, remote)
        b = engine(side)
        st = REMOTE[side].fetch(b, remote,
                                pack_dir=str(tmp_path / side / "bpacks"))
        assert not b.tables
        assert b.store.packs.digests() == STORE[side].PackDir(remote).digests()
        got[side] = (st, REMOTE[side].fetch(b, remote))
    assert got["port"] == got["ref"]
    assert got["port"][0]["objects_pulled"] > 0


def test_shallow_clone_faults_objects_on_first_read(tmp_path):
    remote = str(tmp_path / "remote")
    a = seed("port", str(tmp_path / "apacks"), rows=50)
    before = digest(a, "t")
    PS.push(a, remote)
    dest = str(tmp_path / "b.wal")
    st = PS.clone(remote, dest, shallow=True)
    assert st["shallow"] and st["objects_fetched"] == 0
    rb = P_cli.load_repo(dest, "cpu")
    assert not rb.engine.store._objects
    assert digest(rb.engine, "t") == before
    c = counters(rb.engine)
    assert c["store.objects_pulled"] > 0 and c["commit.rows_rehashed"] == 0
    assert PS.clone(remote, str(tmp_path / "c.wal"))["objects_fetched"] > 0


def test_refs_payload_holds_no_tensor(tmp_path):
    import pickle

    class NoTensor(pickle.Pickler):
        def reducer_override(self, obj):
            assert not torch.is_tensor(obj), "a tensor in the refs payload"
            return NotImplemented

    e = seed("port", str(tmp_path / "packs"))
    e.create_branch("dev", ["t"])
    e.open_pr("main", "dev")
    payload = PS.export_refs(e, {})
    import io
    NoTensor(io.BytesIO()).dump(payload)


# --------------------------------------------------------------------------
# surfaces: status, the CLI's two-repo round trip
# --------------------------------------------------------------------------

def test_status_reports_crc32c_and_tiers(tmp_path):
    repo = P.Repo(device="cpu")
    repo.engine.create_table("t", schema("port", SCH, ("k",)))
    repo.engine.insert("t", _batch(range(10)))
    st = repo.status()
    assert st["crc32c"] == P_wal.CRC32C_IMPL
    assert st["store"] == {"resident": 1, "packed": 0, "packs": None}
    PS.attach_packs(repo.engine.store, str(tmp_path / "packs"))
    repo.engine.store.evict_all()
    st = repo.status()
    assert st["store"] == {"resident": 0, "packed": 1,
                           "packs": str(tmp_path / "packs")}


def _run(store, *argv):
    return P_cli.main(["--device", "cpu", "--store", store] + list(argv))


def test_cli_two_repo_round_trip(tmp_path, capsys):
    """seed A -> push -> shallow-clone B -> branch/mutate/PR/publish in B
    -> push back -> pull into A: equal digests, fsck clean both sides."""
    a_store, b_store = str(tmp_path / "a.wal"), str(tmp_path / "b.wal")
    remote = str(tmp_path / "origin")
    assert _run(a_store, "init") == 0
    assert _run(a_store, "seed", "orders", "--rows", "500") == 0
    assert _run(a_store, "push", remote) == 0
    assert _run(b_store, "clone", remote, "--shallow") == 0
    capsys.readouterr()
    assert _run(b_store, "status") == 0
    out = capsys.readouterr().out
    assert "crc32c=" in out and "resident=0" in out
    for argv in (["branch", "dev", "-t", "orders"],
                 ["mutate", "dev/orders", "--rows", "40"],
                 ["pr", "open", "dev"], ["publish", "1"],
                 ["push", remote]):
        assert _run(b_store, *argv) == 0, argv
    assert _run(a_store, "pull", remote) == 0
    ra = P_cli.load_repo(a_store, "cpu")
    rb = P_cli.load_repo(b_store, "cpu")
    assert digest(ra.engine, "orders") == digest(rb.engine, "orders")
    for r in (ra, rb):
        assert P.fsck(r.engine).ok
    assert _run(a_store, "fsck") == 0 and _run(b_store, "fsck") == 0
    assert _run(a_store, "pull", remote) == 0
    assert "up to date" in capsys.readouterr().out


def test_cli_sql_push_pull_fetch(tmp_path, capsys):
    a, b = str(tmp_path / "a.wal"), str(tmp_path / "b.wal")
    remote = str(tmp_path / "origin")
    assert _run(a, "init") == 0
    assert _run(a, "seed", "t", "--rows", "20") == 0
    assert _run(a, "sql", f"PUSH TO '{remote}'") == 0
    assert _run(b, "clone", remote) == 0
    assert _run(b, "sql", f"FETCH FROM '{remote}'") == 0
    assert _run(b, "sql", f"PULL FROM '{remote}'") == 0
    assert "up to date" in capsys.readouterr().out


def test_cli_read_only_commands_never_rewrite_a_refs_mode_store(tmp_path):
    a, b = str(tmp_path / "a.wal"), str(tmp_path / "b.wal")
    remote = str(tmp_path / "origin")
    assert _run(a, "init") == 0 and _run(a, "seed", "t", "--rows", "30") == 0
    assert _run(a, "push", remote) == 0
    assert _run(b, "clone", remote, "--shallow") == 0

    def sig(path):
        with open(path, "rb") as f:
            return os.stat(path).st_mtime_ns, f.read()
    before = (sig(b), sig(b + ".refs"))
    for argv in (["status"], ["log", "t"], ["tables"], ["push", remote]):
        assert _run(b, *argv) == 0, argv
        assert (sig(b), sig(b + ".refs")) == before, argv
    assert _run(b, "seed", "u", "--rows", "5") == 0
    assert sig(b) != before[0] and sig(b + ".refs") != before[1]


# --------------------------------------------------------------------------
# GOLDEN_APPLY from an evicted store
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pk", [True, False])
def test_apply_path_byte_identical_from_evicted_store(pk, tmp_path):
    got = p_digests.run_apply_workload(pk, device="cpu", pack_root=tmp_path)
    assert got == GOLDEN_APPLY[pk], got


# --------------------------------------------------------------------------
# chip_smoke's tiers phase, driven on the CPU at a small size
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pk", [True, False])
def test_chip_smoke_tiers_phase_runs_on_the_cpu(pk, tmp_path):
    """Every step and check of the card's ``tiers`` phase at 3,000 rows:
    spill, evict, the evicted diffs equal to the resident ones, fsck, push,
    a shallow clone reading only what it needs, a pulled C4 change and
    both planted faults found and repaired."""
    import chip_smoke
    change = 200
    e, base, pre = chip_smoke.tiers_engine(pk, 3000, change, device="cpu")
    e.clone_table("li_copy", "sn1", materialize=True)   # a table to drop
    rec = chip_smoke.tiers_phase(torch, pk, e, base, pre, change, 0,
                                 device="cpu", root=tmp_path / "tiers")
    assert rec["gc_freed"] > 0 and rec["objects"] == 5
    assert rec["evicted"] == rec["resident"]
    assert rec["fsck"]["ok"] and rec["fsck"]["replay_checked"]
    r = rec["remotes"]
    assert r["digests_equal"] and r["rows_rehashed"] == 0
    assert 0 < r["clone_faulted"] < r["clone_objects"]
    assert r["objects_pulled"] == r["clone_pushed"] > 0
    assert len(rec["planted"]["issues"]) == 2
    assert rec["crc32c"]["bytes"] > 0 and rec["parts_s"]["encode_object"] > 0
