"""The port's fsck and crash sweeps, side by side with the reference.

Counterparts of ``tests/test_crash_recovery.py`` and the fsck cases of
``tests/test_store_tiers.py``: on the same history both packages give
equal ``FsckReport``s — issue kinds, places, oids and every count — on a
clean engine, under sampling, and with each planted fault (bit rot in an
object, a missing object, broken structure, unsorted keys, a stray
tombstone target, a flipped bit in a pack file), before and after repair.
Then every ``torch.`` crash point of the engine and of the CLI's store
writes is tripped at every hit its script reaches: recovery from the
durable bytes lands on a state the clean run passed through, and fsck is
clean. (The ``torch.store.*`` points are swept in
``test_torch_store_tiers.py``.)
"""
import dataclasses
import os

import numpy as np
import pytest

import repro.core as R
import repro.core.faults as R_faults
import repro.store as RS
import repro_torch.core as P
import repro_torch.core.faults as P_faults
import repro_torch.store as PS
from repro_torch.core import telemetry as P_telemetry
from repro_torch.core.fsck import layer_seconds as fsck_layer_seconds
import repro_torch.vcs_cli as P_cli
from conftest import kv_batch as _batch
from test_torch_indices import schema
from test_torch_wal import digests

SCH = (("k", "I64"), ("v", "F64"), ("doc", "LOB"))
API = {"ref": R, "port": P}
FSCK = {"ref": R.fsck, "port": P.fsck}
FAULTS = {"ref": R_faults, "port": P_faults}
STORE = {"ref": RS, "port": PS}
ENGINE_POINTS = sorted(p for p in P_faults.registered()
                       if not p.startswith(("torch.cli.", "torch.store.")))
CLI_POINTS = sorted(p for p in P_faults.registered()
                    if p.startswith("torch.cli."))


def engine(side):
    return R.Engine() if side == "ref" else P.Engine(device="cpu")


def script(e, side="port"):
    """The reference's op script (seed -> branch -> PR -> publish ->
    revert -> compaction -> gc). Each yield marks ONE completed logical
    operation: a legal all-or-nothing recovery target."""
    api = API[side]
    sch = schema(side, SCH, ("k",))
    e.create_table("t", sch);                                 yield "create_t"
    e.create_table("u", sch);                                 yield "create_u"
    e.insert("t", _batch([1, 2, 3, 4, 5]));                   yield "seed_t"
    e.insert("u", _batch([10, 11, 12]));                      yield "seed_u"
    tx = e.begin()
    tx.insert("t", _batch([6]))
    tx.insert("u", _batch([13]))
    tx.commit();                                              yield "multi"
    e.delete_by_keys("t", {"k": np.asarray([5])});            yield "delete"
    e.create_snapshot("s1", "t");                             yield "snap"
    e.create_branch("dev", ["t", "u"]);                       yield "branch"
    e.update_by_keys("dev/t", _batch([2], vals=[7.0]));       yield "mut_dt"
    e.update_by_keys("dev/u", _batch([11], vals=[8.0]));      yield "mut_du"
    pr = e.open_pr("main", "dev");                            yield "open_pr"
    pr.publish();                                             yield "publish"
    pr.revert_publish();                                      yield "rev_pub"
    api.compact_objects(e, "t", list(e.table("t").directory.data_oids))
    yield "compact"
    s_a = e.current_snapshot("t")
    e.update_by_keys("t", _batch([1], vals=[44.0]));          yield "mut_t"
    e.revert("t", s_a, e.current_snapshot("t"));              yield "revert"
    e.create_table("tmp", sch);                               yield "mk_tmp"
    e.insert("tmp", _batch([100]));                           yield "seed_tmp"
    e.drop_table("tmp");                                      yield "drop_tmp"
    e.gc();                                                   yield "gc"


def scripted(side):
    e = engine(side)
    for _ in script(e, side):
        pass
    return e


def report_of(r):
    """Everything an FsckReport says, as plain data."""
    return {"issues": [(i.kind, i.where, i.oid) for i in r.issues],
            "details": [i.detail for i in r.issues],
            **{f: getattr(r, f) for f in (
                "objects_checked", "rows_verified", "directories_checked",
                "refs_checked", "packs_checked", "replay_checked",
                "repaired", "quarantined", "refs_unreachable",
                "indices_rebuilt", "ok")},
            "summary": r.summary()}


def both(fn):
    return fn("ref"), fn("port")


# --------------------------------------------------------------------------
# equal reports
# --------------------------------------------------------------------------

def test_clean_engine_reports_equal_the_reference():
    ref, port = both(lambda s: report_of(FSCK[s](scripted(s))))
    assert port == ref and port["ok"] and port["replay_checked"]
    assert port["rows_verified"] > 0


@pytest.mark.parametrize("sample, seed", [(0.5, 0), (0.3, 7), (0.01, 3)])
def test_sampled_verification_draws_the_references_objects(sample, seed):
    ref, port = both(lambda s: report_of(FSCK[s](
        scripted(s), sample=sample, seed=seed, check_replay=False)))
    assert port == ref


def _plant(side, e, fault, tmp):
    """Plant one fault in ``e``; returns the oid it should be reported at."""
    st = e.store
    oid = e.table("t").directory.data_oids[0]
    if fault == "bit_rot":
        FAULTS[side].corrupt_object_bit(st.get(oid), row=0, bit=5)
    elif fault == "lob_rot":
        FAULTS[side].corrupt_object_bit(st.get(oid), column="doc", row=0)
    elif fault == "missing":
        st.delete(oid)
    elif fault == "structure":
        o = st.get(oid)
        o.commit_ts = o.commit_ts[:-1]
    elif fault == "unsorted":
        o = st.get(oid)
        o.key_lo, o.key_hi = o.key_lo.flip(0) if side == "port" else \
            o.key_lo[::-1], o.key_hi
    elif fault == "tombstone":
        oid = e.table("t").directory.tomb_oids[0]
        o = st.get(oid)
        st._objects[oid] = dataclasses.replace(o, target_oids=())
    elif fault == "pack_rot":
        STORE[side].attach_packs(st, os.path.join(tmp, side))
        st.spill_all()
        oid = sorted(st._packed)[0]
        FAULTS[side].flip_bit(st.packs.path(st._packed[oid][0]), 60)
    return oid


FAULT_KINDS = {"bit_rot": "signature_mismatch",
               "lob_rot": "signature_mismatch",
               "missing": "missing_object", "structure": "bad_structure",
               "unsorted": "unsorted_keys", "tombstone": "bad_tombstone",
               "pack_rot": "pack_corrupt"}


@pytest.mark.parametrize("fault", sorted(FAULT_KINDS))
def test_planted_faults_and_repair_report_as_the_reference(fault, tmp_path):
    def run(side):
        e = scripted(side)
        oid = _plant(side, e, fault, str(tmp_path))
        f = FSCK[side]
        out = [report_of(f(e)),
               report_of(f(e, repair=True, check_replay=False)),
               report_of(f(e, check_replay=False))]
        return oid, out
    (r_oid, ref), (p_oid, port) = both(run)
    assert p_oid == r_oid
    assert port == ref
    first = port[0]
    assert (FAULT_KINDS[fault], p_oid) in [(k, o) for k, _, o in
                                           first["issues"]]
    if fault not in ("pack_rot", "missing"):
        assert port[1]["quarantined"] == [p_oid]
    if fault != "pack_rot":
        assert port[2]["ok"]                  # consistent after repair


def test_object_bit_rot_is_one_mismatch_and_replay_then_diverges():
    e = scripted("port")
    oid = e.table("t").directory.data_oids[0]
    P_faults.corrupt_object_bit(e.store.get(oid), row=0, bit=5)
    report = P.fsck(e)
    assert [(i.kind, i.oid) for i in report.issues] == \
        [("signature_mismatch", oid)]
    repaired = P.fsck(e, repair=True, check_replay=False)
    assert oid in repaired.quarantined and repaired.refs_unreachable
    assert P.fsck(e, check_replay=False).ok
    with P_telemetry.trace(e) as tracer:
        assert {i.kind for i in P.fsck(e).issues} == {"replay_divergence"}
    seconds = fsck_layer_seconds(tracer)
    assert set(seconds) == {"objects", "signatures", "packs", "replay"}
    assert all(v >= 0.0 for v in seconds.values())
    assert seconds["signatures"] > 0.0 and seconds["replay"] > 0.0


def test_repo_fsck_statement_and_cli(tmp_path, capsys):
    repo = P.Repo(device="cpu")
    P_cli.seed_table(repo, "t", 30, 0)
    res = P.execute(repo, "FSCK")
    assert res.kind == "fsck" and res.data.ok
    assert res.message.startswith("fsck: clean")
    store = str(tmp_path / "s.wal")
    argv = ["--device", "cpu", "--store", store]
    assert P_cli.main(argv + ["init"]) == 0
    assert P_cli.main(argv + ["seed", "t", "--rows", "30"]) == 0
    assert P_cli.main(argv + ["seed", "u", "--rows", "5"]) == 0
    assert P_cli.main(argv + ["fsck", "--sample", "0.5"]) == 0
    assert "fsck: clean" in capsys.readouterr().out
    # a flipped bit in the last frame: fsck reports it, --repair
    # truncates to the last clean frame and preserves the damaged bytes
    size = os.path.getsize(store)
    P_faults.flip_bit(store, size - 10, 2)
    assert P_cli.main(argv + ["fsck"]) == 1
    assert "corrupt frame" in capsys.readouterr().out
    assert P_cli.main(argv + ["fsck", "--repair"]) == 0
    assert os.path.getsize(store + ".corrupt") > 0
    assert os.path.getsize(store) < size
    assert sorted(P_cli.load_repo(store, "cpu").engine.tables) == ["t"]


# --------------------------------------------------------------------------
# crash sweeps: every torch. engine and CLI point, at every hit
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle():
    e = engine("port")
    plan = P.FaultPlan({})
    states = [digests(e)]
    with P.inject(plan):
        for _ in script(e):
            states.append(digests(e))
    return states, dict(plan.hits)


def test_engine_points_are_the_ports_own():
    assert ENGINE_POINTS == [
        "torch.compaction.post_seal", "torch.engine.commit.mid_swing",
        "torch.engine.commit.post_seal", "torch.engine.commit.pre_seal",
        "torch.engine.gc.mid_sweep", "torch.wal.append",
        "torch.workspace.publish.planned", "torch.workspace.publish.pre_log",
        "torch.workspace.revert.pre_log",
        "torch.workspace.revert_publish.pre_log"]
    assert CLI_POINTS == ["torch.cli.save.mid_frame",
                          "torch.cli.save.pre_fsync"]


@pytest.mark.parametrize("point", ENGINE_POINTS)
def test_crash_sweep_all_or_nothing(point, oracle):
    states, hits = oracle
    assert hits.get(point, 0) > 0, \
        f"op script never reaches crash point {point!r}"
    for n in range(1, hits[point] + 1):
        e = engine("port")
        tripped = False
        with P.inject(P.FaultPlan.at(point, n)) as plan:
            try:
                for _ in script(e):
                    pass
            except P.InjectedCrash as crash:
                tripped = True
                assert crash.point == point and crash.hit == n
        assert tripped and plan.tripped == point
        recovered = P.Engine.replay(P.WAL.deserialize(e.wal.serialize()),
                                    device="cpu")
        assert digests(recovered) in states, (point, n)
        report = P.fsck(recovered)
        assert report.ok, (point, n, [str(i) for i in report.issues])


def cli_script(store):
    """Five CLI invocations' worth of saves, one logical operation each."""
    for step in (lambda r: r.create_table("t", schema("port", SCH, ("k",))),
                 lambda r: r.insert("t", _batch([1, 2, 3])),
                 lambda r: r.tag("s1", "t"),
                 lambda r: r.update_by_keys("t", _batch([2], vals=[9.0])),
                 lambda r: r.branch("dev", ["t"])):
        repo = P_cli.load_repo(store, "cpu")
        step(repo)
        P_cli.save_repo(store, repo)
        yield


@pytest.mark.parametrize("point", CLI_POINTS)
def test_cli_store_crash_sweep_all_or_nothing(point, tmp_path):
    clean = str(tmp_path / "clean.wal")
    plan = P.FaultPlan({})
    states = [digests(P_cli.load_repo(clean, "cpu").engine)]
    with P.inject(plan):
        for _ in cli_script(clean):
            states.append(digests(P_cli.load_repo(clean, "cpu").engine))
    assert plan.hits[point] == 5
    for n in range(1, plan.hits[point] + 1):
        store = str(tmp_path / f"run{n}.wal")
        with P.inject(P.FaultPlan.at(point, n)):
            with pytest.raises(P.InjectedCrash):
                for _ in cli_script(store):
                    pass
        recovered = P_cli.load_repo(store, "cpu")
        assert digests(recovered.engine) in states, (point, n)
        assert P.fsck(recovered.engine).ok, (point, n)
        # the next write truncates any torn tail: the store is clean again
        recovered.create_table("z", schema("port", SCH, ("k",)))
        recovered.insert("z", _batch([99]))
        P_cli.save_repo(store, recovered)
        assert P.fsck(P_cli.load_repo(store, "cpu").engine).ok


def test_fsck_report_has_the_reference_fields():
    """The port's report carries exactly the reference's fields (its
    layer times come from telemetry spans, not from the report)."""
    assert [f.name for f in dataclasses.fields(P.FsckReport)] == \
        [f.name for f in dataclasses.fields(R.FsckReport)]
