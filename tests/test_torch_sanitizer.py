"""The port's sealed-write sanitizer, beside the reference's.

With ``REPRO_SANITIZE=1`` (or ``objects.set_sanitize(True)``) every lane
of a sealed object is frozen at seal, at store time and at fault-in, so an
in-place write to sealed state fails AT the write. The reference freezes
numpy lanes (``writeable=False``) and raises ``ValueError``; the port
swaps each tensor lane for an inference-mode copy, which refuses any
in-place op — on its views too — with ``RuntimeError``, and hands sanitized
lanes out as read-only numpy. Counterparts of ``tests/test_sanitizer.py``,
plus the faulted-in and NoPK-aliased cases. The port's flag is restored by
this file's own fixture (``tests/conftest.py`` restores the reference's).
"""
import numpy as np
import pytest

import repro.core as R
import repro.core.objects as R_objects
import repro_torch.core as P
import repro_torch.core.objects as P_objects
import repro_torch.store as PS
from conftest import content_digest as r_digest
from conftest import kv_batch
from repro.core.faults import corrupt_object_bit as r_corrupt
from repro_torch.core.faults import corrupt_object_bit
from repro_torch.interop import to_numpy
from test_torch_indices import digest, schema

SCH = (("k", "I64"), ("v", "F64"), ("doc", "LOB"))
#: what an in-place write to a frozen lane raises in each package
WRITE_ERROR = {"ref": ValueError, "port": RuntimeError}


@pytest.fixture(autouse=True)
def _restore_port_sanitize():
    prev = P_objects.SANITIZE
    yield
    P_objects.SANITIZE = prev


def armed_engine(side, pk=True, rows=100):
    (R_objects if side == "ref" else P_objects).set_sanitize(True)
    e = R.Engine() if side == "ref" else P.Engine(device="cpu")
    e.create_table("t", schema(side, SCH, ("k",) if pk else None))
    e.insert("t", kv_batch(range(rows)))
    return e


def sealed(e):
    return [e.store.get(o) for o in e.table("t").directory.data_oids]


@pytest.mark.parametrize("side", ["ref", "port"])
def test_sealed_lane_write_raises_when_armed(side):
    (obj,) = sealed(armed_engine(side))
    err = WRITE_ERROR[side]
    with pytest.raises(err):
        obj.cols["v"][0] = 99.0
    with pytest.raises(err):
        obj.key_lo[0] = 0
    with pytest.raises(err):
        obj.commit_ts[:] = 0
    view = obj.cols["v"].view() if side == "ref" else obj.cols["v"][1:]
    with pytest.raises(err):
        view[0] = 1.0                   # views do not launder the freeze
    with pytest.raises(ValueError):
        obj.cols["doc"][0] = b"x"       # LOB arrays: read-only numpy


def test_port_lanes_reach_numpy_read_only_when_armed():
    """On the CPU a tensor's numpy shares its memory, and an inference
    tensor does not guard writes through it: ``interop`` marks them
    read-only instead."""
    (obj,) = sealed(armed_engine("port"))
    for lane in (obj.cols["v"], obj.row_lo, obj.commit_ts):
        a = to_numpy(lane)
        assert not a.flags.writeable
        with pytest.raises(ValueError):
            a[0] = 0
    assert obj.cols["v"].is_inference()


def test_set_sanitize_returns_previous_state():
    prev = P_objects.set_sanitize(True)
    assert P_objects.set_sanitize(prev) is True
    assert P_objects.SANITIZE == prev


def test_disarmed_lanes_stay_writeable():
    P_objects.set_sanitize(False)
    e = P.Engine(device="cpu")
    e.create_table("t", schema("port", SCH, ("k",)))
    e.insert("t", kv_batch(range(10)))
    (obj,) = sealed(e)
    obj.cols["v"][0] = 42.0
    assert float(obj.cols["v"][0]) == 42.0
    assert to_numpy(obj.cols["v"]).flags.writeable


@pytest.mark.parametrize("side", ["ref", "port"])
def test_tombstone_lanes_frozen_too(side):
    e = armed_engine(side)
    e.delete_by_keys("t", {"k": np.arange(5, dtype=np.int64)})
    (tomb,) = [e.store.get(o) for o in e.table("t").directory.tomb_oids]
    with pytest.raises(WRITE_ERROR[side]):
        tomb.target[0] = 0


def test_faulted_in_lanes_are_frozen_and_nopk_keys_stay_aliased(tmp_path):
    e = armed_engine("port", pk=False)
    (obj,) = sealed(e)
    assert obj.key_lo is obj.row_lo and obj.row_lo.is_inference()
    PS.attach_packs(e.store, str(tmp_path / "packs"))
    e.store.evict_all()
    (back,) = sealed(e)
    assert back is not obj and back.key_lo is back.row_lo
    with pytest.raises(RuntimeError):
        back.row_lo[0] = 0
    with pytest.raises(RuntimeError):
        back.cols["k"].add_(1)


@pytest.mark.parametrize("side", ["ref", "port"])
def test_corruption_injector_still_works_armed(side):
    e = armed_engine(side)
    (obj,) = sealed(e)
    before = np.array(to_numpy(obj.cols["v"]))
    (r_corrupt if side == "ref" else corrupt_object_bit)(obj, column="v")
    assert not np.array_equal(before, to_numpy(obj.cols["v"]))
    report = (R.fsck if side == "ref" else P.fsck)(e, check_replay=False)
    assert [i.kind for i in report.issues] == ["signature_mismatch"]


def _workflow(side):
    """Branch → mutate → PR → publish → revert → GC → fsck, armed."""
    api = R if side == "ref" else P
    (R_objects if side == "ref" else P_objects).set_sanitize(True)
    repo = R.Repo() if side == "ref" else P.Repo(device="cpu")
    dig = r_digest if side == "ref" else digest
    repo.create_table("orders", schema(side, SCH, ("k",)))
    repo.insert("orders", kv_batch(range(1000)))
    trunk0 = dig(repo.engine, "orders")
    repo.branch("dev", tables=["orders"])
    keys = np.arange(100, 200, dtype=np.int64)
    repo.update_by_keys("dev/orders", kv_batch(keys, vals=keys * 3.0))
    repo.delete_by_keys("dev/orders", {"k": np.arange(7, dtype=np.int64)})
    dev = dig(repo.engine, "dev/orders")
    pr = repo.open_pr("dev")
    repo.publish(pr.id)
    assert dig(repo.engine, "orders") == dev
    assert repo.revert_pr(pr.id) is not None
    assert dig(repo.engine, "orders") == trunk0
    repo.gc()
    report = repo.fsck()
    assert report.ok, report
    assert isinstance(api.FsckReport(), type(report))
    return trunk0, dev


def test_e2e_workflow_green_with_sanitizer_armed():
    assert _workflow("port") == _workflow("ref")
