"""Signatures and sealed objects of the port against the reference.

``repro_torch.core.sigs.compute_sigs`` must give every row the same
128-bit row/key signatures (and LOB content signatures) as
``repro.core.sigs``, and a batch inserted into both engines must seal
into byte-equal ``DataObject`` lanes. Batches are made with numpy from
fixed seeds and handed to both packages.
"""
import numpy as np
import pytest

from repro.configs.paper_vcs import (LINEITEM_SCHEMA as R_LINEITEM,
                                     LINEITEM_SCHEMA_NOPK as R_LINEITEM_NOPK,
                                     gen_lineitem)
from repro.core import Engine as REngine
from repro.core import sigs as rsigs
from repro.core.schema import Column as RColumn
from repro.core.schema import CType as RCType
from repro.core.schema import Schema as RSchema
from repro_torch.configs.paper_vcs import (LINEITEM_SCHEMA,
                                           LINEITEM_SCHEMA_NOPK)
from repro_torch.core import Engine, objects, sigs
from repro_torch.core.schema import Column, CType, Schema
from repro_torch.interop import from_numpy as T
from repro_torch.interop import from_numpy_batch, to_numpy
from repro_torch.kernels import build

ALL_TYPES = ("i64", "i32", "f64", "f32", "bool", "lob")


@pytest.fixture(autouse=True)
def _reset_port_globals():
    carry = sigs.DEBUG_VALIDATE_CARRY
    build.reset_launches()
    yield
    sigs.DEBUG_VALIDATE_CARRY = carry


def U(t):
    return to_numpy(t, u64=True)


def _schemas(pk: bool):
    cols = [(f"c_{t}", t) for t in ALL_TYPES]
    key = ("c_i64", "c_i32") if pk else None
    return (RSchema(tuple(RColumn(n, RCType(t)) for n, t in cols), key),
            Schema(tuple(Column(n, CType(t)) for n, t in cols), key))


def _typed_batch(rng, n):
    f64 = rng.normal(size=n)
    f64[::7] = np.nan
    f64[1::11] = -0.0
    f32 = rng.normal(size=n).astype(np.float32)
    f32[::5] = np.nan
    f32[2::9] = -0.0
    return {
        "c_i64": rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
        "c_i32": np.arange(n, dtype=np.int32) - n // 2,
        "c_f64": f64,
        "c_f32": f32,
        "c_bool": rng.integers(0, 2, n).astype(bool),
        "c_lob": np.array([b"v%d" % v for v in rng.integers(0, 50, n)],
                          dtype=object),
    }


@pytest.mark.parametrize("pk", [True, False])
def test_compute_sigs_match_reference_on_every_column_type(pk):
    rsch, sch = _schemas(pk)
    batch = _typed_batch(np.random.default_rng(int(pk)), 777)
    want = rsigs.compute_sigs(rsch, rsch.normalize_batch(batch))
    got = sigs.compute_sigs(sch, from_numpy_batch(sch, batch))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(U(g), w)
    assert set(got[4]) == set(want[4]) == {"c_lob"}
    np.testing.assert_array_equal(U(got[4]["c_lob"]), want[4]["c_lob"])
    # NoPK: the key signature IS the row signature (same tensors)
    assert (got[2] is got[0]) == (not pk)
    # the lane matrix is the reference's, lane for lane
    rb = rsch.normalize_batch(batch)
    np.testing.assert_array_equal(
        sigs.column_lanes(sch, from_numpy_batch(sch, batch), sch.names,
                          got[4]).numpy().view(np.uint32),
        rsigs.column_lanes(rsch, rb, rsch.names, want[4]))


@pytest.mark.parametrize("pk", [True, False])
def test_lineitem_sigs_match_reference(pk):
    rsch, sch = ((R_LINEITEM, LINEITEM_SCHEMA) if pk
                 else (R_LINEITEM_NOPK, LINEITEM_SCHEMA_NOPK))
    batch = gen_lineitem(3000, seed=7)
    want = rsigs.compute_sigs(rsch, batch)
    got = sigs.compute_sigs(sch, from_numpy_batch(sch, batch))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(U(g), w)
    if pk:
        kb = {k: batch[k] for k in sch.primary_key}
        klo, khi = sigs.key_sigs_for_lookup(
            sch, Schema(tuple(sch.column(k) for k in sch.primary_key),
                        sch.primary_key).normalize_batch(kb, "cpu"))
        w_lo, w_hi = rsigs.key_sigs_for_lookup(rsch, kb)
        np.testing.assert_array_equal(U(klo), w_lo)
        np.testing.assert_array_equal(U(khi), w_hi)


def _assert_objects_equal(r_obj, p_obj):
    assert p_obj.oid == r_obj.oid and p_obj.nrows == r_obj.nrows
    assert p_obj.nbytes == r_obj.nbytes
    for f in ("row_lo", "row_hi", "key_lo", "key_hi", "commit_ts"):
        np.testing.assert_array_equal(U(getattr(p_obj, f)),
                                      getattr(r_obj, f).astype(np.uint64))
    assert (p_obj.key_lo is p_obj.row_lo) == (r_obj.key_lo is r_obj.row_lo)
    for c, v in r_obj.cols.items():
        got = to_numpy(p_obj.cols[c])
        assert got.dtype == v.dtype, c
        assert got.tobytes() == v.tobytes() if v.dtype != object \
            else list(got) == list(v)
    for c, v in r_obj.lob_sigs.items():
        np.testing.assert_array_equal(U(p_obj.lob_sigs[c]), v)
    np.testing.assert_array_equal(U(p_obj.rowids()), r_obj.rowids())


@pytest.mark.parametrize("pk,n", [(True, 5000), (False, 5000),
                                  (True, objects.OBJECT_CAPACITY + 777)])
def test_sealed_objects_byte_equal_to_reference(pk, n):
    rsch, sch = ((R_LINEITEM, LINEITEM_SCHEMA) if pk
                 else (R_LINEITEM_NOPK, LINEITEM_SCHEMA_NOPK))
    batch = gen_lineitem(n, seed=3)
    re, pe = REngine(), Engine(device="cpu")
    re.create_table("t", rsch)
    pe.create_table("t", sch)
    re.insert("t", batch)
    pe.insert("t", batch)
    r_dir, p_dir = re.table("t").directory, pe.table("t").directory
    assert (p_dir.data_oids, p_dir.tomb_oids, p_dir.ts) == \
        (r_dir.data_oids, r_dir.tomb_oids, r_dir.ts)
    assert len(p_dir.data_oids) == (2 if n > objects.OBJECT_CAPACITY else 1)
    for oid in r_dir.data_oids:
        _assert_objects_equal(re.store.get(oid), pe.store.get(oid))
        assert pe.store.get(oid).row_lo.device == pe.device


def test_runs_claims_are_validated():
    sigs.DEBUG_VALIDATE_CARRY = True
    lo = T(np.asarray([1, 3, 2, 4], np.uint64))
    hi = T(np.zeros(4, np.uint64))
    sigs.validate_runs(lo, hi, np.asarray([0, 2], np.int64))
    with pytest.raises(ValueError, match="isn't real"):
        sigs.validate_runs(lo, hi, np.asarray([0], np.int64))
    # unsigned order: the top bit makes a word LARGER, not negative
    big = T(np.asarray([1, 2**63], np.uint64))
    sigs.validate_runs(big, T(np.zeros(2, np.uint64)),
                       np.asarray([0], np.int64))


def test_resolve_sigs_rejects_mismatched_sidecars():
    _, sch = _schemas(True)
    batch = from_numpy_batch(sch, _typed_batch(np.random.default_rng(2), 10))
    full = sigs.resolve_sigs(sch, batch, None)
    short = sigs.SigBatch(full.row_lo[:5], full.row_hi[:5], full.key_lo[:5],
                          full.key_hi[:5], {})
    with pytest.raises(ValueError, match="rows"):
        sigs.resolve_sigs(sch, batch, short)
