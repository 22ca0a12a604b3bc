"""The port's DGPK packs against the reference's, byte for byte.

Counterparts of ``tests/test_pack_roundtrip.py``: every sealed object
shape (PK with a LOB lane, NoPK with aliased key lanes, tombstones, the
13-column objects an ALTER rewrites) built by both packages from the same
numpy inputs encodes to the same blob and sha256 address; a pack written
by ``repro`` decodes in ``repro_torch`` (and the other way round) to equal
lanes that re-encode to the same bytes; and the reference's truncation,
trailing-garbage and flipped-byte sweeps raise the same typed errors in
both. Decoding a ``bytes`` blob never hands out a CPU lane that aliases
it. Then the chunked numpy CRC32C every frame goes through, held against
``google_crc32c``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.store as RS
import repro_torch.core as P
import repro_torch.core.wal as P_wal
import repro_torch.store as PS
from conftest import kv_batch as _batch
from repro_torch.interop import to_numpy
from test_torch_indices import A, lineitem_engine, schema

SCH = (("k", "I64"), ("v", "F64"), ("doc", "LOB"))
API = {"ref": R, "port": P}
STORE = {"ref": RS, "port": PS}


def engine(side):
    return R.Engine() if side == "ref" else P.Engine(device="cpu")


def sample_objects(side, rows=8):
    """One of each small sealed shape, via the real engine paths: a PK
    data object (LOB lane + lob_sigs), a tombstone, a NoPK object."""
    e = engine(side)
    e.create_table("t", schema(side, SCH, ("k",)))
    e.insert("t", _batch(range(rows)))
    e.delete_by_keys("t", {"k": np.asarray([2, 3])})
    e.create_table("n", schema(side, SCH, None))
    e.insert("n", _batch(range(rows)))
    return [e.store.get(o) for o in sorted(e.store.oids())]


def altered_objects(side, pk):
    """The 13-column objects ALTER ADD COLUMN rewrites on lineitem."""
    e, _ = lineitem_engine(side, pk, 600)
    e.alter_table_add_column("lineitem",
                             API[side].Column("l_tag", API[side].CType.I64),
                             7)
    return [e.store.get(o) for o in e.table("lineitem").directory.data_oids]


def shapes(side):
    return {"pk_lob": sample_objects(side)[0],
            "tombstone": sample_objects(side)[1],
            "nopk_aliased": sample_objects(side)[2],
            "altered_pk": altered_objects(side, True)[0],
            "altered_nopk": altered_objects(side, False)[0]}


def lanes(obj):
    """Every lane of an object of either package as numpy (words uint64)."""
    if type(obj).__name__ == "TombstoneObject":
        out = {k: A(getattr(obj, k)).astype(np.uint64)
               for k in ("commit_ts", "target", "key_lo", "key_hi")}
        out["target_oids"] = tuple(int(o) for o in obj.target_oids)
        return out
    out = {k: A(getattr(obj, k)).astype(np.uint64)
           for k in ("commit_ts", "row_lo", "row_hi", "key_lo", "key_hi")}
    for name, col in obj.cols.items():
        a = to_numpy(col)
        out["col:" + name] = list(a) if a.dtype == object else a
    for name, sig in obj.lob_sigs.items():
        out["lob_sig:" + name] = A(sig).astype(np.uint64)
    out["nbytes"] = int(obj.nbytes)
    return out


def assert_same(a, b):
    la, lb = lanes(a), lanes(b)
    assert la.keys() == lb.keys()
    for k in la:
        if isinstance(la[k], np.ndarray):
            assert la[k].dtype == lb[k].dtype, k
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
        else:
            assert la[k] == lb[k], k
    assert a.nrows == b.nrows and a.oid == b.oid


@pytest.fixture(scope="module")
def both_shapes():
    return shapes("ref"), shapes("port")


SHAPES = ("pk_lob", "tombstone", "nopk_aliased", "altered_pk",
          "altered_nopk")


@pytest.mark.parametrize("shape", SHAPES)
def test_blobs_and_digests_equal_the_reference(both_shapes, shape):
    ref, port = both_shapes[0][shape], both_shapes[1][shape]
    b_ref, b_port = RS.encode_object(ref), PS.encode_object(port)
    assert b_port == b_ref
    assert PS.blob_digest(b_port) == RS.blob_digest(b_ref)
    assert_same(ref, port)


@pytest.mark.parametrize("shape", SHAPES)
def test_packs_cross_between_the_packages(both_shapes, shape):
    """A reference-written pack decodes in the port, a port-written one in
    the reference: equal lanes, and each re-encodes to the same bytes."""
    ref, port = both_shapes[0][shape], both_shapes[1][shape]
    blob = RS.encode_object(ref)
    in_port = PS.decode_object(blob, ref.oid)
    in_ref = RS.decode_object(PS.encode_object(port), port.oid)
    assert_same(ref, in_port)
    assert_same(in_ref, port)
    assert PS.encode_object(in_port) == blob == RS.encode_object(in_ref)
    if shape.startswith("nopk") or shape == "altered_nopk":
        assert in_port.key_lo is in_port.row_lo
        assert in_port.key_hi is in_port.row_hi


def test_decoded_lanes_own_their_memory():
    """Decoding a read-only blob copies each lane: no CPU tensor is a
    writable view of the caller's bytes, and the words come back as the
    port's int64 bits."""
    obj = sample_objects("port")[0]
    blob = PS.encode_object(obj)
    out = PS.decode_object(blob, obj.oid)
    out.row_lo[0] = 0          # a private copy: writable, blob untouched
    assert PS.encode_object(obj) == blob
    assert out.row_lo.dtype == torch.int64 and out.commit_ts.dtype == \
        torch.int64
    assert out.cols["k"].device.type == "cpu"


def test_digest_is_oid_independent():
    obj = sample_objects("port")[0]
    twin = dataclasses.replace(obj, oid=obj.oid + 1000)
    b1, b2 = PS.encode_object(obj), PS.encode_object(twin)
    assert b1 == b2 and PS.blob_digest(b1) == PS.blob_digest(b2)
    assert PS.decode_object(b1, twin.oid).oid == twin.oid


def _outcome(store, blob):
    try:
        store.decode_object(blob, 1)
    except Exception as exc:            # the class is what is compared
        return type(exc).__name__
    return "decoded"


def test_truncation_at_every_boundary_is_the_same_typed_error():
    blob = RS.encode_object(sample_objects("ref")[0])
    for cut in range(len(blob)):
        got = _outcome(PS, blob[:cut])
        assert got == _outcome(RS, blob[:cut]), cut
        assert got in ("TornFrame", "CorruptFrame", "PackFormatError")


def test_trailing_garbage_is_the_same_typed_error():
    blob = RS.encode_object(sample_objects("ref")[0])
    for tail in (b"\x00", b"garbage", blob[:17]):
        got = _outcome(PS, blob + tail)
        assert got == _outcome(RS, blob + tail)
        assert got in ("TornFrame", "CorruptFrame", "PackFormatError")


def test_flipped_byte_sweep_gives_the_references_outcomes():
    blob = RS.encode_object(sample_objects("ref")[0])
    rng = np.random.default_rng(1234)
    positions = set(rng.integers(0, len(blob), size=256).tolist())
    positions |= set(range(16))
    for pos in sorted(positions):
        bad = bytearray(blob)
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        bad = bytes(bad)
        assert PS.blob_digest(bad) != PS.blob_digest(blob)
        assert _outcome(PS, bad) == _outcome(RS, bad), pos


def test_seeded_roundtrip_sweep_equals_the_reference():
    rng = np.random.default_rng(7)
    for _ in range(8):
        n = int(rng.integers(1, 40))
        keys = rng.choice(np.arange(-1000, 1000), size=n, replace=False)
        batch = {"k": keys.astype(np.int64), "v": rng.random(n) * 1e6,
                 "doc": [bytes(rng.integers(0, 256, size=int(
                     rng.integers(0, 80)), dtype=np.uint8).tobytes())
                     for _ in range(n)]}
        blobs = []
        for side in ("ref", "port"):
            e = engine(side)
            e.create_table("t", schema(side, SCH, ("k",)))
            e.insert("t", {k: (list(v) if k == "doc" else v.copy())
                           for k, v in batch.items()})
            blobs.append(STORE[side].encode_object(
                e.store.get(next(iter(e.store.oids())))))
        assert blobs[0] == blobs[1]
        out = PS.decode_object(blobs[0], 9)
        assert PS.encode_object(out) == blobs[0] and out.oid == 9
        cut = int(rng.random() * (len(blobs[0]) - 1))
        assert _outcome(PS, blobs[0][:cut]) == _outcome(RS, blobs[0][:cut])


# ------------------------------------------------------------- CRC32C

@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4095, 65_536 + 7, 1 << 20])
def test_numpy_crc32c_equals_google_crc32c(n):
    google_crc32c = pytest.importorskip("google_crc32c")
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    want = google_crc32c.value(data)
    assert P_wal._np_crc32c(data) == want
    assert P_wal._np_crc32c(memoryview(bytearray(data))) == want
    assert P_wal.crc32c(data) == want


def test_numpy_crc32c_equals_every_frame_of_a_reference_pack():
    google_crc32c = pytest.importorskip("google_crc32c")
    e, _ = lineitem_engine("ref", True, 3000)
    obj = e.store.get(e.table("lineitem").directory.data_oids[0])
    blob = RS.encode_object(obj)
    frames = list(P_wal.iter_frames(memoryview(blob), 8))
    assert len(frames) > 10
    for payload, _ in frames:
        assert P_wal._np_crc32c(payload) == google_crc32c.value(
            bytes(payload))


def test_crc32c_fallback_warns_once(monkeypatch, capsys):
    monkeypatch.setattr(P_wal, "_py_crc32c_bytes", 0)
    monkeypatch.setattr(P_wal, "_py_crc32c_warned", False)
    monkeypatch.setattr(P_wal, "_PY_CRC32C_WARN_BYTES", 1024)
    P_wal._note_py_crc32c(512)
    assert capsys.readouterr().err == ""
    P_wal._np_crc32c(bytes(4096))
    P_wal._np_crc32c(bytes(4096))
    err = capsys.readouterr().err
    assert err.count("numpy-sliced crc32c fallback") == 1
