"""The port's key probes against the reference, on the CPU.

``core/table.py`` bounds the window of lo-sorted queries of every
non-empty object of a directory with one searchsorted launch (each zone's
minimum takes side left, its maximum side right) and one host read, where
the reference takes two ``np.searchsorted`` per object
(``src/repro/core/table.py``). Pinned here on the plain versions: those
windows equal the reference's, and ``locate_keys`` and
``locate_rowsig_multi`` return the reference's rowids and ``probe.*``
counters on engines of several objects, with the queries sorted and not,
and with an empty object in the directory.
"""
import collections
import types

import numpy as np
import pytest
import torch

from repro.core import Engine as REngine
from repro.core.objects import seal_data_object as r_seal_data_object
from repro.core.sigs import key_sigs_for_lookup
from repro_torch.core import Column, CType, Engine, Schema
from repro_torch.core import table as ptable
from repro_torch.core.objects import seal_data_object
from repro_torch.interop import from_numpy as T
from repro_torch.interop import to_numpy
from repro_torch.kernels import build, ops, ref

import chip_smoke
from conftest import VCS_SCHEMA, VCS_SCHEMA_NOPK, kv_batch

U64_MAX = 2**64 - 1
P_SCHEMA = Schema((Column("k", CType.I64), Column("v", CType.F64),
                   Column("doc", CType.LOB)), primary_key=("k",))
P_SCHEMA_NOPK = Schema(P_SCHEMA.columns, primary_key=None)


@pytest.fixture(autouse=True)
def _reset_launches():
    build.reset_launches()
    yield
    build.reset_launches()


def U(t):
    return to_numpy(t, u64=True)


def _u64(*xs):
    return np.asarray(xs, np.uint64)


# ------------------------------------------------------------ zone windows

def _window_cases():
    rng = np.random.default_rng(14)
    spread = np.sort(rng.integers(0, U64_MAX, 200, dtype=np.uint64,
                                  endpoint=True))
    zones = [tuple(np.sort(rng.choice(spread, 2))) for _ in range(6)]
    zones.append((spread[3], spread[3]))               # one-row object
    gaps = np.sort(rng.integers(0, U64_MAX, 50, dtype=np.uint64))
    between = [(gaps[i] + np.uint64(1), gaps[i + 1] - np.uint64(1))
               for i in (0, 17, 48) if gaps[i + 1] - gaps[i] > 2]
    mid = np.sort(rng.integers(2**62, 2**63, 64, dtype=np.uint64))
    edges = _u64(5, 5, 5, 7, 9, 9, 2**63, 2**63, U64_MAX, U64_MAX)
    return {
        "spread": (spread, zones),
        "empty windows": (gaps, between),
        "outside every zone": (mid, [_u64(1, 100), _u64(2**63, U64_MAX),
                                     _u64(U64_MAX, U64_MAX), _u64(0, 0)]),
        "equal lo words at the edges": (edges, [
            _u64(5, 9), _u64(9, 2**63), _u64(2**63, U64_MAX), _u64(0, 5),
            _u64(7, 7), _u64(6, 6), _u64(0, U64_MAX)]),
    }


@pytest.mark.parametrize("case", sorted(_window_cases()))
def test_zone_windows_equal_the_reference_per_object_searchsorted(case):
    q, zones = _window_cases()[case]
    objs = [types.SimpleNamespace(key_lo=T(np.asarray(z, np.uint64)))
            for z in zones]
    calls = []
    kernel = ops._searchsorted_sides_kernel

    def counted(*args):
        calls.append(args[1].shape[0])
        return kernel(*args)
    ops._searchsorted_sides_kernel = counted
    try:
        got = ptable._zone_windows(T(q), objs)
    finally:
        ops._searchsorted_sides_kernel = kernel
    want = [(int(np.searchsorted(q, z[0], side="left")),
             int(np.searchsorted(q, z[-1], side="right"))) for z in zones]
    assert got == want
    # one searchsorted call for every window, minima and maxima together
    assert calls == [2 * len(zones)]
    assert ptable._zone_windows(T(q), []) == []


@pytest.mark.parametrize("n_left", [0, 3, 7, 10])
def test_lower_upper_bound_takes_a_side_per_query(n_left):
    tab = _u64(0, 5, 5, 5, 9, 2**63, 2**63, U64_MAX, U64_MAX)
    q = _u64(5, 0, U64_MAX, 2**63, 6, 9, 5, U64_MAX, 1, 2**63 - 1)
    got = ops.lower_upper_bound(T(tab), T(q), n_left)
    want = np.concatenate([np.searchsorted(tab, q[:n_left], side="left"),
                           np.searchsorted(tab, q[n_left:], side="right")])
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ref.lower_bound(T(tab), T(q), "left"),
                       ops.lower_upper_bound(T(tab), T(q), q.shape[0]))
    assert torch.equal(ref.lower_bound(T(tab), T(q), "right"),
                       ops.lower_upper_bound(T(tab), T(q), 0))
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_lower_upper_bound_refuses_a_split_outside_the_queries():
    q = T(_u64(1, 2, 3))
    for n_left in (-1, 4):
        with pytest.raises(ValueError, match="n_left"):
            ops.lower_upper_bound(q, q, n_left)
    assert ops.lower_upper_bound(T(_u64()), q, 2).tolist() == [0, 0, 0]


# ---------------------------------------------------- probes side by side

# objects of 1 to 300 rows: small zones that prune, large ones that overlap
BATCH_SIZES = (1, 3, 40, 300, 7, 120)


def _engines(pk: bool):
    """The same commits on a reference and a port engine: one object per
    insert, then deletes (tombstones) of some rows; NoPK objects hold
    duplicate rows."""
    rng = np.random.default_rng([pk] + list(b"PROBE"))
    keys = rng.permutation(5_000)[:sum(BATCH_SIZES)]
    r, p = REngine(), Engine(device="cpu")
    r.create_table("t", VCS_SCHEMA if pk else VCS_SCHEMA_NOPK)
    p.create_table("t", P_SCHEMA if pk else P_SCHEMA_NOPK)
    off = 0
    for size in BATCH_SIZES:
        part = keys[off:off + size]
        off += size
        if not pk and size > 3:     # duplicate rows: equal-key runs
            part = np.concatenate([part, part[:size // 3], part[:2]])
        for e in (r, p):
            e.insert("t", kv_batch(part))
    gone = keys[::9]
    if pk:
        for e in (r, p):
            e.delete_by_keys("t", {"k": gone})
    else:
        for e, scan_rid in ((r, lambda t: t.scan()[1]),
                            (p, lambda t: U(t.scan()[1]))):
            rid = scan_rid(e.table("t"))[::7]
            tx = e.begin()
            tx.delete_rowids("t", rid if e is r else T(rid))
            tx.commit()
    return r, p, keys, gone


def _with_empty_object(r, p):
    """Each engine's directory with an empty sealed object in the middle."""
    dirs = []
    for e, seal, z in ((r, r_seal_data_object,
                        lambda dt: np.zeros((0,), dt)),
                       (p, seal_data_object,
                        lambda dt: torch.zeros((0,), dtype=dt))):
        u64 = np.uint64 if e is r else torch.int64
        batch = {"k": z(np.int64 if e is r else torch.int64),
                 "v": z(np.float64 if e is r else torch.float64),
                 "doc": np.empty((0,), object)}
        empty = seal(e.store.new_oid(), e.table("t").schema, batch,
                     *(z(u64) for _ in range(5)), {})
        e.store.put(empty)
        d = e.table("t").directory
        dirs.append(type(d)(data_oids=d.data_oids[:3] + (empty.oid,)
                            + d.data_oids[3:], tomb_oids=d.tomb_oids,
                            ts=d.ts))
    return dirs


def _probe_counters(e):
    return {k: v for k, v in e.store.metrics.counters.items()
            if k.startswith("probe.")}


def _order(lo, hi, sort: bool, rng):
    if sort:
        return np.lexsort((hi, lo))
    o = rng.permutation(lo.shape[0])
    assert not (lo[o][1:] >= lo[o][:-1]).all()
    return o


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("empty_object", [False, True],
                         ids=["", "empty-object"])
def test_locate_keys_matches_the_reference(sort, empty_object):
    r, p, keys, gone = _engines(pk=True)
    rng = np.random.default_rng(3)
    # hits, deleted keys, absent keys
    q_keys = np.concatenate([rng.choice(keys, 400), gone[:30],
                             np.arange(6_000, 6_050)])
    lo, hi = key_sigs_for_lookup(VCS_SCHEMA, {"k": q_keys})
    o = _order(lo, hi, sort, rng)
    lo, hi = lo[o], hi[o]
    r_dir, p_dir = _with_empty_object(r, p) if empty_object else (None, None)
    want = r.table("t").locate_keys(lo, hi, r_dir)
    got = p.table("t").locate_keys(T(lo), T(hi), p_dir)
    np.testing.assert_array_equal(U(got), want)
    assert (want != 0).sum() > 300 and (want == 0).sum() >= 80
    assert _probe_counters(p) == _probe_counters(r)
    assert _probe_counters(r)["probe.objects_pruned"] > 0 or not sort


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("empty_object", [False, True],
                         ids=["", "empty-object"])
def test_locate_rowsig_multi_matches_the_reference(sort, empty_object):
    r, p, _, _ = _engines(pk=False)
    rng = np.random.default_rng(4)
    _, _, lo, hi = r.table("t").scan(with_sigs=True)
    lo, hi = np.unique(np.stack([lo, hi]), axis=1)
    lo = np.concatenate([lo, rng.integers(0, U64_MAX, 40, dtype=np.uint64)])
    hi = np.concatenate([hi, rng.integers(0, U64_MAX, 40, dtype=np.uint64)])
    need = rng.integers(1, 4, lo.shape[0])
    o = _order(lo, hi, sort, rng)
    lo, hi, need = lo[o], hi[o], need[o]
    r_dir, p_dir = _with_empty_object(r, p) if empty_object else (None, None)
    want = r.table("t").locate_rowsig_multi(lo, hi, need, r_dir)
    got = p.table("t").locate_rowsig_multi(T(lo), T(hi),
                                           torch.from_numpy(need), p_dir)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(U(g), w)
    assert sum(len(w) > 1 for w in want) > 10    # duplicate runs were taken
    np.testing.assert_array_equal(
        U(p.table("t").locate_rowsig_multi(T(lo), T(hi),
                                           torch.from_numpy(need), p_dir,
                                           flat=True)),
        r.table("t").locate_rowsig_multi(lo, hi, need, r_dir, flat=True))
    assert _probe_counters(p) == _probe_counters(r)


# ------------------------------------------------- chip_smoke's launch counts

def test_probe_and_window_shapes_count_launches_only_and_restore_ops():
    entries = (ops._probe_kernel, ops._searchsorted_sides_kernel)
    q = T(np.sort(np.random.default_rng(2).integers(0, U64_MAX, 64,
                                                   dtype=np.uint64)))
    with chip_smoke.probe_shapes(ops) as probes, \
            chip_smoke.window_shapes(ops) as windows:
        start, cnt = ops.probe128(q, q, q[::3], q[::3])
        ops.lower_upper_bound(q, q[:4], 2)
    # CPU tensors run the plain versions: nothing launched, nothing counted
    assert not probes and not windows
    assert (ops._probe_kernel, ops._searchsorted_sides_kernel) == entries
    assert torch.equal(start, torch.arange(0, 64, 3))
    assert bool((cnt == 1).all())


def test_probe_groups_split_the_main_path_shapes():
    groups = chip_smoke.PROBE_GROUPS
    assert groups[0][1] == 1 and groups[-1][2] is None
    for (_, _, hi), (_, lo, _) in zip(groups, groups[1:]):
        assert lo == hi + 1
    # the SF1 probes: a 262,144-row object per launch, ~4,350 queries each
    hist = collections.Counter({(262_144, 4_333): 5, (262_144, 4_502): 4,
                                (262_144, 4_467): 4, (257_811, 4_390): 2})
    split, checks = chip_smoke.split_by_queries(hist, groups)
    assert [g["launches"] for g in split] == [0, 0, 15, 0]
    assert checks == [(262_144, 4_333)]


def _rows_read_by_descents(tab: np.ndarray, qs: np.ndarray) -> int:
    """Distinct rows that searchsorted.cu's fixed-depth lower-bound
    descent reads for every query of ``qs``."""
    base, length = np.zeros(qs.shape[0], np.int64), tab.shape[0]
    read = set()
    while length > 1:
        half = length >> 1
        read.update((base + half).tolist())
        base = np.where(tab[base + half] < qs, base + half, base)
        length -= half
    read.update(base.tolist())
    return len(read)


@pytest.mark.parametrize("n,q", [(1, 3), (4_096, 1), (4_096, 100),
                                 (65_536, 700), (1_000, 5_000)])
def test_touched_rows_bounds_what_sorted_descents_read(n, q):
    rng = np.random.default_rng(n + q)
    tab = np.sort(rng.integers(0, U64_MAX, n, dtype=np.uint64))
    qs = np.sort(rng.integers(0, U64_MAX, q, dtype=np.uint64))
    rows = chip_smoke.touched_rows(n, q)
    read = _rows_read_by_descents(tab, qs)
    assert read <= rows <= n
    if q == 1:     # one row per level; the last may repeat a pivot
        assert rows == max(1, int(np.ceil(np.log2(n)))) + 1
        assert rows - 1 <= read
