"""The CUDA kernels of the port against their plain versions, on the card.

Marked ``card``: each test needs an NVIDIA GPU with ``nvcc`` and skips
elsewhere (the skip is decided inside the fixture, never at import). On
the GPU host:

    python -m pytest -q -m card --noconftest tests/test_torch_card.py

(``--noconftest``: the suite's conftest imports the JAX reference, which
the GPU host does not have; this file imports nothing of it.)

Every integer kernel output must equal its plain version exactly (no
tolerance), including the shapes that stress the launch geometry: empty
inputs, one element, ragged last blocks, streams long enough for the
segsum look-back to walk past a 32-tile window, and views that are not
16-byte aligned. The flash attention kernel is held to its
plain version in bf16 at atol = rtol = 2e-2 (the plain version rounds
each block's P.V product to bf16, the kernel accumulates it in fp32), and
its relative L2 error at ``chip_smoke.FLASH_REL_TOL``. Its backward
is held to the plain backward at the same atol and rtol and at
``chip_smoke.BWD_REL_TOL``, its LSE at ``chip_smoke.LSE_TOL``, and two of
its launches must give the same bits.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import digests
from repro_torch.distributed import sharding
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.probe import probe
from repro_torch.kernels.rowhash import signatures
from repro_torch.kernels.searchsorted import searchsorted, searchsorted_sides
from repro_torch.kernels.segsum_diff import segsum
from chip_smoke import (BWD_MQA_SHAPE, BWD_REL_TOL, BWD_SHAPES,
                        BWD_WINDOW_SHAPES, EXAMPLES, FLASH_CROSS_SHAPES,
                        FLASH_REL_TOL, GOLDEN,
                        GOLDEN_APPLY, LSE_TOL, TRAIN_GNORM_TOL,
                        TRAIN_LOSS_TOL, finish, run_example)

pytestmark = pytest.mark.card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU host with `python "
                    "-m pytest -m card --noconftest tests/test_torch_card.py`")
    build.reset_launches()
    yield torch.device("cuda")
    build.reset_launches()


def _u64(rng, n, dom=2**64):
    a = rng.integers(0, dom, n, dtype=np.uint64) if dom == 2**64 \
        else rng.integers(0, dom, n).astype(np.uint64)
    return a


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(dev)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("rows,lanes", [(0, 24), (1, 24), (257, 2),
                                        (70_001, 24), (4096, 4)])
def test_rowhash_kernel_matches_plain(cuda, rows, lanes):
    g = torch.Generator(device=cuda).manual_seed(rows + lanes)
    x = torch.randint(-2**31, 2**31 - 1, (rows, lanes), generator=g,
                      device=cuda, dtype=torch.int32)
    for k, p in zip(signatures(x), ref.signatures(x.cpu())):
        _equal(k, p)
    assert build.LAUNCHES["rowhash"] == (1 if rows else 0)


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 65_537])
def test_searchsorted_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    tab = np.sort(_u64(rng, n))
    q = np.concatenate([rng.choice(tab, 500), _u64(rng, 500),
                        np.asarray([0, 2**63 - 1, 2**63, 2**64 - 1],
                                   np.uint64)])
    for side in ("left", "right"):
        got = searchsorted(_t(tab, cuda), _t(q, cuda), side)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      np.searchsorted(tab, q, side))
        _equal(got, ref.lower_bound(_t(tab, "cpu"), _t(q, "cpu"), side))
    empty = _t(np.zeros(0, np.uint64), cuda)
    assert searchsorted(empty, _t(q, cuda)).abs().sum().item() == 0
    assert searchsorted(_t(tab, cuda), empty).shape == (0,)


@pytest.mark.parametrize("n,lo_dom,hi_dom", [(1, 2, 2), (700, 23, 5),
                                             (262_144, 2**64, 2**64),
                                             (5000, 40, 2**64)])
def test_probe_kernel_matches_plain(cuda, n, lo_dom, hi_dom):
    rng = np.random.default_rng(n)
    lo, hi = _u64(rng, n, lo_dom), _u64(rng, n, hi_dom)
    o = np.lexsort((hi, lo))
    lo, hi = lo[o], hi[o]
    q_lo = np.concatenate([lo[rng.integers(0, n, 300)], _u64(rng, 300,
                                                              lo_dom)])
    q_hi = np.concatenate([hi[rng.integers(0, n, 300)], _u64(rng, 300,
                                                              hi_dom)])
    got = probe(_t(lo, cuda), _t(hi, cuda), _t(q_lo, cuda), _t(q_hi, cuda))
    want = ref.probe(_t(lo, "cpu"), _t(hi, "cpu"), _t(q_lo, "cpu"),
                     _t(q_hi, "cpu"))
    for k, p in zip(got, want):
        _equal(k, p)


@pytest.mark.parametrize("n,nq", [(1, 9), (1000, 46), (100_000, 46),
                                  (65_537, 3000)])
def test_searchsorted_per_query_side_matches_numpy(cuda, n, nq):
    rng = np.random.default_rng(n + nq)
    tab = np.sort(np.concatenate([_u64(rng, n - n // 4),
                                  _u64(rng, n // 4, 50)]))
    q = np.concatenate([rng.choice(tab, nq - 4),
                        np.asarray([0, 2**63 - 1, 2**63, 2**64 - 1],
                                   np.uint64)])
    for k in sorted({0, 1, nq // 2, nq - 1, nq}):
        got = searchsorted_sides(_t(tab, cuda), _t(q, cuda), k)
        want = np.concatenate([np.searchsorted(tab, q[:k], "left"),
                               np.searchsorted(tab, q[k:], "right")])
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        _equal(got, ref.lower_bound_sides(_t(tab, "cpu"), _t(q, "cpu"), k))
    assert build.LAUNCHES["searchsorted"] == len({0, 1, nq // 2, nq - 1, nq})


def _sorted_keys(lo, hi):
    o = np.lexsort((hi, lo))
    return lo[o], hi[o]


def _probe_case(case, rng):
    """(table lo, hi sorted by (lo, hi); queries lo, hi) for one case."""
    n = 262_144
    lo, hi = _sorted_keys(_u64(rng, n), _u64(rng, n))
    if case == "one-row windows":      # each tile repeats one key (or gap)
        pick = np.sort(rng.integers(0, n, 40))
        q_lo, q_hi = np.repeat(lo[pick], 32), np.repeat(hi[pick], 32)
        q_hi[32 * 20:] += np.uint64(1)          # the last 20 tiles miss
        return lo, hi, *_sorted_keys(q_lo, q_hi)
    if case in ("thousands of rows", "unsorted", "half-sorted"):
        pick = rng.integers(0, n, 2175)        # the main path's shape
        q_lo = np.concatenate([lo[pick], _u64(rng, 2175)])
        q_hi = np.concatenate([hi[pick], _u64(rng, 2175)])
        q_lo, q_hi = _sorted_keys(q_lo, q_hi)
        if case == "unsorted":
            o = rng.permutation(q_lo.shape[0])
            q_lo, q_hi = q_lo[o], q_hi[o]
        elif case == "half-sorted":            # every other tile reversed
            for a in range(0, q_lo.shape[0], 64):
                q_lo[a:a + 32] = q_lo[a:a + 32][::-1].copy()
                q_hi[a:a + 32] = q_hi[a:a + 32][::-1].copy()
        return lo, hi, q_lo, q_hi
    if case == "whole table":          # one tile spans every row
        return lo, hi, *_sorted_keys(_u64(rng, 40), _u64(rng, 40))
    if case == "ragged last tile":
        pick = rng.integers(0, n, 1000)
        return lo, hi, *_sorted_keys(lo[pick], hi[pick])
    if case == "n = 1":
        one_lo, one_hi = _u64(rng, 1), _u64(rng, 1)
        q_lo = np.concatenate([one_lo, one_lo, one_lo, _u64(rng, 60)])
        q_hi = np.concatenate([one_hi, one_hi - np.uint64(1),
                               one_hi + np.uint64(1), _u64(rng, 60)])
        return one_lo, one_hi, *_sorted_keys(q_lo, q_hi)
    if case == "below and above":      # table in the middle of the range
        mid_lo, mid_hi = _sorted_keys(
            rng.integers(2**62, 2**63, 5000, dtype=np.uint64),
            _u64(rng, 5000))
        q_lo = np.concatenate([np.zeros(40, np.uint64), mid_lo[:3],
                               np.full(40, 2**64 - 1, np.uint64)])
        q_hi = np.concatenate([_u64(rng, 40), mid_hi[:3], _u64(rng, 40)])
        return mid_lo, mid_hi, *_sorted_keys(q_lo, q_hi)
    if case == "long runs":            # equal keys past the forward scan,
        base_lo, base_hi = _u64(rng, 3000, 900), _u64(rng, 3000, 2)
        lens = rng.integers(1, 40, 3000)   # and lo64 collision runs
        lo, hi = _sorted_keys(np.repeat(base_lo, lens),
                              np.repeat(base_hi, lens))
        pick = rng.integers(0, lo.shape[0], 3000)
        q_lo = np.concatenate([lo[pick], _u64(rng, 500, 900)])
        q_hi = np.concatenate([hi[pick], _u64(rng, 500, 3)])
        return lo, hi, *_sorted_keys(q_lo, q_hi)
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "one-row windows", "thousands of rows", "whole table", "unsorted",
    "half-sorted", "ragged last tile", "n = 1", "below and above",
    "long runs"])
def test_probe_kernel_paths_match_plain(cuda, case):
    rng = np.random.default_rng(list(case.encode()))
    arrays = _probe_case(case, rng)
    got = probe(*(_t(a, cuda) for a in arrays))
    want = ref.probe(*(_t(a, "cpu") for a in arrays))
    for k, p in zip(got, want):
        _equal(k, p)
    if case == "long runs":
        assert int(want[1].max()) > 4     # runs longer than the scan
    assert build.LAUNCHES["probe"] == 1


def test_kernels_launch_on_the_current_stream(cuda):
    """Under ``torch.cuda.stream(s)`` a launch lands on ``s``: its queries
    are written on ``s`` behind a sleep, so a kernel on another stream
    would read them before they are there."""
    rng = np.random.default_rng(11)
    lo, hi = _sorted_keys(_u64(rng, 70_000), _u64(rng, 70_000))
    pick = np.sort(rng.integers(0, 70_000, 3000))
    t_lo, t_hi, want_lo, want_hi = (_t(a, cuda) for a in
                                    (lo, hi, lo[pick], hi[pick]))
    q_lo, q_hi = torch.zeros_like(want_lo), torch.zeros_like(want_hi)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(200_000_000)
        q_lo.copy_(want_lo)
        q_hi.copy_(want_hi)
        start, cnt = probe(t_lo, t_hi, q_lo, q_hi)
        bounds = searchsorted_sides(t_lo, q_lo, 1500)
        left = searchsorted(t_lo, q_lo)
    s.synchronize()
    np.testing.assert_array_equal(start.cpu().numpy(), pick)
    assert bool((cnt == 1).all())
    np.testing.assert_array_equal(left.cpu().numpy(), pick)
    np.testing.assert_array_equal(bounds.cpu().numpy(), np.concatenate(
        [pick[:1500], pick[1500:] + 1]))


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 3 * 1024 * 1024 + 5,
                               4095, 4096, 4097, 200_000, 6_001_215,
                               12_002_430])
@pytest.mark.parametrize("rows", [False, True])
def test_segsum_kernel_matches_plain(cuda, n, rows):
    rng = np.random.default_rng(n + rows)
    lo = np.sort(_u64(rng, n, 1 + n // 3))
    hi = lo % np.uint64(3)
    r = _u64(rng, n, 2)
    sg = rng.choice(np.array([-1, 1], np.int32), n)
    args = [lo, hi]
    extra = [r, r] if rows else []
    got = segsum(*(_t(a, cuda) for a in args),
                 torch.from_numpy(sg).to(cuda),
                 *(_t(a, cuda) for a in extra))
    want = ref.segsum(*(_t(a, "cpu") for a in args), torch.from_numpy(sg),
                      *(_t(a, "cpu") for a in extra))
    for k, p in zip(got, want):
        _equal(k, p)
    assert build.LAUNCHES["segsum_diff"] == 1
    empty = _t(np.zeros(0, np.uint64), cuda)
    b, c = segsum(empty, empty, torch.zeros(0, dtype=torch.int32,
                                            device=cuda))
    assert b.shape == c.shape == (0,)
    assert build.LAUNCHES["segsum_diff"] == 1


@pytest.mark.parametrize("rows", [False, True])
def test_segsum_kernel_on_unaligned_views(cuda, rows):
    """Views that start one element in (8-byte words, 4-byte signs) take
    the kernel's scalar loads and stores, with the same result."""
    rng = np.random.default_rng(5 + rows)
    n = 70_001
    lo = np.sort(_u64(rng, n + 1, n // 2))
    words = [_t(lo, cuda), _t(lo % np.uint64(3), cuda)]
    if rows:
        r = _t(_u64(rng, n + 1, 2), cuda)
        words += [r, r]
    sg = torch.from_numpy(rng.choice(np.array([-1, 1], np.int32),
                                     n + 1)).to(cuda)
    views = [w[1:] for w in words]
    assert all(v.data_ptr() % 16 for v in views) and sg[1:].data_ptr() % 16
    got = segsum(views[0], views[1], sg[1:], *views[2:])
    want = ref.segsum(*(v.cpu() for v in views[:2]), sg[1:].cpu(),
                      *(v.cpu() for v in views[2:]))
    for k, p in zip(got, want):
        _equal(k, p)


def test_segsum_launches_on_the_current_stream(cuda):
    """Under ``torch.cuda.stream(s)`` the scratch memset and the scan land
    on ``s``: the signs are written on ``s`` behind a sleep."""
    rng = np.random.default_rng(12)
    n = 1_000_003
    lo = _t(np.sort(_u64(rng, n, n // 2)), cuda)
    hi = torch.zeros_like(lo)
    want_sg = torch.from_numpy(rng.choice(np.array([-1, 1], np.int32),
                                          n)).to(cuda)
    sg = torch.zeros_like(want_sg)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(200_000_000)
        sg.copy_(want_sg)
        got = segsum(lo, hi, sg)
    s.synchronize()
    for k, p in zip(got, ref.segsum(lo.cpu(), hi.cpu(), want_sg.cpu())):
        _equal(k, p)


def test_segsum_refuses_a_short_scratch(cuda):
    """The C entry checks the scratch it is handed against its own tile
    count and launches nothing when it is short."""
    from repro_torch.kernels import segsum_diff
    n = 3 * segsum_diff.TILE + 1
    lo = torch.arange(n, dtype=torch.int64, device=cuda)
    sg = torch.ones((n,), dtype=torch.int32, device=cuda)
    bnd = torch.empty((n,), dtype=torch.bool, device=cuda)
    csum = torch.empty((n,), dtype=torch.int32, device=cuda)
    scratch = torch.empty((4,), dtype=torch.int64, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        segsum_diff._SEGSUM(lo.get_device(), lo.data_ptr(), lo.data_ptr(),
                            None, None, sg.data_ptr(), n, bnd.data_ptr(),
                            csum.data_ptr(), scratch.data_ptr(), 4)
    assert build.LAUNCHES["segsum_diff"] == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("seed", [0, 1])
def test_ops_on_lo64_collisions_match_cpu(cuda, seed):
    """The ops around the kernels (refinement of lo64 collisions, segment
    expansion, one-launch scans, stable merges) give the CPU's answers."""
    rng = np.random.default_rng([seed] + list(b"OPS"))
    n = 5000
    lo, hi = _u64(rng, n, 40), _u64(rng, n, 7)
    o = np.lexsort((hi, lo))
    lo, hi = lo[o], hi[o]
    q_lo, q_hi = _u64(rng, 900, 42), _u64(rng, 900, 9)
    sg = rng.choice(np.array([-1, 1], np.int32), n)
    runs = np.asarray([0, 1200, 3100], np.int64)
    r_lo, r_hi = _u64(rng, n, 50), _u64(rng, n, 3)
    for a, b in zip(runs, list(runs[1:]) + [n]):   # each run (lo, hi)-sorted
        o = a + np.lexsort((r_hi[a:b], r_lo[a:b]))
        r_lo[a:b], r_hi[a:b] = r_lo[o], r_hi[o]

    def both(fn, *arrays):
        got = fn(*(_t(a, cuda) if a.dtype != np.int32 else
                   torch.from_numpy(a).to(cuda) for a in arrays))
        want = fn(*(_t(a, "cpu") if a.dtype != np.int32 else
                    torch.from_numpy(a) for a in arrays))
        return got, want

    for side in ("left", "right"):
        _equal(*both(lambda *a: ops.searchsorted128(*a, side=side),
                     lo, hi, q_lo, q_hi))
    for got, want in zip(*both(ops.probe128, lo, hi, q_lo, q_hi)):
        _equal(got, want)
    _equal(*both(ops._sort128, q_lo, q_hi))
    # the card scans a stream in one launch, with the CPU's bytes
    build.reset_launches()
    (g_o, g), (w_o, w) = both(
        lambda a, b, c: ops.diff_aggregate(a, b, c, presorted=True),
        lo, hi, sg)
    assert build.LAUNCHES["segsum_diff"] == 1
    _equal(g.boundary, w.boundary)
    _equal(g.run_sums, w.run_sums)
    build.reset_launches()
    (g_o, g), (w_o, w) = both(
        lambda a, b, c, d, e: ops.diff_aggregate_rows(
            a, b, c, d, e, presorted=True), lo, hi, r_lo, r_hi, sg)
    assert build.LAUNCHES["segsum_diff"] == 1
    _equal(g.boundary, w.boundary)
    _equal(g.run_sums, w.run_sums)
    merged = []
    for dev in (cuda, "cpu"):
        lo_t, hi_t = _t(r_lo, dev), _t(r_hi, dev)
        cuts = sharding.plan_key_cuts(lo_t, hi_t, runs, 3)
        merged.append(ops.merge128_runs(lo_t, hi_t, runs, cuts=cuts))
    _equal(*merged)
    np.testing.assert_array_equal(merged[1].numpy(),
                                  np.lexsort((r_hi, r_lo)))


@pytest.mark.parametrize("pk", [True, False])
def test_golden_digests_on_the_card(cuda, pk):
    assert digests.run_workload(pk, device=cuda) == GOLDEN[pk]
    assert digests.run_apply_workload(pk, device=cuda) == GOLDEN_APPLY[pk]
    assert all(build.LAUNCHES[k] > 0 for k in build.VCS_SOURCES), \
        build.LAUNCHES


def _workflow(dev, pk, n=20_000, change=1_500):
    """Branch, edit, PR diff, CI preview, publish, revert the publish,
    Δ-revert a merge, drop the branch, GC: what each step leaves."""
    from repro_torch.benchmarks.vcs_tables import _mk_engine, _random_update
    from repro_torch.core import ConflictMode, snapshot_diff, three_way_merge
    engine, base = _mk_engine(n, pk, device=dev)
    sn1 = engine.create_snapshot("sn1", "lineitem")
    engine.clone_table("t", sn1)
    _random_update(engine, "t", base, change, np.random.default_rng(1), pk)
    sn3 = engine.create_snapshot("sn3", "t")
    pre = engine.current_snapshot("lineitem")
    three_way_merge(engine, "lineitem", sn3, base=sn1,
                    mode=ConflictMode.ACCEPT)
    post = engine.current_snapshot("lineitem")
    engine.create_branch("dev", ["lineitem"])
    _random_update(engine, "dev/lineitem", base, change,
                   np.random.default_rng(2), pk, tag=7)
    hashed = engine.commit_stats.rows_rehashed
    build.reset_launches()
    pr = engine.open_pr("main", "dev")
    groups = pr.diff()["lineitem"].n_groups
    pr.add_check(lambda ctx: ctx.count("lineitem") == n, "rows")
    oids = set(engine.store.oids())
    ok = [r.ok for r in pr.run_checks()]
    assert set(engine.store.oids()) == oids
    rep = pr.publish()["lineitem"]
    out = {"groups": groups, "checks": ok,
           "publish": (rep.inserted, rep.deleted, rep.true_conflicts),
           "published": digests.scan_digest(engine, "lineitem")}
    pr.revert_publish()
    out["publish_reverted"] = digests.scan_digest(engine, "lineitem")
    engine.revert("lineitem", pre, post)
    assert snapshot_diff(engine.store, pre,
                         engine.current_snapshot("lineitem")).is_empty()
    out["reverted"] = digests.scan_digest(engine, "lineitem")
    assert engine.commit_stats.rows_rehashed == hashed
    engine.drop_branch("dev")
    out["gc"] = vars(engine.gc())
    out["oids"] = sorted(engine.store.oids())
    return out, dict(build.LAUNCHES)


@pytest.mark.parametrize("pk", [True, False])
def test_publish_revert_and_gc_on_the_card(cuda, pk):
    got, launches = _workflow(cuda, pk)
    want, _ = _workflow("cpu", pk)
    assert got == want
    assert got["groups"] == 3_000 and got["publish"] == (1_500, 1_500, 0)
    assert got["gc"]["objects_freed"] > 0
    assert all(launches[k] > 0 for k in ("searchsorted", "probe",
                                         "segsum_diff")), launches


def _state(engine, *tables):
    """ts, commit log and each table's scan digest and object ids."""
    return (engine.ts,
            [(r.ts, r.table, r.kind, r.inserted, r.deleted)
             for r in engine.commit_log],
            {t: (digests.scan_digest(engine, t),
                 engine.table(t).directory.data_oids) for t in tables})


def _indices(dev, n=6_000, change=500):
    """Index backfill, lookups, maintenance through updates and deletes,
    a clone with its index, all on ``dev``."""
    from repro_torch.benchmarks.vcs_tables import _mk_engine
    from repro_torch.core import create_index, lookup_eq
    engine, base = _mk_engine(n, True, device=dev)
    spec = create_index(engine, "lineitem", "by_part", ["l_partkey"])
    rng = np.random.default_rng(3)
    idx = rng.choice(n, size=change, replace=False)
    upd = {k: v[idx].copy() for k, v in base.items()}
    upd["l_partkey"] = upd["l_partkey"] + 200_000
    engine.update_by_keys("lineitem", upd)
    engine.delete_by_keys("lineitem", {
        "l_orderkey": base["l_orderkey"][idx[:50]],
        "l_linenumber": base["l_linenumber"][idx[:50]]})
    engine.create_snapshot("s", "lineitem")
    engine.clone_table("c", "s", with_indices=True)
    hits = [sorted(lookup_eq(engine, t, "by_part", {"l_partkey": int(v)})
                   ["l_orderkey"].tolist())
            for t in ("lineitem", "c")
            for v in np.concatenate([base["l_partkey"][idx[:20]],
                                     upd["l_partkey"][:20]])]
    return _state(engine, "lineitem", spec.aux_table, "c"), hits


def test_indices_on_the_card(cuda):
    got, want = _indices(cuda), _indices("cpu")
    assert got == want
    assert any(got[1]) and build.LAUNCHES["rowhash"] > 0
    assert build.LAUNCHES["probe"] > 0


@pytest.mark.parametrize("pk", [True, False])
def test_compaction_on_the_card(cuda, pk):
    from repro_torch.benchmarks.vcs_tables import _mk_engine, _random_update
    from repro_torch.core import compact_table, snapshot_diff

    def run(dev):
        engine, base = _mk_engine(20_000, pk, device=dev)
        for tag in range(3):
            _random_update(engine, "lineitem", base, 700,
                           np.random.default_rng(tag), pk, tag=tag)
        snap = engine.create_snapshot("pre", "lineitem")
        objs = len(engine.table("lineitem").directory.data_oids)
        written = compact_table(engine, "lineitem")
        assert len(engine.table("lineitem").directory.data_oids) < objs
        assert snapshot_diff(engine.store, snap, engine.current_snapshot(
            "lineitem")).is_empty()
        objs = [engine.store.get(o) for o in
                engine.table("lineitem").directory.data_oids]
        lanes = [[o.row_lo.cpu(), o.key_lo.cpu(), o.commit_ts.cpu()]
                 for o in objs]
        return written, _state(engine, "lineitem"), lanes
    got, want = run(cuda), run("cpu")
    assert got[:2] == want[:2]
    for a, b in zip(got[2], want[2]):
        for x, y in zip(a, b):
            _equal(x, y)


@pytest.mark.parametrize("pk", [True, False])
def test_materialize_and_alter_on_the_card(cuda, pk):
    from repro_torch.benchmarks.vcs_tables import _mk_engine, _random_update
    from repro_torch.core import Column, CommitStats, CType

    def run(dev):
        engine, base = _mk_engine(20_000, pk, device=dev)
        _random_update(engine, "lineitem", base, 900,
                       np.random.default_rng(5), pk)
        engine.create_snapshot("s", "lineitem")
        engine.commit_stats = CommitStats()
        engine.clone_table("m", "s", materialize=True)
        mat = vars(engine.commit_stats)
        engine.commit_stats = CommitStats()
        engine.alter_table_add_column("m", Column("flag", CType.I64), 3)
        alt = vars(engine.commit_stats)
        return mat, alt, _state(engine, "lineitem", "m")
    got, want = run(cuda), run("cpu")
    assert got == want
    assert got[0]["rows_rehashed"] == 0 and got[0]["rows_carried"] == 20_000
    assert got[1]["rows_rehashed"] == 20_000
    assert got[1]["lob_rows_hashed"] == 0


@pytest.mark.parametrize("pk", [True, False])
def test_per_key_conflicts_on_the_card(cuda, pk):
    from repro_torch.benchmarks.vcs_tables import _mk_engine, _random_update
    from repro_torch.core import snapshot_diff

    def run(dev):
        engine, base = _mk_engine(20_000, pk, device=dev)
        s = engine.create_snapshot("s", "lineitem")
        for name, seed in (("a", 1), ("b", 2)):
            engine.clone_table(name, s)
            _random_update(engine, name, base, 1_000,
                           np.random.default_rng(seed), pk, tag=seed)
        d = snapshot_diff(engine.store, engine.current_snapshot("a"),
                          engine.current_snapshot("b"))
        return d.n_groups, [g.tolist() for g in d.per_key_conflicts()]
    got, want = run(cuda), run("cpu")
    assert got == want
    assert (len(got[1]) > 0) == pk


def test_replay_on_the_card(cuda):
    """A history with every record kind, serialized and replayed onto the
    card: equal to the live card engine and to the CPU's replay."""
    from repro_torch.core import WAL, Engine, compact_objects
    from repro_torch.core.indices import create_index, drop_index
    from repro_torch.core.schema import Column, CType, Schema

    def run(dev):
        sch = Schema((Column("k", CType.I64), Column("v", CType.F64),
                      Column("doc", CType.LOB)), primary_key=("k",))
        e = Engine(device=dev)
        e.create_table("t", sch)
        e.insert("t", {"k": np.arange(300), "v": np.arange(300) * 0.5,
                       "doc": [b"d%d" % i for i in range(300)]})
        create_index(e, "t", "by_v", ["v"])
        e.update_by_keys("t", {"k": [3, 4], "v": [9.0, 9.5],
                               "doc": [b"x", b"y"]})
        e.create_snapshot("s", "t")
        e.clone_table("m", "s", materialize=True)
        e.alter_table_add_column("m", Column("f", CType.I32), 1)
        drop_index(e, "t", "by_v")
        compact_objects(e, "t", list(e.table("t").directory.data_oids))
        e.create_branch("dev", ["t"])
        e.update_by_keys("dev/t", {"k": [5], "v": [1.0], "doc": [b"z"]})
        pr = e.open_pr("main", "dev")
        pr.publish()
        pr.revert_publish()
        e2 = Engine.replay(WAL.deserialize(e.wal.serialize()), device=dev)
        assert _state(e2, "t", "m") == _state(e, "t", "m")
        return _state(e2, "t", "m")
    assert run(cuda) == run("cpu")


def test_three_doors_on_the_card(cuda, tmp_path):
    """The 16-step script through Repo, statements, the CLI and replay on
    the card: every fingerprint equal to the CPU Repo's."""
    from chip_smoke import drive_doors
    got, _ = drive_doors(cuda, tmp_path)
    want, _ = drive_doors(torch.device("cpu"), tmp_path)
    for door, fp in got.items():
        assert fp == want["python"], door
    assert want["statements"] == want["cli"] == want["python"]
    assert all(build.LAUNCHES[k] > 0 for k in build.VCS_SOURCES)


def _tier_engine(dev, pk, rows=3000):
    from repro_torch.benchmarks.vcs_tables import _mk_engine
    engine, base = _mk_engine(rows, pk, device=dev)
    engine.update_by_keys("lineitem", {k: v[:50].copy()
                                       for k, v in base.items()}) \
        if pk else engine.insert("lineitem", {k: v[:50].copy()
                                             for k, v in base.items()})
    return engine


@pytest.mark.parametrize("pk", [True, False])
def test_pack_round_trip_of_a_device_object(cuda, pk):
    """A device object packs to the CPU's bytes and decodes back onto the
    card with one host-to-device copy per numeric lane, its NoPK key
    lanes still its row lanes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.store import decode_object, encode_object
    engine = _tier_engine(cuda, pk)
    oid = engine.table("lineitem").directory.data_oids[0]
    obj = engine.store.get(oid)
    blob = encode_object(obj)
    cpu = _tier_engine("cpu", pk)
    assert blob == encode_object(cpu.store.get(oid))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        back = decode_object(blob, oid, cuda)
        torch.cuda.synchronize()
    lanes = 3 + (0 if pk is False else 2) + len(back.lob_sigs) + sum(
        torch.is_tensor(c) for c in back.cols.values())
    copies = sum(e.count for e in prof.key_averages() if "HtoD" in e.key)
    assert copies == lanes
    assert (back.key_lo is back.row_lo) == (not pk)
    assert back.row_lo.device.type == "cuda"
    assert encode_object(back) == blob


@pytest.mark.parametrize("pk", [True, False])
def test_golden_apply_from_an_evicted_store_on_the_card(cuda, pk, tmp_path):
    got = digests.run_apply_workload(pk, device="cuda", pack_root=tmp_path)
    assert got == GOLDEN_APPLY[pk]
    assert build.LAUNCHES["probe"] > 0 and build.LAUNCHES["segsum_diff"] > 0


def test_fsck_on_the_card(cuda, tmp_path):
    """fsck recomputes signatures with the rowhash kernel on the card and
    reports as the CPU does, clean and with a planted fault."""
    from repro_torch.core import fsck
    from repro_torch.core.faults import corrupt_object_bit
    from repro_torch.store import attach_packs

    def run(dev):
        engine = _tier_engine(dev, True)
        attach_packs(engine.store, str(tmp_path / str(dev)))
        engine.store.evict_all()
        clean = fsck(engine)
        oid = engine.table("lineitem").directory.data_oids[0]
        corrupt_object_bit(engine.store.get(oid), row=3, bit=1)
        bad = fsck(engine, check_replay=False)
        return (clean.ok, clean.rows_verified, clean.packs_checked,
                [(i.kind, i.oid) for i in bad.issues])
    got = run(cuda)
    assert build.LAUNCHES["rowhash"] > 0
    assert got == run("cpu") and got[0] and len(got[3]) == 1


def test_a_sanitized_lane_refuses_an_in_place_cuda_op(cuda):
    from repro_torch.core import objects
    prev = objects.set_sanitize(True)
    try:
        engine = _tier_engine(cuda, False, rows=500)
        obj = engine.store.get(engine.table("lineitem").directory.data_oids[0])
        assert obj.row_lo.is_cuda and obj.key_lo is obj.row_lo
        with pytest.raises(RuntimeError):
            obj.row_lo.add_(1)
        with pytest.raises(RuntimeError):
            obj.cols["l_quantity"][:4].mul_(2)
    finally:
        objects.set_sanitize(prev)


def _qkv(dev, b, sq, sk, h, kv, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).bfloat16()
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", [
    (2, 100, 100, 4, 4, 64, True),       # ragged square, B > 1
    (1, 130, 130, 8, 2, 128, True),      # GQA 4:1 at hd 128
    (3, 77, 200, 4, 1, 64, False),       # all pairs, MQA, Sq < Sk ragged
    (2, 256, 190, 6, 3, 128, False),     # all pairs, Sk off the tile
    (1, 64, 150, 4, 2, 64, True),        # top-left causal, Sq < Sk
    (1, 150, 64, 4, 4, 64, True),        # causal, Sq > Sk
    (1, 1, 1, 2, 2, 64, True),           # one position
    # the K/V ring wraps several times (8 key tiles over 3 / 2 stages)
    (1, 1024, 1024, 4, 4, 64, True),
    (1, 1024, 1024, 4, 4, 128, True),
    # Sk off the TMA box at a batch boundary: a tile that read batch b + 1
    # instead of zeros would show; with 24 heads the CTAs take 128 rows
    (3, 200, 200, 24, 8, 128, False),
    (3, 150, 200, 4, 4, 64, False),
    # the serving shape at a short prompt: the 64-row tile of small grids
    (1, 512, 512, 16, 16, 64, True),
    # 128-row tiles, causal, ragged Sq, GQA 5:1
    (2, 1000, 1000, 80, 16, 64, True),
])
def test_flash_attention_kernel_matches_plain(cuda, b, sq, sk, h, kv, hd,
                                              causal):
    q, k, v = _qkv(cuda, b, sq, sk, h, kv, hd, seed=sq + sk)
    got = flash_attention(q, k, v, causal=causal)
    want = ref.attention(q, k, v, causal=causal, block=32)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) <= FLASH_REL_TOL
    assert build.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("block_m", [64, 128])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", [
    (1, 1024, 1024, 4, 4, 128, True),    # the ring wraps
    (2, 1000, 1000, 80, 16, 64, True),   # causal, ragged Sq, GQA 5:1
    (3, 150, 200, 4, 4, 64, False),      # Sk off the box, B > 1
])
def test_flash_attention_forced_tiles_match_plain(cuda, block_m, b, sq, sk,
                                                  h, kv, hd, causal):
    q, k, v = _qkv(cuda, b, sq, sk, h, kv, hd, seed=sq + sk)
    got = flash_attention(q, k, v, causal=causal, block_m=block_m).float()
    want = ref.attention(q, k, v, causal=causal, block=32).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert float((got - want).norm() / want.norm()) <= FLASH_REL_TOL
    assert build.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("b,sq,h,hd,block_m", [
    (1, 512, 16, 64, 64),      # 64 CTAs of 128 rows would idle half the SMs
    (1, 1024, 16, 64, 64),
    (1, 1536, 16, 64, 128),
    (1, 2048, 16, 64, 128),
    (1, 4096, 16, 128, 128),
])
def test_flash_attention_config_takes_the_tile_by_grid(cuda, b, sq, h, hd,
                                                       block_m):
    from repro_torch.kernels.flash_attention import config
    cfg = config(b, sq, h, hd, cuda)
    assert cfg["block_m"] == block_m and cfg["block_n"] == 128
    assert cfg["threads"] == 128 * (block_m // 64 + 1)
    assert cfg["stages"] >= 2 and 0 < cfg["regs"] <= 255
    assert cfg["smem_bytes"] <= 232448
    assert build.LAUNCHES["flash_attention"] == 0


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 2, 2, 64)
    with pytest.raises(ValueError):
        flash_attention(q.float(), k.float(), v.float())
    q, k, v = _qkv(cuda, 1, 64, 64, 2, 2, 96)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    assert build.LAUNCHES["flash_attention"] == 0


def test_server_prefills_through_the_flash_kernel(cuda):
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.lm import LM
    srv = Server("qwen1.5-0.5b", device=cuda, seq_cap=128)
    # the reduced config's head dim (16) has no kernel instance: widen it
    srv.cfg = dataclasses.replace(srv.cfg, head_dim=64)
    srv.model = LM(srv.cfg, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, srv.cfg.vocab, size=n), 4)
            for i, n in enumerate((32, 64, 96, 32, 64))]
    done, _, _ = srv.run(reqs)
    assert build.LAUNCHES["flash_attention"] == \
        srv.cfg.n_layers * len(reqs)
    assert all(len(r.out) == 4 and all(0 <= t < srv.cfg.vocab
                                       for t in r.out) for r in done)


def test_serve_cli_runs_the_published_widths(cuda, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen1.5-0.5b", "--requests", "3", "--max-new",
                "4", "--batch", "2"])
    assert capsys.readouterr().out.startswith("served 3 requests")
    assert build.LAUNCHES["flash_attention"] == 24 * 3


def _bwd_close(got, want):
    for x, w in zip(got, want):
        torch.testing.assert_close(x.float(), w, atol=2e-2, rtol=2e-2)
        if float(w.norm()) > 1e-3:      # a gradient that is not ~0
            assert float((x.float() - w).norm() / w.norm()) <= BWD_REL_TOL


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", [
    (2, 63, 63, 4, 4, 64, True),         # one tile, ragged
    (2, 64, 64, 4, 2, 64, True),         # the tile seam, GQA 2:1
    (1, 65, 65, 8, 2, 128, True),        # past the seam, GQA 4:1, hd 128
    (1, 129, 129, 4, 1, 64, True),       # MQA: the group sum over 4 heads
    (3, 77, 200, 4, 1, 64, False),       # all pairs, MQA, Sq < Sk ragged
    (2, 256, 190, 6, 3, 128, False),     # all pairs, Sk off the tile
    (1, 150, 64, 4, 4, 64, True),        # top-left causal, Sq > Sk
    (1, 1, 1, 2, 2, 64, True),           # one position
    # the seams of the 128-key tile: a consumer's 64 keys all past Sk
    # (129), exactly one tile (128), one key short (127)
    (2, 127, 127, 4, 4, 64, True),
    (1, 128, 128, 4, 2, 64, True),
    (2, 129, 129, 4, 4, 128, False),
    (1, 129, 129, 2, 2, 64, True),
    # Sq > Sk across 128-key tiles: query tiles past the last key tile
    # take every key tile's part, in order
    (2, 400, 130, 4, 2, 64, True),
    (1, 333, 257, 4, 4, 128, False),
    (2, 300, 300, 4, 1, 128, True),      # MQA over 4 heads at hd 128
    (1, 512, 512, 8, 2, 128, True),      # GQA 4:1 at hd 128, 4 key tiles
    *BWD_SHAPES,                         # chip_smoke's three shapes
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, sq, sk, h, kv,
                                                  hd, causal):
    q, k, v = _qkv(cuda, b, sq, sk, h, kv, hd, seed=sq + sk)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(sq), device=cuda).bfloat16()
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want_o, want_lse = ref.attention_lse(q, k, v, causal=causal, block=64)
    assert float((lse - want_lse).abs().max()) <= LSE_TOL
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert [x.dtype for x in got] == [torch.bfloat16] * 3
    assert [x.shape for x in got] == [q.shape, k.shape, v.shape]
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    _bwd_close(got, ref.attention_bwd(q, k, v, o, lse, do, causal=causal))
    assert build.LAUNCHES["flash_attention_bwd"] == 2


def _bwd_inputs(dev, b, sq, sk, h, kv, hd, causal):
    q, k, v = _qkv(dev, b, sq, sk, h, kv, hd, seed=sq + sk + hd)
    do = torch.randn(q.shape, generator=torch.Generator(device=dev)
                     .manual_seed(sq), device=dev).bfloat16()
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", [
    (2, 1024, 1024, 8, 8, 64, True),     # causal: parts arrive in turn
    (2, 512, 700, 4, 2, 128, False),     # all pairs: every tile waits
])
def test_flash_attention_bwd_gives_the_same_bits_five_times(cuda, b, sq, sk,
                                                            h, kv, hd,
                                                            causal):
    args = _bwd_inputs(cuda, b, sq, sk, h, kv, hd, causal)
    runs = [flash_attention_bwd(*args, causal=causal) for _ in range(5)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(run, runs[0]))
    _bwd_close(runs[0], ref.attention_bwd(*args, causal=causal))
    assert build.LAUNCHES["flash_attention_bwd"] == 5


def test_flash_attention_bwd_needs_no_zeroed_scratch(cuda):
    # The wrapper's scratch comes from torch.empty: the D pass zeroes the
    # counters and the first part of each query tile stores, so a call
    # whose scratch blocks held another call's values, or garbage, gives
    # the same bits.
    b, sq, sk, h, kv, hd = 2, 300, 300, 8, 2, 64
    args = _bwd_inputs(cuda, b, sq, sk, h, kv, hd, True)
    first = flash_attention_bwd(*args, causal=True)
    second = flash_attention_bwd(*args, causal=True)
    sqp = -(-sq // 64) * 64
    junk = [torch.full((2, b, h, sqp), float("nan"), device=cuda),
            torch.full((b, h, sqp, hd), float("nan"), device=cuda),
            torch.full((b * h * (sqp // 64) + 1,), 7, dtype=torch.int32,
                       device=cuda)]
    del junk
    third = flash_attention_bwd(*args, causal=True)
    torch.cuda.synchronize()
    for run in (second, third):
        assert all(torch.equal(x, y) for x, y in zip(run, first))
    _bwd_close(first, ref.attention_bwd(*args, causal=True))
    assert build.LAUNCHES["flash_attention_bwd"] == 3


def test_flash_attention_bwd_config(cuda):
    from repro_torch.kernels.flash_attention_bwd import CONFIG_FIELDS, config
    for hd in (64, 128):
        cfg = config(hd, cuda)
        assert set(CONFIG_FIELDS) <= set(cfg) and cfg["tile_order"]
        assert (cfg["block_n"], cfg["block_m"], cfg["threads"]) == \
            (128, 64, 384)
        assert cfg["stages"] >= 2 and 0 < cfg["regs"] <= 255
        assert cfg["producer_regs"] < cfg["regs"] < cfg["consumer_regs"]
        assert cfg["smem_bytes"] <= 232448
    assert build.LAUNCHES["flash_attention_bwd"] == 0


def test_flash_attention_with_and_without_lse_gives_equal_outputs(cuda):
    for b, sq, sk, h, kv, hd, causal in ((1, 1000, 1000, 16, 4, 64, True),
                                         (2, 300, 450, 8, 8, 128, False)):
        q, k, v = _qkv(cuda, b, sq, sk, h, kv, hd)
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        assert torch.equal(o, flash_attention(q, k, v, causal=causal))
        assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
        for bm in (64, 128):
            o2, lse2 = flash_attention(q, k, v, causal=causal, block_m=bm,
                                       return_lse=True)
            assert float((lse2 - lse).abs().max()) <= LSE_TOL


#: the dO draws of the autograd test: seeds 0-15, and the two draws of
#: ``benchmarks/bwd_draws.py`` (512 seeded draws on an H100) on which the
#: kernel's and the plain bf16 path's gradients fell out of ``_bwd_close``
#: with each other while neither left it against the float32 backward
DO_SEEDS = tuple(range(16)) + (149, 476)


def test_flash_attention_autograd_on_the_card_matches_the_plain_path(cuda):
    # The forward is held against the plain path; the backward against
    # the float32 backward of the same bf16 inputs, where the two bf16
    # paths' rounding errors do not add up.
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 2, 300, 300, 8, 4,
                                                  64, seed=3))
    got = ops.attention(q, k, v, causal=True)
    assert build.LAUNCHES["flash_attention"] == 1
    want = ref.attention(q, k, v, causal=True, block=64)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    qf, kf, vf = (x.detach().float() for x in (q, k, v))
    o, lse = ref.attention_lse(qf, kf, vf, causal=True)
    for seed in DO_SEEDS:
        do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                         .manual_seed(seed), device=cuda).bfloat16()
        got_g = torch.autograd.grad(ops.attention(q, k, v, causal=True),
                                    (q, k, v), do)
        _bwd_close(got_g, ref.attention_bwd(qf, kf, vf, o, lse, do.float(),
                                            causal=True))
    assert build.LAUNCHES["flash_attention_bwd"] == len(DO_SEEDS)


def test_flash_attention_bwd_is_as_close_to_float32_as_the_plain_path(cuda):
    # The autograd test above holds the kernel against the plain path in
    # bf16, whose own rounding is of the tolerance's size; here both are
    # held against the float32 backward of the same bf16 inputs, over
    # seeded draws of dO: the kernel's worst error is no larger than the
    # plain bf16 path's.
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 2, 300, 300, 8, 4,
                                                  64, seed=3))
    qf, kf, vf = (x.detach().float() for x in (q, k, v))
    o, lse = ref.attention_lse(qf, kf, vf, causal=True)
    worst = {"kernel": 0.0, "plain": 0.0}
    for draw in range(8):
        do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                         .manual_seed(1000 + draw), device=cuda).bfloat16()
        true = ref.attention_bwd(qf, kf, vf, o, lse, do.float(), causal=True)
        for name, fwd in (("kernel", ops.attention(q, k, v, causal=True)),
                          ("plain", ref.attention(q, k, v, causal=True,
                                                  block=64))):
            grads = torch.autograd.grad(fwd, (q, k, v), do)
            worst[name] = max(worst[name], *(
                float((x.float() - t).abs().max())
                for x, t in zip(grads, true)))
    assert worst["kernel"] <= worst["plain"], worst
    assert build.LAUNCHES["flash_attention_bwd"] == 8


def test_flash_attention_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 2, 2, 64)
    o, lse = flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse, q.float())
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse[:, :1].contiguous(), q)
    q2, k2, v2 = _qkv(cuda, 1, 64, 64, 2, 2, 96)
    with pytest.raises(ValueError):
        flash_attention_bwd(q2, k2, v2, q2, lse, q2)
    assert build.LAUNCHES["flash_attention_bwd"] == 0


def test_train_loop_on_the_card(cuda, capsys):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    # the reduced config's head dim (16) has no kernel instance: widen it
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              head_dim=64)
    _, losses, engine = train_loop(cfg, reduced=False, steps=6,
                                   seq_len=64, global_batch=4, ckpt_every=2,
                                   inject_fault_at=3, log_every=100,
                                   device=cuda)
    assert "rolled back to run1-step-2" in capsys.readouterr().out
    assert len(losses) == 6 and all(np.isfinite(losses))
    steps_run = 7                        # step 3 ran twice
    assert build.LAUNCHES["flash_attention"] == cfg.n_layers * steps_run
    assert build.LAUNCHES["flash_attention_bwd"] == cfg.n_layers * steps_run
    assert engine.device.type == "cuda"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_on_the_card_what_it_prints_on_the_cpu(cuda, name):
    rc, cpu_out, err = finish(run_example(name, "cpu"), name)
    assert rc == 0, err[-2000:]
    rc, card_out, err = finish(run_example(name, "cuda"), name)
    assert rc == 0, err[-2000:]
    assert card_out == cpu_out
    launches = json.loads(err.strip().splitlines()[-1])["launches"]
    assert all(launches[k] > 0 for k in build.VCS_SOURCES), launches


def test_lint_statement_on_a_card_repo_equals_the_runner(cuda):
    from repro_torch.analysis import default_paths, repo_root, run_analysis
    from repro_torch.core import Repo, execute
    root = repo_root()
    findings = run_analysis(default_paths(root), root=root)
    res = execute(Repo(device=cuda), "LINT")
    assert res.kind == "lint" and res.data == findings
    assert not [f for f in findings if not f.suppressed]


# (b, sq, sk, h, kv, hd, window): the window's lower edge inside and across
# 128-key tiles, whole tiles below it skipped, and W = 1
WINDOW_SHAPES = [
    (1, 1000, 1000, 8, 2, 64, 300),      # W off the tile, ragged Sq
    (2, 700, 700, 4, 4, 64, 129),        # W one past the tile, B > 1
    (1, 1024, 1024, 8, 2, 128, 256),     # W a tile multiple, GQA at hd 128
    (1, 600, 600, 6, 1, 128, 1),         # W = 1: each row sees itself
    (1, 300, 500, 4, 2, 64, 77),         # Sq < Sk, top-left causal
    (1, 2048, 2048, 32, 8, 128, 1000),   # mixtral's heads
]


@pytest.mark.parametrize("block_m", [None, 64, 128])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,window", WINDOW_SHAPES)
def test_flash_attention_window_matches_plain(cuda, block_m, b, sq, sk, h,
                                              kv, hd, window):
    q, k, v = _qkv(cuda, b, sq, sk, h, kv, hd, seed=sq + window)
    got, lse = flash_attention(q, k, v, window=window, block_m=block_m,
                               return_lse=True)
    want, want_lse = ref.attention_lse(q, k, v, window=window, block=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) <= FLASH_REL_TOL
    assert float((lse - want_lse).abs().max()) <= LSE_TOL
    # serving's instance (no LSE) gives the same output
    assert torch.equal(got, flash_attention(q, k, v, window=window,
                                            block_m=block_m))
    unwindowed = ref.attention(q, k, v, block=64).float()
    assert float((got.float() - unwindowed).norm()
                 / unwindowed.norm()) > FLASH_REL_TOL
    assert build.LAUNCHES["flash_attention"] == 2


@pytest.mark.parametrize("b,sq,h,kv,hd", [(1, 1000, 8, 2, 64),
                                          (2, 333, 4, 4, 128),
                                          (1, 2048, 32, 8, 128)])
def test_flash_attention_window_past_sq_changes_no_bit(cuda, b, sq, h, kv,
                                                       hd):
    q, k, v = _qkv(cuda, b, sq, sq, h, kv, hd)
    for lse in (False, True):
        plain = flash_attention(q, k, v, return_lse=lse)
        for window in (sq, sq + 5, 2**40):
            got = flash_attention(q, k, v, window=window, return_lse=lse)
            for a, c in zip(got if lse else (got,), plain if lse
                            else (plain,)):
                assert torch.equal(a, c)


def test_flash_attention_window_under_autograd_runs_both_kernels(cuda):
    # the forward with its LSE and the windowed backward kernel, held to
    # the float32 backward of the same bf16 inputs
    q, k, v = (x.requires_grad_() for x in _qkv(cuda, 1, 600, 600, 4, 2, 64,
                                                  seed=9))
    qf, kf, vf = (x.detach().float() for x in (q, k, v))
    o, lse = ref.attention_lse(qf, kf, vf, window=100)
    for seed in DO_SEEDS[:4]:
        do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                         .manual_seed(seed), device=cuda).bfloat16()
        got = torch.autograd.grad(ops.attention(q, k, v, window=100),
                                  (q, k, v), do)
        _bwd_close(got, ref.attention_bwd(qf, kf, vf, o, lse, do.float(),
                                          window=100))
    assert build.LAUNCHES["flash_attention"] == 4
    assert build.LAUNCHES["flash_attention_bwd"] == 4


# (b, sq, sk, h, kv, hd, window) of the windowed backward: the window's
# lower edge off both tiles, on the 128-key and on the 64-row tile, W = 1,
# Sq < Sk and Sq > Sk (rows past Sk + W - 1 see no key: no key tile
# reaches their query tiles), and chip_smoke's (w2), (w3) and (w1) cut to
# 4,096 tokens and W 2,048 (the float32 backward at 8,192 needs 34 GB)
BWD_WINDOW_CASES = [
    (2, 300, 300, 4, 2, 64, 100),
    (1, 700, 700, 8, 2, 128, 128),
    (1, 513, 513, 4, 4, 64, 64),
    (1, 1024, 1024, 8, 8, 64, 129),
    (1, 600, 600, 6, 1, 128, 1),
    (1, 300, 500, 4, 2, 64, 77),
    (2, 500, 200, 4, 2, 64, 90),
    BWD_WINDOW_SHAPES[1],
    BWD_WINDOW_SHAPES[2],
    (1, 4096, 4096, 32, 8, 128, 2048),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,window", BWD_WINDOW_CASES)
def test_flash_attention_bwd_window_matches_float32(cuda, b, sq, sk, h, kv,
                                                    hd, window):
    q, k, v = _qkv(cuda, b, sq, sk, h, kv, hd, seed=sq + window)
    o, lse = flash_attention(q, k, v, window=window, return_lse=True)
    qf, kf, vf = (x.float() for x in (q, k, v))
    of, lsef = ref.attention_lse(qf, kf, vf, window=window)
    for seed in (0, 1, 2):
        do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                         .manual_seed(seed), device=cuda).bfloat16()
        got = flash_attention_bwd(q, k, v, o, lse, do, window=window)
        again = flash_attention_bwd(q, k, v, o, lse, do, window=window)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert all(bool(torch.isfinite(x).all()) for x in got)
        _bwd_close(got, ref.attention_bwd(qf, kf, vf, of, lsef, do.float(),
                                          window=window))
        # and against the plain version on the kernel's own forward
        _bwd_close(got, ref.attention_bwd(q, k, v, o, lse, do,
                                          window=window))
    if sq > sk + window - 1:       # rows that see no key: dq = 0
        assert not got[0][:, sk + window - 1:].any()
    assert build.LAUNCHES["flash_attention_bwd"] == 6


@pytest.mark.parametrize("b,sq,h,kv,hd", [(1, 1000, 8, 2, 64),
                                          (2, 333, 4, 4, 128),
                                          (1, 2048, 16, 8, 128)])   # (w3)
def test_flash_attention_bwd_window_past_sq_changes_no_bit(cuda, b, sq, h,
                                                           kv, hd):
    q, k, v = _qkv(cuda, b, sq, sq, h, kv, hd, seed=sq)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(5), device=cuda).bfloat16()
    o, lse = flash_attention(q, k, v, return_lse=True)
    plain = flash_attention_bwd(q, k, v, o, lse, do)
    for window in (sq, sq + 5, 2**40):
        got = flash_attention_bwd(q, k, v, o, lse, do, window=window)
        assert all(torch.equal(x, y) for x, y in zip(got, plain))


@pytest.mark.parametrize("b,sq,h,hd", [
    (2, 1024, 48, 128), (1, 700, 12, 64),
    tuple(BWD_MQA_SHAPE[i] for i in (0, 1, 3, 5)),      # chip_smoke's (m)
])
def test_flash_attention_bwd_mqa_matches_float32(cuda, b, sq, h, hd):
    # One KV head: each CTA sums dK and dV over every query head. dq is
    # held as every row's is; dk and dv, sums over more than
    # BWD_GROUP_ELEMENTWISE heads, by chip_smoke's group_close: rel-L2
    # within BWD_REL_TOL and no worse at their worst element than the
    # plain bf16 path.
    from chip_smoke import BWD_GROUP_ELEMENTWISE, group_close
    assert h > BWD_GROUP_ELEMENTWISE
    q, k, v = _qkv(cuda, b, sq, sq, h, 1, hd, seed=h)
    o, lse = flash_attention(q, k, v, return_lse=True)
    qf, kf, vf = (x.float() for x in (q, k, v))
    of, lsef = ref.attention_lse(qf, kf, vf)
    for seed in (0, 1):
        do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                         .manual_seed(seed), device=cuda).bfloat16()
        got = flash_attention_bwd(q, k, v, o, lse, do)
        want = ref.attention_bwd(qf, kf, vf, of, lsef, do.float())
        _bwd_close(got[:1], want[:1])
        held = group_close(torch, got, want, q=q, k=k, v=v, do=do)
        assert all(e["close"] for e in held.values()), held
    assert build.LAUNCHES["flash_attention_bwd"] == 2


def test_remat_train_step_of_full_width_mixtral_matches_the_cpu(cuda):
    """The loss and gradients of train_step(remat=True) for one
    full-width mixtral-8x7b layer (window cut to 128, so it binds at 256
    tokens; its matrices at the 32-layer model's scale) on the card, held
    to the same step on the CPU with the card's routes replayed there, as
    chip_smoke's card-vs-CPU check holds it."""
    from chip_smoke import card_vs_cpu_step
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=1,
                              sliding_window=128)
    rec = card_vs_cpu_step(torch, cfg, 0, remat=True)
    assert rec["recompute_flips"] == 0
    assert rec["loss_rel_diff"] <= TRAIN_LOSS_TOL
    assert rec["grad_norm_rel_diff"] <= TRAIN_GNORM_TOL
    assert rec["launches"]["flash_attention_bwd"] == 1


def test_server_serves_moe_and_the_window_through_the_kernel(cuda):
    """Reduced mixtral (MoE, window 16) with its head dim widened to 64
    (the kernel's instances are hd 64 and 128): prompts longer than the
    window prefill through the windowed kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, Server
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              head_dim=64)
    srv = Server(cfg, reduced=False, device=cuda, seq_cap=128,
                 attn_block=16)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, cfg.vocab, size=n), 4)
            for i, n in enumerate((32, 48, 16, 64))]
    done, _, _ = srv.run(reqs)
    assert build.LAUNCHES["flash_attention"] == cfg.n_layers * len(reqs)
    assert all(len(r.out) == 4 and all(0 <= t < cfg.vocab for t in r.out)
               for r in done)


def test_serve_batch_example_on_the_card(cuda, capsys):
    from repro_torch.examples import serve_batch
    done = serve_batch.main([])
    assert capsys.readouterr().out.startswith("served 10 requests / 240 ")
    assert all(len(r.out) == 24 for r in done)
    assert build.LAUNCHES["flash_attention"] == 2 * 10     # layers x reqs


# ------------------------------------------------- state-space serving

def _ssm_params(kind, dtype, device, seed=0):
    """A mixer's leaves at reduced widths (d 64), bf16 or float32 but for
    the leaves the reference keeps in float32."""
    g = torch.Generator().manual_seed(seed)
    d, di, nh, ds = 64, 128, 8, 4
    if kind == "mamba":
        shapes = {"w_in": (d, 2 * di), "w_bcdt": (d, 2 * ds + nh),
                  "w_out": (di, d), "conv": (4, di), "a_log": (nh,),
                  "dt_bias": (nh,), "d_skip": (nh,)}
    else:
        shapes = {n: (d,) for n in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w",
                                    "dec_bias", "ln_x")}
        shapes.update({n: (d, d) for n in ("w_r", "w_k", "w_v", "w_g",
                                           "w_dec", "w_o")})
        shapes["u"] = (4, 16)
    f32 = {"a_log", "dt_bias", "d_skip", "dec_bias", "u"}
    out = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=g) / (8 if len(shape) > 1 else 2)
        if name == "dt_bias":
            t = t - 1.0
        out[name] = t.to(device, torch.float32 if name in f32
                         else getattr(torch, dtype))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_ssm_mixers_on_the_card_match_the_cpu(cuda, kind, dtype):
    """The chunked mixer over 100 positions (chunks of 50) and a decode
    step from its state, on the card and on the CPU: float32 within 1e-4
    of the largest value, bf16 within 2e-2 (test_torch_ssm's bounds)."""
    from repro_torch.models import ssm
    tol = 1e-4 if dtype == "float32" else 2e-2
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = _ssm_params(kind, dtype, dev)
        x = torch.randn((2, 101, 64), generator=torch.Generator()
                        .manual_seed(1)).to(dev, getattr(torch, dtype))
        if kind == "mamba":
            kw = {"d_state": 4, "head_dim": 16, "d_conv": 4}
            y, st = ssm.mamba_mix(p, x[:, :100], **kw)
            y1, st1 = ssm.mamba_decode(p, x[:, 100:], st, **kw)
        else:
            y, st = ssm.rwkv6_mix(p, x[:, :100], head_dim=16)
            y1, st1 = ssm.rwkv6_decode(p, x[:, 100:], st, head_dim=16)
        outs.append([t.float().cpu() for t in (y, y1) + tuple(st1)])
    for got, want in zip(*outs):
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_reduced_ssm_lms_on_the_card_match_the_cpu(cuda, arch):
    """The reduced configs in bf16 (jamba cut to its first 5 layers, the
    card's cut, its head dim widened to 64 for the kernel): the card's
    prefill logits (jamba's attention on the flash kernel) and two
    decode steps against the CPU's plain path, by relative L2, with the
    same cache layout."""
    from repro_torch.configs import first_layers, get_config
    from repro_torch.models.lm import LM
    cfg = get_config(arch).reduced()
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(first_layers(cfg, 5), head_dim=64)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        2, cfg.vocab, (1, 96)))
    logits = []
    for dev in (cuda, torch.device("cpu")):
        model = LM(cfg, device=dev,
                   generator=torch.Generator().manual_seed(0))
        build.reset_launches()
        out, cache = model.prefill(toks.to(dev), seq_cap=128, attn_block=32)
        steps = [out]
        for t in (5, 7):
            out, cache = model.decode_step(torch.tensor([[t]], device=dev),
                                           cache)
            steps.append(out)
        logits.append([s.float().cpu() for s in steps])
        if dev.type == "cuda":
            assert build.LAUNCHES.get("flash_attention", 0) == \
                cfg.slot_kinds().count("attn")
            layout = {k: [tuple(t.shape) for t in
                          (v.values() if isinstance(v, dict) else v)]
                      for k, v in cache.items() if k != "len"}
        else:
            assert layout == {k: [tuple(t.shape) for t in
                                  (v.values() if isinstance(v, dict)
                                   else v)]
                              for k, v in cache.items() if k != "len"}
    for got, want in zip(*logits):
        assert float((got - want).norm() / want.norm()) <= 5e-2


def test_serve_cli_serves_the_ssm_configs_on_the_card(cuda, capsys):
    """rwkv6-7b's first 2 layers and jamba's first 5 at their published
    widths through the CLI: no kernel for rwkv, the flash kernel once a
    request for jamba's one attention layer."""
    from repro_torch.launch import serve
    serve.main(["--arch", "rwkv6-7b", "--layers", "2", "--requests", "2",
                "--max-new", "3", "--batch", "2"])
    assert capsys.readouterr().out.startswith("served 2 requests")
    assert build.LAUNCHES.get("flash_attention", 0) == 0
    serve.main(["--arch", "jamba-1.5-large-398b", "--layers", "5",
                "--requests", "2", "--max-new", "3", "--batch", "2"])
    assert capsys.readouterr().out.startswith("served 2 requests")
    assert build.LAUNCHES["flash_attention"] == 2


# ------------------------------------------------- state-space training

@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_ssm_mixer_gradients_on_the_card_match_the_cpu(cuda, kind):
    """The chunked mixer's gradients (every leaf, the input and the
    carried state) over 100 positions (chunks of 50) from a carried
    state, float32, on the card and on the CPU: each within 1e-4 of its
    largest value, the forward's bound."""
    from repro_torch.models import ssm
    grads = []
    for dev in (cuda, torch.device("cpu")):
        p = {n: t.requires_grad_() for n, t in
             _ssm_params(kind, "float32", dev).items()}
        g = torch.Generator().manual_seed(2)
        x = torch.randn((2, 100, 64), generator=g).to(dev).requires_grad_()
        shapes = ((2, 3, 128), (2, 8, 4, 16)) if kind == "mamba" \
            else ((2, 1, 64), (2, 4, 16, 16))
        st = tuple(torch.randn(s, generator=g).to(dev).requires_grad_()
                   for s in shapes)
        if kind == "mamba":
            y, new = ssm.mamba_mix(p, x, st, d_state=4, head_dim=16,
                                   d_conv=4)
        else:
            y, new = ssm.rwkv6_mix(p, x, st, head_dim=16)
        dy = torch.randn(y.shape, generator=g).to(dev)
        ds = [torch.randn(t.shape, generator=g).to(dev) for t in new]
        ((y * dy).sum() + sum((t * d).sum() for t, d in zip(new, ds))
         ).backward()
        grads.append({**{n: t.grad.cpu() for n, t in p.items()},
                      "x": x.grad.cpu(),
                      **{f"state{i}": t.grad.cpu() for i, t in
                         enumerate(st)}})
    got, want = grads
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert float((got[name] - w).abs().max()) <= 1e-4 * float(
            w.abs().max()), name


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_reduced_ssm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One train_step(remat=True) of the reduced config in bf16 (jamba cut
    to slots 0, 1 and 4: mamba, mamba with the MoE, attention, its head
    dim widened to 64 for the kernel) on the card and on the CPU from the
    same weights: the loss and the gradient norm within chip_smoke's
    TRAIN_LOSS_TOL and TRAIN_GNORM_TOL, the float32 leaves and moments
    float32, and jamba's attention layer through both kernels (the
    forward twice under remat)."""
    from repro_torch.configs import get_config, period_slots
    from repro_torch.launch import train
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWCfg, init_opt_state
    cfg = get_config(arch).reduced()
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(period_slots(cfg, (0, 1, 4)), head_dim=64)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        2, cfg.vocab, (2, 129)))
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = LM(cfg, device=dev,
                   generator=torch.Generator().manual_seed(1))
        model.requires_grad_()
        live = dict(model.named_parameters())
        opt_cfg = AdamWCfg(warmup_steps=2, decay_steps=4)
        opt = init_opt_state(live, opt_cfg)
        build.reset_launches()
        opt, metrics = train.train_step(
            model, {"tokens": toks[:, :-1].to(dev),
                    "targets": toks[:, 1:].to(dev)}, opt, opt_cfg,
            train.decay_names(live), 32, remat=True)
        out.append((metrics["loss"].item(), metrics["grad_norm"].item()))
        assert all(t.dtype == torch.float32 for t in opt.mu.values())
        assert {n.rsplit(".", 1)[1] for n, p in live.items()
                if p.dtype == torch.float32} == (
            {"dec_bias", "u"} if arch == "rwkv6-7b"
            else {"a_log", "dt_bias", "d_skip"})
        if dev.type == "cuda":
            n = cfg.slot_kinds().count("attn") * cfg.n_periods
            assert build.LAUNCHES["flash_attention"] == 2 * n
            assert build.LAUNCHES["flash_attention_bwd"] == n
    (loss, gnorm), (cpu_loss, cpu_gnorm) = out
    assert all(np.isfinite([loss, gnorm]))
    assert abs(loss - cpu_loss) / cpu_loss <= TRAIN_LOSS_TOL
    assert abs(gnorm - cpu_gnorm) / cpu_gnorm <= TRAIN_GNORM_TOL


def test_flash_attention_bwd_at_jambas_layer_matches_float32(cuda):
    """The backward at jamba-1.5-large's attention layer, one row of
    chip_smoke's (j): 2,048 positions, GQA 64:8 (a group of 8, held
    elementwise), hd 128, causal, against the float32 backward."""
    from chip_smoke import BWD_GROUP_ELEMENTWISE, BWD_TRAIN_SHAPES
    b, sq, sk, h, kv, hd, causal = (1,) + BWD_TRAIN_SHAPES[-1][1:]
    assert (h, kv, hd) == (64, 8, 128) and h // kv <= BWD_GROUP_ELEMENTWISE
    q, k, v = _qkv(cuda, b, sq, sk, h, kv, hd, seed=64)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(8), device=cuda).bfloat16()
    o, lse = flash_attention(q, k, v, return_lse=True)
    qf, kf, vf = (x.float() for x in (q, k, v))
    of, lsef = ref.attention_lse(qf, kf, vf)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    _bwd_close(got, ref.attention_bwd(qf, kf, vf, of, lsef, do.float()))
    assert build.LAUNCHES["flash_attention_bwd"] == 1


# ------------------------------------------ encoder-decoder and cross serving

@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", FLASH_CROSS_SHAPES)
def test_flash_attention_at_serve_crosss_shapes_matches_plain(
        cuda, b, sq, sk, h, kv, hd, causal):
    """The forward all pairs at chip_smoke's cross rows: whisper's encoder
    over 1,500 frames and its cross sublayer, llama-vision's cross layers
    over 6,404 patches (GQA 64:8, hd 128, the key tail ragged), and the
    Server's 8 stub frames (every tile ragged)."""
    q, k, v = _qkv(cuda, b, sq, sk, h, kv, hd, seed=sq + sk)
    got = flash_attention(q, k, v, causal=causal).float()
    want = ref.attention(q, k, v, causal=causal, block=256).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert float((got - want).norm() / want.norm()) <= FLASH_REL_TOL
    assert build.LAUNCHES["flash_attention"] == 1


#: the cross-model card test's query projections are scaled by this:
#: at the published widths and init scale the port's attention scores
#: have a standard deviation of ~40, so attention is an argmax that a
#: one-ulp difference flips, and two bf16 paths part by the flips (the
#: 2 + 2 layer whisper in bf16 against float32 on the CPU: 0.53-0.97 of
#: the logits' norm; the card against the CPU 0.227 in a first run). At
#: 1/64 the scores sit near one standard deviation, the softmax spreads
#: over the keys and the masks and sums carry weight: bf16 against float32
#: reads 0.0125 there
CROSS_TEST_QUERY_SCALE = 1 / 64


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_cross_lms_on_the_card_match_the_cpu(cuda, arch):
    """At the published widths and init scale, whisper cut to 2 encoder
    and 2 decoder layers and llama-vision's first period (its cross layer
    and four attention layers), their query projections scaled by
    CROSS_TEST_QUERY_SCALE, with a context of 300 positions (off the
    128-key tile): the card's prefill logits (encoder, self and cross
    attention on the flash kernel, as many launches as chip_smoke counts)
    and two decode steps against the same weights moved to the CPU, by
    relative L2, with the same cache layout."""
    from chip_smoke import attention_layers, published_init_scale
    from repro_torch.configs import first_layers, get_config
    from repro_torch.models.lm import LM
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=2, encoder_layers=2) \
        if cfg.is_encdec else first_layers(cfg, 5)
    model = LM(cfg, device=cuda,
               generator=torch.Generator(device=cuda).manual_seed(0))
    published_init_scale(torch, model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".wq", ".xq")):
                p.copy_((p.float() * CROSS_TEST_QUERY_SCALE).bfloat16())
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        2, cfg.vocab, (1, 96)))
    ctx = torch.randn((1, 300, cfg.d_model),
                      generator=torch.Generator().manual_seed(1)).bfloat16()
    logits, layouts = [], []
    for dev in (cuda, torch.device("cpu")):
        model.to(dev)
        build.reset_launches()
        out, cache = model.prefill(toks.to(dev), ctx.to(dev), seq_cap=128,
                                   attn_block=32)
        if dev.type == "cuda":
            assert build.LAUNCHES["flash_attention"] == \
                attention_layers(cfg)
        steps = [out]
        for t in (5, 7):
            out, cache = model.decode_step(torch.tensor([[t]], device=dev),
                                           cache)
            steps.append(out)
        logits.append([x.float().cpu() for x in steps])
        layouts.append({k: {n: tuple(t.shape) for n, t in v.items()}
                        for k, v in cache.items() if k != "len"})
    assert layouts[0] == layouts[1]
    for got, want in zip(*logits):
        assert float((got - want).norm() / want.norm()) <= 5e-2


@pytest.mark.parametrize("b,sq,sk,h,kv,hd", [
    (2, 300, 300, 16, 16, 64),    # (eb) whisper's encoder: 300 = 4 x 64
    #                               + 44 queries, 2 x 128 + 44 keys
    (2, 112, 300, 16, 16, 64),    # (xb) its cross sublayer: 112 = 64 + 48
    (1, 200, 644, 64, 8, 128),    # (vb) llama-vision's cross layer: GQA
    #                               64:8, hd 128, 5 x 128 + a 4-key tail
])
def test_flash_attention_bwd_at_the_cross_shapes_matches_plain(
        cuda, b, sq, sk, h, kv, hd):
    """The backward all pairs at reduced versions of chip_smoke's cross
    rows (eb), (xb) and (vb), each with a ragged query tile that is not a
    multiple of 64 and a ragged key tile, against the plain backward."""
    test_flash_attention_bwd_kernel_matches_plain(cuda, b, sq, sk, h, kv,
                                                  hd, False)


@pytest.mark.parametrize("arch,n_micro", [("whisper-medium", 2),
                                          ("llama-3.2-vision-90b", 1)])
def test_cross_train_step_on_the_card_matches_the_cpu(cuda, arch, n_micro):
    """One ``launch.steps.make_train_step`` step of the reduced config in
    bf16 (widened to 4 heads of 64 for the kernels, its queries scaled by
    P / d so that its scores sit near one deviation, as chip_smoke's
    ``unit_scores``) on the card and on the CPU from the same weights and
    batch (a context of 200 positions, off the 128-key tile): the loss
    and the gradient norm within TRAIN_LOSS_TOL and TRAIN_GNORM_TOL, the
    flash kernels launched as chip_smoke's ``train_launches`` counts (an
    encoder forward once, a decoder attention twice under remat, per
    microbatch), finite parameters after the step."""
    from chip_smoke import train_launches
    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWCfg
    cfg = dataclasses.replace(get_config(arch).reduced(), d_model=256,
                              head_dim=64, d_ff=512, cross_len=200)
    shape = ShapeCfg("t", 200 if cfg.is_encdec else 96, 4, "train")
    specs = steps.input_specs(cfg, shape)["batch"]
    rng = np.random.default_rng(2)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab,
                                        tuple(specs["tokens"].shape)))
    batch = {"tokens": toks, "targets": toks.roll(-1, dims=1),
             "ctx": torch.randn(tuple(specs["ctx"].shape),
                                generator=torch.Generator().manual_seed(3))
             .bfloat16()}
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = LM(cfg, device=dev,
                   generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith((".wq", ".xq")):
                    p.mul_(2 / cfg.d_model)
        opt_cfg = AdamWCfg(warmup_steps=2, decay_steps=4)
        step = steps.make_train_step(cfg, shape, opt_cfg=opt_cfg,
                                     n_micro=n_micro, attn_block=64,
                                     device=dev)
        build.reset_launches()
        state, metrics = step(steps.init_state(model, opt_cfg), batch)
        out.append((metrics["loss"].item(), metrics["grad_norm"].item()))
        assert all(bool(torch.isfinite(p).all())
                   for p in state["params"].values())
        if dev.type == "cuda":
            want = train_launches(cfg, 1, n_micro)
            assert {k: build.LAUNCHES[k] for k in want} == want
    (loss, gnorm), (cpu_loss, cpu_gnorm) = out
    assert all(np.isfinite([loss, gnorm]))
    assert abs(loss - cpu_loss) / cpu_loss <= TRAIN_LOSS_TOL
    assert abs(gnorm - cpu_gnorm) / cpu_gnorm <= TRAIN_GNORM_TOL


# ------------------------------------------------------------ sharded

@pytest.fixture
def card_mesh(cuda, tmp_path):
    """A world-size-1 NCCL group in this process and its 1 x 1 mesh
    (``make_mesh_for(1)``), as chip_smoke's sharded phase starts them."""
    import torch.distributed as dist
    from chip_smoke import process_group
    from repro_torch.distributed.elastic import make_mesh_for
    if dist.is_initialized():
        pytest.skip("a process group is running")
    with process_group(torch, "nccl", tmp_path / "store"):
        yield make_mesh_for(1)


def _widened(arch):
    """The reduced config at 4 heads of 64 (the kernels' head dim)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), d_model=256,
                               head_dim=64, d_ff=512)


@pytest.mark.parametrize("arch,batch,seq,n_micro", [
    ("qwen1.5-0.5b", 4, 256, 1), ("whisper-medium", 4, 200, 2)])
def test_sharded_train_step_on_the_card_equals_the_one_device_step(
        card_mesh, arch, batch, seq, n_micro):
    """chip_smoke's ``sharded_train`` at reduced widths on the card: two
    steps over the NCCL 1 x 1 mesh against the one-device step from the
    same init, losses and every parameter and moment bit for bit, the
    flash kernels launched alike (whisper with its context, in two
    microbatches)."""
    from chip_smoke import sharded_train
    rec = sharded_train(torch, card_mesh, _widened(arch), batch, seq, 2, 0,
                        n_micro=n_micro)
    assert rec["losses_equal"] and not rec["unequal_leaves"], rec
    assert rec["launches"] == rec["plain_launches"]
    assert rec["launches"]["flash_attention_bwd"] > 0


def test_sharded_prefill_and_decode_on_the_card_equal_lm_s(card_mesh):
    """chip_smoke's ``sharded_serve`` at reduced widths on the card: a
    300-token prefill (flash kernel) and 4 decode steps over the mesh
    equal ``LM.prefill`` and ``LM.decode_step`` bit for bit."""
    from chip_smoke import sharded_serve
    rec = sharded_serve(torch, card_mesh, _widened("qwen1.5-0.5b"), 2, 300,
                        4, 0)
    assert rec["prefill_equal"] and rec["cache_equal"], rec
    assert rec["decode_equal"] == [True] * 4
    assert rec["flash_launches"] == _widened("qwen1.5-0.5b").n_layers
