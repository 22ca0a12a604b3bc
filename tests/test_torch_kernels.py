"""The port's kernel contract (``repro_torch.kernels``) against the
reference package's kernels, bit for bit, on the CPU.

On the CPU every kernel wrapper runs its plain PyTorch version, so these
tests pin the plain versions — the oracles each CUDA kernel is held
against on the card (``tests/test_torch_card.py``, ``chip_smoke.py``) —
to ``repro.kernels.ref`` / ``repro.kernels.ops``. Inputs are made with
numpy from fixed seeds and handed to both packages; uint64 words cross
as int64 bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.distributed import sharding as rsharding
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.distributed import sharding
from repro_torch.interop import from_numpy as T
from repro_torch.interop import to_numpy
from repro_torch.kernels import build, ops, ref

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(autouse=True)
def _reset_port_globals():
    build.reset_launches()
    prev = sharding.set_key_shards(None)
    yield
    sharding.set_key_shards(prev)
    build.reset_launches()


def U(t):
    return to_numpy(t, u64=True)


def _sorted_table(rng, n, lo_dom, hi_dom, offset=0):
    lo = (rng.integers(0, lo_dom, n).astype(np.uint64) + np.uint64(offset))
    hi = (rng.integers(0, hi_dom, n).astype(np.uint64) + np.uint64(offset))
    o = np.lexsort((hi, lo))
    return lo[o], hi[o]


def _random_stream(rng, k, n, lo_dom, hi_dom):
    parts, starts, off = [], [], 0
    for _ in range(k):
        m = int(rng.integers(1, n + 1))
        lo, hi = _sorted_table(rng, m, lo_dom, hi_dom)
        parts.append((lo, hi))
        starts.append(off)
        off += m
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.asarray(starts, np.int64))


# ------------------------------------------------------------------ rowhash

@pytest.mark.parametrize("rows,lanes", [(1024, 2), (2048, 6), (3072, 24),
                                        (1024, 1), (0, 4), (3, 0)])
def test_rowhash_bits_match_reference(rows, lanes):
    rng = np.random.default_rng(rows + lanes)
    x = rng.integers(0, 2**32, size=(rows, lanes), dtype=np.uint32)
    got = ops.rowhash(T(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, rops._rowhash_np(x))
    lo, hi = ops.signatures_from_lanes(T(x))
    want_lo, want_hi = rops.signatures_from_lanes(x)
    np.testing.assert_array_equal(U(lo), want_lo)
    np.testing.assert_array_equal(U(hi), want_hi)
    if rows and lanes:
        np.testing.assert_array_equal(
            got, np.asarray(rref.rowhash(jnp.asarray(x))))


def test_fmix32_matches_reference():
    h = np.random.default_rng(9).integers(0, 2**32, 4096, dtype=np.uint32)
    got = ref.fmix32(T(h.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(rref.fmix32(jnp.asarray(h))))


# ------------------------------------------------------------- searchsorted

@pytest.mark.parametrize("n", [1, 1000, 4096, 65536])
def test_bounds_match_numpy_on_full_uint64_range(n):
    rng = np.random.default_rng(n)
    tab = np.sort(rng.integers(0, 2**64, size=n, dtype=np.uint64))
    q = np.concatenate([
        rng.choice(tab, size=300),
        rng.integers(0, 2**64, size=300, dtype=np.uint64),
        np.asarray([0, 2**63 - 1, 2**63, U64_MAX], np.uint64)])
    for side, fn, rfn in (("left", ops.lower_bound, rops.lower_bound),
                          ("right", ops.upper_bound, rops.upper_bound)):
        got = fn(T(tab), T(q)).numpy()
        np.testing.assert_array_equal(got, np.searchsorted(tab, q, side))
        np.testing.assert_array_equal(got, rfn(tab, q))


def test_bounds_with_duplicates_and_max_word():
    tab = np.asarray([1, 5, 5, 5, 9, U64_MAX, U64_MAX], np.uint64)
    q = np.asarray([0, 5, 6, U64_MAX, 2**63], np.uint64)
    for side in ("left", "right"):
        got = ref.lower_bound(T(tab), T(q), side).numpy()
        np.testing.assert_array_equal(got, np.searchsorted(tab, q, side))
    # the reference served upper_bound as lb(q + 1) with a max-word guard
    np.testing.assert_array_equal(ops.upper_bound(T(tab), T(q)).numpy(),
                                  rops.upper_bound(tab, q))


def test_bounds_empty_inputs():
    z = T(np.zeros((0,), np.uint64))
    one = T(np.asarray([7], np.uint64))
    assert ops.lower_bound(z, one).tolist() == [0]
    assert ops.upper_bound(one, z).shape == (0,)
    assert ops.searchsorted128(z, z, one, one).tolist() == [0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted128_matches_reference_on_lo64_collisions(seed, side):
    rng = np.random.default_rng([seed] + list(b"SS128"))
    for n, nq, lo_dom, hi_dom, off in [(1, 8, 2, 2, 0), (64, 200, 9, 4, 0),
                                       (500, 300, 17, 3, 2**63),
                                       (500, 300, 3, 50, 2**64 - 60)]:
        t_lo, t_hi = _sorted_table(rng, n, lo_dom, hi_dom, off)
        q_lo = (rng.integers(0, lo_dom + 2, nq).astype(np.uint64)
                + np.uint64(off))
        q_hi = (rng.integers(0, hi_dom + 2, nq).astype(np.uint64)
                + np.uint64(off))
        got = ops.searchsorted128(T(t_lo), T(t_hi), T(q_lo), T(q_hi), side)
        want = rops.searchsorted128(t_lo, t_hi, q_lo, q_hi, side=side)
        np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------------- probe

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_probe128_matches_reference(seed):
    rng = np.random.default_rng([seed] + list(b"PROBE"))
    for n, nq, lo_dom, hi_dom, off in [(0, 5, 4, 3, 0), (7, 0, 4, 3, 0),
                                       (1, 8, 2, 2, 0), (64, 200, 9, 4, 0),
                                       (500, 300, 17, 3, 2**64 - 40),
                                       (500, 300, 3, 50, 2**63 - 1)]:
        t_lo, t_hi = _sorted_table(rng, n, lo_dom, hi_dom, off)
        q_lo = (rng.integers(0, lo_dom + 2, nq).astype(np.uint64)
                + np.uint64(off))
        q_hi = (rng.integers(0, hi_dom + 2, nq).astype(np.uint64)
                + np.uint64(off))
        for order in (np.arange(nq), np.lexsort((q_hi, q_lo))):
            got_s, got_c = ops.probe128(T(t_lo), T(t_hi), T(q_lo[order]),
                                        T(q_hi[order]))
            want_s, want_c = rops.probe128(t_lo, t_hi, q_lo[order],
                                           q_hi[order])
            np.testing.assert_array_equal(got_c.numpy(), want_c)
            np.testing.assert_array_equal(got_s.numpy(), want_s)


_sig = st.tuples(st.integers(0, 6), st.integers(0, 3))


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(st.lists(_sig, max_size=40).map(sorted), st.lists(_sig, max_size=20),
       st.sampled_from([0, 2**63 - 3, 2**64 - 7]))
def test_probe_and_searchsorted128_property(tbl, qry, off):
    """Tables of (lo, hi) keys from tiny domains (dense lo64 collisions),
    shifted across the sign bit and up to the top of the uint64 range."""
    def words(pairs, i):
        return np.asarray([p[i] + off for p in pairs], np.uint64)
    t_lo, t_hi, q_lo, q_hi = (words(tbl, 0), words(tbl, 1), words(qry, 0),
                              words(qry, 1))
    got = ops.probe128(T(t_lo), T(t_hi), T(q_lo), T(q_hi))
    want = rops.probe128(t_lo, t_hi, q_lo, q_hi)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            ops.searchsorted128(T(t_lo), T(t_hi), T(q_lo), T(q_hi),
                                side).numpy(),
            rops.searchsorted128(t_lo, t_hi, q_lo, q_hi, side=side))


# ------------------------------------------------------------------- segsum

def _words4(lo, hi):
    """(N, 4) uint32 [lo.lo, lo.hi, hi.lo, hi.hi] — the reference layout."""
    lh, ll = rops.unpack64(lo)
    hh, hl = rops.unpack64(hi)
    return np.stack([ll, lh, hl, hh], axis=1)


@pytest.mark.parametrize("n,card", [(2048, 3), (4096, 100), (2048, 2048),
                                    (1, 1)])
def test_segsum_matches_reference_oracle(n, card):
    rng = np.random.default_rng(n + card)
    lo = np.sort(rng.integers(0, card, size=n).astype(np.uint64))
    hi = (lo * np.uint64(7)) % np.uint64(5)
    signs = rng.choice([-1, 1], size=n).astype(np.int32)
    bnd, csum = ref.segsum(T(lo), T(hi), T(signs))
    w_bnd, w_csum = rref.diff_aggregate(jnp.asarray(_words4(lo, hi)),
                                        jnp.asarray(signs))
    np.testing.assert_array_equal(bnd.numpy(), np.asarray(w_bnd))
    np.testing.assert_array_equal(csum.numpy(), np.asarray(w_csum))
    # a second word pair ORs its change flags in (the rows variant)
    r_lo = rng.integers(0, 2, n).astype(np.uint64)
    bnd2, _ = ref.segsum(T(lo), T(hi), T(signs), T(r_lo), T(r_lo))
    r_bnd, _ = rref.diff_aggregate(jnp.asarray(_words4(r_lo, r_lo)),
                                   jnp.asarray(signs))
    np.testing.assert_array_equal(bnd2.numpy(),
                                  np.asarray(w_bnd) | np.asarray(r_bnd))


def _assert_agg_equal(got, want):
    order, agg = got
    w_order, w_agg = want
    np.testing.assert_array_equal(order.numpy(), w_order)
    np.testing.assert_array_equal(agg.boundary.numpy(), w_agg.boundary)
    np.testing.assert_array_equal(agg.run_starts.numpy(), w_agg.run_starts)
    np.testing.assert_array_equal(agg.run_sums.numpy(), w_agg.run_sums)
    np.testing.assert_array_equal(agg.run_lens.numpy(), w_agg.run_lens)
    np.testing.assert_array_equal(agg.run_ids.numpy(), w_agg.run_ids)


@pytest.mark.parametrize("seed", [0, 1])
def test_diff_aggregate_matches_reference(seed):
    rng = np.random.default_rng([seed] + list(b"AGG"))
    lo = rng.integers(0, 40, 500).astype(np.uint64) + np.uint64(2**63 - 20)
    hi = rng.integers(0, 3, 500).astype(np.uint64)
    sg = rng.choice(np.array([-1, 1], np.int32), 500)
    # unsorted input: the stable 128-bit sort runs first
    _assert_agg_equal(ops.diff_aggregate(T(lo), T(hi), T(sg)),
                      rops.diff_aggregate(lo, hi, sg))
    o = np.lexsort((hi, lo))
    lo, hi, sg = lo[o], hi[o], sg[o]
    # one scan gives the bytes of the reference's key-range slices
    got = ops.diff_aggregate(T(lo), T(hi), T(sg), presorted=True)
    for shards in (1, 2, 4, 9):
        _assert_agg_equal(got, rops.diff_aggregate(lo, hi, sg, presorted=True,
                                                   shards=shards))


@pytest.mark.parametrize("seed", [0, 1])
def test_diff_aggregate_rows_matches_reference(seed):
    rng = np.random.default_rng([seed] + list(b"ROWS"))
    lo, hi = _sorted_table(rng, 500, 40, 3)
    sg = rng.choice(np.array([-1, 1], np.int32), 500)
    r_lo = rng.permutation(500).astype(np.uint64)
    r_hi = rng.integers(0, 2, 500).astype(np.uint64)
    got = ops.diff_aggregate_rows(T(lo), T(hi), T(r_lo), T(r_hi), T(sg),
                                  presorted=True)
    for shards in (1, 2, 4, 9):
        _assert_agg_equal(got, rops.diff_aggregate_rows(
            lo, hi, r_lo, r_hi, sg, presorted=True, shards=shards))
    # NoPK aliasing: key IS the row signature (one word pair compared)
    k_lo, k_hi = T(lo), T(hi)
    got = ops.diff_aggregate_rows(k_lo, k_hi, k_lo, k_hi, T(sg),
                                  presorted=True)
    _assert_agg_equal(got, rops.diff_aggregate_rows(lo, hi, lo, hi, sg,
                                                    presorted=True, shards=4))
    # unsorted rows input takes the key sort
    p = rng.permutation(500)
    _assert_agg_equal(
        ops.diff_aggregate_rows(T(lo[p]), T(hi[p]), T(r_lo[p]), T(r_hi[p]),
                                T(sg[p])),
        rops.diff_aggregate_rows(lo[p], hi[p], r_lo[p], r_hi[p], sg[p]))


def test_diff_aggregate_empty():
    z = T(np.zeros((0,), np.uint64))
    order, agg = ops.diff_aggregate(z, z, T(np.zeros((0,), np.int32)))
    assert order.shape == (0,) and agg.run_sums.shape == (0,)
    assert agg.run_lens.shape == (0,) and agg.run_ids.shape == (0,)


# ------------------------------------------------------------ sort / merge

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sort128_matches_lexsort(seed):
    rng = np.random.default_rng([seed] + list(b"SORT"))
    lo = rng.integers(0, 9, 700).astype(np.uint64) * np.uint64(2**61)
    hi = rng.integers(0, 2**64, 700, dtype=np.uint64) % np.uint64(13)
    np.testing.assert_array_equal(ops._sort128(T(lo), T(hi)).numpy(),
                                  np.lexsort((hi, lo)))
    np.testing.assert_array_equal(ops._sort128(T(lo), T(hi)).numpy(),
                                  rops._sort128(lo, hi))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shards", [1, 2, 4, 7])
def test_merge128_runs_and_key_cuts_match_reference(seed, shards):
    rng = np.random.default_rng([seed, shards] + list(b"SHARD"))
    for k, n, lo_dom, hi_dom in [(1, 30, 5, 3), (2, 50, 5, 3),
                                 (5, 200, 31, 2), (9, 400, 7, 7)]:
        lo, hi, starts = _random_stream(rng, k, n, lo_dom, hi_dom)
        want = np.lexsort((hi, lo))
        np.testing.assert_array_equal(
            ops.merge128_runs(T(lo), T(hi), starts).numpy(), want)
        cuts = sharding.plan_key_cuts(T(lo), T(hi), starts, shards)
        r_cuts = rsharding.plan_key_cuts(lo, hi, starts, shards)
        assert (cuts is None) == (r_cuts is None)
        if cuts is None:
            continue
        np.testing.assert_array_equal(U(cuts[0]), r_cuts[0])
        np.testing.assert_array_equal(U(cuts[1]), r_cuts[1])
        got = ops.merge128_runs(T(lo), T(hi), starts, cuts=cuts)
        np.testing.assert_array_equal(got.numpy(), want)


def test_key_shard_count_policy():
    assert sharding.key_shard_count(10) == 1
    n = 4 * sharding.KEY_SHARD_MIN_ROWS
    assert sharding.key_shard_count(n) == rsharding.key_shard_count(n)
    prev = sharding.set_key_shards(3)
    assert sharding.key_shard_count(10) == 3
    sharding.set_key_shards(prev)


# ------------------------------------------------------- packing and misc

def test_pack_unpack_and_segment_expand_match_reference():
    rng = np.random.default_rng(11)
    w = rng.integers(0, 2**64, 257, dtype=np.uint64)
    hi, lo = ops.unpack64(T(w))
    r_hi, r_lo = rops.unpack64(w)
    np.testing.assert_array_equal(hi.numpy(), r_hi)
    np.testing.assert_array_equal(lo.numpy(), r_lo)
    np.testing.assert_array_equal(U(ops.pack64(hi, lo)), w)
    starts = np.asarray([3, 10, 0, 40], np.int64)
    lens = np.asarray([2, 1, 4, 3], np.int64)
    for got, want in zip(ops.segment_expand(T(starts), T(lens)),
                         rops.segment_expand(starts, lens)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_calls_run_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(5)
    tab = np.sort(rng.integers(0, 2**64, 100, dtype=np.uint64))
    ops.lower_bound(T(tab), T(tab))
    ops.probe128(T(tab), T(tab), T(tab), T(tab))
    ops.signatures_from_lanes(T(rng.integers(0, 2**32, (9, 4),
                                             dtype=np.uint32)))
    ops.diff_aggregate(T(tab), T(tab), T(np.ones(100, np.int32)),
                       presorted=True)
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_wrappers_refuse_tensors_off_cuda_and_cpu():
    meta = torch.empty((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.lower_bound(meta, meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.probe128(meta, meta, meta, meta)
    with pytest.raises(ValueError, match="side"):
        ops._searchsorted_kernel(meta, meta, "middle")
