"""The single-pass segsum scan of ``csrc/segsum_diff.cu``, replayed on the
CPU, against the reference's diff-aggregation oracle.

The CUDA kernel cannot run here, so a numpy replay of its tiling holds the
algorithm itself: tiles of ``TILE`` rows cut into quads of 4 rows striped
over threads and steps, flags against the previous lane's last row (lane
0 reads its predecessor), running sums inside a quad, warp scans per
step, a scan of the 32 (step, warp) totals, and the decoupled look-back
over per-tile status words, with the tiles publishing and looking back in
shuffled orders. The replay, the port's plain version (``ref.segsum``, what
a CPU tensor runs) and the reference's oracle
(``repro.kernels.ref.diff_aggregate``) must agree bit for bit, with and
without the row pair. ``ops.diff_aggregate(_rows)`` scans a stream once,
and its bytes equal the reference's key-range slices at any shard count.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.benchmarks import digests
from repro_torch.distributed import sharding
from repro_torch.interop import from_numpy as T
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.segsum_diff import QUADS, THREADS, TILE, segsum

WARPS = THREADS // 32
M32 = np.int64(0xFFFFFFFF)
INVALID, AGGREGATE, INCLUSIVE = 0, 1, 2


@pytest.fixture(autouse=True)
def _reset_launches():
    build.reset_launches()
    yield
    build.reset_launches()


# ------------------------------------------------------------------ replay

def _tile_rows(tile):
    """(QUADS, THREADS, 4) row indices of one tile: quad (k, t) covers rows
    4 (k THREADS + t) .. +3 from the tile's first row."""
    k = np.arange(QUADS)[:, None, None]
    t = np.arange(THREADS)[None, :, None]
    return tile * TILE + 4 * (k * THREADS + t) + np.arange(4)


def _tile_flags(words, rows, n):
    """Change flags of one tile's rows as the kernel forms them."""
    valid = rows < n
    f = np.zeros(rows.shape, bool)
    lane0 = (np.arange(THREADS) % 32 == 0)[None, :]
    first = rows[..., 0]
    for w in words:
        q = np.where(valid, w[np.minimum(rows, n - 1)], 0)
        # the previous lane's last row, by shuffle; lane 0 reads it
        prev = np.roll(q[..., 3], 1, axis=1)
        read = (first > 0) & (first < n)
        direct = np.where(read, w[np.clip(first - 1, 0, n - 1)], 0)
        prev = np.where(lane0, direct, prev)
        f[..., 0] |= q[..., 0] != prev
        f[..., 1:] |= q[..., 1:] != q[..., :-1]
    f[rows == 0] = True
    return f


def _tile_sums(signs, rows, n):
    """(per-row sums inside the tile, tile total), as uint32 values: quad
    running sums, warp scans per step, then the (step, warp) totals'
    exclusive scan in step-major order."""
    s = np.where(rows < n, signs[np.minimum(rows, n - 1)], 0).astype(np.int64)
    run = np.cumsum(s, axis=-1) & M32                       # in the quad
    tot = run[..., 3].reshape(QUADS, WARPS, 32)
    incl = np.cumsum(tot, axis=-1) & M32                    # warp scan
    run = (run + ((incl - tot) & M32).reshape(QUADS, THREADS)[..., None]) \
        & M32
    steps = incl[..., 31].reshape(-1)                       # 32 entries
    assert steps.shape == (32,)
    excl = (np.cumsum(steps) - steps) & M32
    run = (run + excl.reshape(QUADS, WARPS).repeat(32, axis=1)[..., None]) \
        & M32
    return run, int(steps.sum() & M32)


def _schedule(rng, ntiles, order):
    """The order in which tiles take a step: each tile publishes its
    aggregate (step 0), then looks back (one 32-tile window a step),
    tiles taken in id order as from the atomic counter. "in order" runs
    each tile to its end before the next; "shuffled" interleaves started
    tiles at random; "reversed" publishes every aggregate, then steps the
    look-backs from the last tile down."""
    if order == "in order":
        return [t for t in range(ntiles) for _ in range(2)]
    if order == "reversed":
        return list(range(ntiles)) + list(range(ntiles - 1, 0, -1)) * 2
    started, out = 0, []
    while started < ntiles or len(out) < 4 * ntiles * ntiles:
        if started < ntiles and (started == 0 or rng.random() < 0.4):
            out.append(started)
            started += 1
        else:
            out.append(int(rng.integers(0, started)))
    return out


def replay_segsum(lo, hi, signs, r_lo=None, r_hi=None, *, order="shuffled",
                  seed=0):
    """The kernel's algorithm in numpy: (bnd, csum, stats), ``stats``
    counting the AGGREGATE status words look-backs folded in and the most
    windows one look-back read."""
    n = lo.shape[0]
    words = [lo, hi] + ([] if r_lo is None else [r_lo, r_hi])
    ntiles = -(-n // TILE)
    bnd = np.zeros(n, bool)
    csum = np.zeros(n, np.int64)
    status = [(INVALID, 0)] * ntiles
    parts, prefix = {}, {}
    look = {}                       # tile -> (window end, folded so far)
    stats = {"folds": 0, "windows": 0}
    rng = np.random.default_rng(seed)
    for tile in _schedule(rng, ntiles, order) + list(range(ntiles)) * ntiles:
        if tile in prefix:
            continue
        if tile not in parts:       # publish the tile's aggregate
            rows = _tile_rows(tile)
            parts[tile] = rows, _tile_flags(words, rows, n), \
                *_tile_sums(signs.astype(np.int64), rows, n)
            total = parts[tile][3]
            if tile == 0:
                status[0] = (INCLUSIVE, total)
                prefix[0] = 0
            else:
                status[tile] = (AGGREGATE, total)
                look[tile] = (tile, 0)
            continue
        end, acc = look[tile]       # one look-back round of 32 lanes
        window = [status[i] if i >= 0 else (INCLUSIVE, 0)
                  for i in range(end - 1, end - 33, -1)]
        if any(flag == INVALID for flag, _ in window):
            continue                # a lane still waits
        stop = next((j for j, (flag, _) in enumerate(window)
                     if flag == INCLUSIVE), None)
        upto = window if stop is None else window[:stop + 1]
        stats["folds"] += sum(flag == AGGREGATE for flag, _ in upto)
        stats["windows"] = max(stats["windows"], (tile - end) // 32 + 1)
        acc = (acc + sum(v for _, v in upto)) & int(M32)
        if stop is None:
            look[tile] = (end - 32, acc)
            continue
        prefix[tile] = acc
        status[tile] = (INCLUSIVE, (acc + parts[tile][3]) & int(M32))
    assert len(prefix) == ntiles
    for tile, (rows, f, run, _) in parts.items():
        valid = rows < n
        bnd[rows[valid]] = f[valid]
        csum[rows[valid]] = (run[valid] + prefix[tile]) & M32
    return bnd, csum.astype(np.uint32).view(np.int32), stats


# ----------------------------------------------------------------- streams

def _keys4(lo, hi):
    lh, ll = rops.unpack64(lo)
    hh, hl = rops.unpack64(hi)
    return np.stack([ll, lh, hl, hh], axis=1)


def _oracle(lo, hi, sg, r_lo=None, r_hi=None):
    """The reference's oracle: flags of the key (ORed with the row pair's)
    and the global int32 cumsum."""
    bnd, csum = rref.diff_aggregate(jnp.asarray(_keys4(lo, hi)),
                                    jnp.asarray(sg))
    bnd = np.asarray(bnd)
    if r_lo is not None:
        r_bnd, _ = rref.diff_aggregate(jnp.asarray(_keys4(r_lo, r_hi)),
                                       jnp.asarray(sg))
        bnd = bnd | np.asarray(r_bnd)
    return bnd, np.asarray(csum)


def _runs(n, spans, rng):
    """(lo, hi) keys of ``n`` rows, sorted in unsigned order and across
    the int64 sign bit: runs of a few equal keys, and one run over (at
    least) each ``[a, b)`` of ``spans``."""
    new = rng.random(n) < 0.45
    new[0] = True
    for a, b in spans:
        new[a + 1:b] = False
        new[b:b + 1] = True
    run = np.cumsum(new).astype(np.uint64)
    return np.uint64(2**63 - 1000) + run, run % np.uint64(5)


CASES = {
    # a run over one seam, one over a whole tile and both its seams, one
    # over two whole tiles and three seams
    "straddles 1, 2 and 3 tiles": (6 * TILE + 77, [
        (TILE - 9, TILE + 11), (2 * TILE - 3, 3 * TILE + 2),
        (3 * TILE + 500, 5 * TILE + 7)]),
    "all keys equal": (2 * TILE + 3, [(0, 2 * TILE + 3)]),
    "n = 1": (1, []),
    "tile - 1": (TILE - 1, []),
    "tile": (TILE, []),
    "tile + 1": (TILE + 1, []),
    "41 tiles (look-back walks past 32)": (41 * TILE - 5, []),
}


def _stream(case, pair, seed=0):
    n, spans = CASES[case]
    rng = np.random.default_rng([seed, n, pair])
    lo, hi = _runs(n, spans, rng)
    sg = rng.choice(np.array([-1, 1], np.int32), n)
    if not pair:
        return lo, hi, sg, None, None
    # the row pair changes inside key runs, never across a spanned run
    r_lo = rng.integers(0, 2, n).astype(np.uint64)
    for a, b in spans:
        r_lo[a:b] = 7
    return lo, hi, sg, r_lo, r_lo.copy()


@pytest.mark.parametrize("pair", [False, True], ids=["key only", "row pair"])
@pytest.mark.parametrize("case", list(CASES))
def test_replayed_scan_matches_plain_and_reference(case, pair):
    lo, hi, sg, r_lo, r_hi = _stream(case, pair)
    want_b, want_c = _oracle(lo, hi, sg, r_lo, r_hi)
    rows = [] if r_lo is None else [T(r_lo), T(r_hi)]
    b, c = ref.segsum(T(lo), T(hi), T(sg), *rows)
    np.testing.assert_array_equal(b.numpy(), want_b)
    np.testing.assert_array_equal(c.numpy(), want_c)
    # a CPU tensor runs the plain version and launches nothing
    b, c = segsum(T(lo), T(hi), T(sg), *rows)
    np.testing.assert_array_equal(b.numpy(), want_b)
    np.testing.assert_array_equal(c.numpy(), want_c)
    assert build.LAUNCHES["segsum_diff"] == 0
    for order in ("in order", "shuffled", "reversed"):
        r_b, r_c, _ = replay_segsum(lo, hi, sg, r_lo, r_hi, order=order)
        np.testing.assert_array_equal(r_b, want_b)
        np.testing.assert_array_equal(r_c, want_c)


def test_replay_folds_aggregates_and_wraps_like_int32():
    """Out-of-order tiles make look-backs fold AGGREGATE words, the last
    tile's past a 32-tile window, and sums that pass 2**31 wrap as
    int32."""
    n = 41 * TILE - 5
    lo, hi = _runs(n, [], np.random.default_rng(3))
    sg = np.full(n, 2**30 - 1, np.int32)
    sg[::7] = -(2**31)
    _, want_c = _oracle(lo, hi, sg)
    assert want_c.min() < 0 < want_c.max()
    for order in ("shuffled", "reversed"):
        _, c, stats = replay_segsum(lo, hi, sg, order=order, seed=5)
        np.testing.assert_array_equal(c, want_c)
        assert stats["folds"] > 0
    assert stats["windows"] == 2
    _, _, stats = replay_segsum(lo, hi, sg, order="in order")
    assert stats == {"folds": 0, "windows": 1}


def test_tile_follows_the_kernel():
    """The replay and the scratch size follow the kernel's tile: 512
    threads x 2 quads of 4 rows, 32 (step, warp) totals for one warp, as
    the constants of ``csrc/segsum_diff.cu`` say."""
    src = (Path(ops.__file__).parent / "csrc" / "segsum_diff.cu").read_text()
    consts = dict(re.findall(r"constexpr \w+ (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kQuads"])) == (THREADS,
                                                                QUADS)
    assert "kTile = kThreads * kQuads * 4;" in src
    assert (THREADS, QUADS, TILE) == (512, 2, 4096)
    assert QUADS * WARPS == 32
    rows = _tile_rows(1)
    assert sorted(rows.reshape(-1).tolist()) == list(range(TILE, 2 * TILE))


# --------------------------------------------------- ops on a CPU stream

def _assert_agg_equal(got, want):
    _, agg = got
    _, w = want
    np.testing.assert_array_equal(agg.boundary.numpy(), w.boundary)
    np.testing.assert_array_equal(agg.run_starts.numpy(), w.run_starts)
    np.testing.assert_array_equal(agg.run_sums.numpy(), w.run_sums)
    np.testing.assert_array_equal(agg.run_lens.numpy(), w.run_lens)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("case", ["straddles 1, 2 and 3 tiles",
                                  "all keys equal", "tile + 1"])
def test_cpu_diff_aggregate_keeps_the_reference_slices(case, shards):
    """One scan of the whole stream gives the bytes of the reference's
    key-range slices at every shard count."""
    lo, hi, sg, r_lo, r_hi = _stream(case, True, seed=1)
    _assert_agg_equal(
        ops.diff_aggregate(T(lo), T(hi), T(sg), presorted=True),
        rops.diff_aggregate(lo, hi, sg, presorted=True, shards=shards))
    _assert_agg_equal(
        ops.diff_aggregate_rows(T(lo), T(hi), T(r_lo), T(r_hi), T(sg),
                                presorted=True),
        rops.diff_aggregate_rows(lo, hi, r_lo, r_hi, sg, presorted=True,
                                 shards=shards))
    assert build.LAUNCHES["segsum_diff"] == 0


@pytest.mark.parametrize("pk", [True, False])
def test_forced_key_shards_take_one_scan_per_stream(pk, monkeypatch):
    """Key shards steer the merge's key cuts, not the aggregation: the
    diff/merge workload makes as many segsum calls, at the same lengths,
    with 4 shards forced as with none."""
    kernel = ops._segsum_kernel

    def run(shards):
        lengths = []

        def counted(lo, *args):
            lengths.append(int(lo.shape[0]))
            return kernel(lo, *args)
        monkeypatch.setattr(ops, "_segsum_kernel", counted)
        prev = sharding.set_key_shards(shards)
        try:
            digest = digests.run_workload(pk, n_rows=20_000, csize=1_500,
                                          device="cpu")
        finally:
            sharding.set_key_shards(prev)
        return digest, lengths

    want, plain = run(None)
    got, forced = run(4)
    assert got == want
    assert forced == plain and max(plain) > 20_000
