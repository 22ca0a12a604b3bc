"""Attention's backward on the CPU: the plain versions against JAX's
automatic differentiation of the reference's attention, the autograd
function of the port, and a numpy replay of the backward kernel's
schedule.

The kernel itself runs only on the card (``test_torch_card.py``). Its
arithmetic is held here through the plain version it is compared with
there, and its schedule through the replay: one program per (batch, KV
head, 128-key tile) in the kernel's tile-id order, which sums its keys'
dK and dV over the group's query heads and the 64-row query tiles from
the diagonal on, and adds its part of each query tile's dQ in the
kernel's fixed order (descending key tile, the first part stored), at
the tile seams. A second check replays the kernel's index arithmetic
alone: a program only ever waits on programs with smaller ids, and each
of them adds a part to the query tile waited for. Both run with the
sliding window too (a program walks the query tiles up to the last whose
rows see one of its keys), and a third check holds the kernel's
tile-level mask test: a tile that skips the element mask needs none,
and at W >= Sq the window changes no tile's path.

Tolerances: float32 throughout. The plain versions against ``jax.vjp``
at rtol = atol = 1e-5 (the same math, sums in another order: the largest
gap measured is 1.7e-6); the replay against the plain version and
``jax.vjp`` at 1e-5 (another blocking of the same sums); the replay that
rounds P and dS to bf16 where the kernel does, against the plain
version at ``chip_smoke.BWD_REL_TOL`` in relative L2 (the card's bound
for the kernel); ``FlashAttention`` on the CPU against torch's autograd
of ``ref.attention`` at 1e-5.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BWD_REL_TOL, BWD_SHAPES, BWD_WINDOW_SHAPES
from repro.models.layers import block_causal_attention
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

TOL = 1e-5
HD = 16
_SRC = (build.CSRC / "flash_attention_bwd.cu").read_text()
#: keys per CTA tile and query rows per tile of csrc/flash_attention_bwd.cu
TILE = int(re.search(r"constexpr int kBN = (\d+);", _SRC).group(1))
Q_TILE = int(re.search(r"constexpr int kBM = (\d+);", _SRC).group(1))


def _inputs(seed, b, sq, sk, h, kv, hd=HD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd), (b, sq, h, hd))]


def _plain(q, k, v, do, causal):
    """ref.attention_lse then ref.attention_bwd, numpy in and out."""
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = ref.attention_lse(*t[:3], causal=causal)
    grads = ref.attention_bwd(*t[:3], o, lse, t[3], causal=causal)
    return o.numpy(), lse.numpy(), [g.numpy() for g in grads]


# every Sq causal and all pairs, KV = H and KV < H taking turns
@pytest.mark.parametrize("sq,causal,h,kv", [
    (sq, causal, 4, kv) for i, sq in enumerate((1, 63, 64, 65, 130))
    for causal, kv in ((True, (4, 2)[i % 2]), (False, (1, 4)[i % 2]))])
def test_plain_backward_matches_jax_vjp(sq, causal, h, kv):
    sk = sq if causal else sq + 7          # all pairs: Sk off the blocks
    q, k, v, do = _inputs(sq, 2, sq, sk, h, kv)

    @jax.jit
    def forward_and_vjp(a, b, c, d):
        out, vjp = jax.vjp(lambda x, y, z: block_causal_attention(
            x, y, z, causal=causal), a, b, c)
        return out, vjp(d)
    out, want = forward_and_vjp(*(jnp.asarray(x) for x in (q, k, v, do)))
    o, lse, grads = _plain(q, k, v, do, causal)
    np.testing.assert_allclose(o, np.asarray(out), rtol=TOL, atol=TOL)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got, np.asarray(w), rtol=TOL, atol=TOL)
    # lse: the natural log of each row's sum of exponentials of its
    # scaled, masked scores
    s = np.einsum("bqkgh,bskh->bkgqs",
                  q.reshape(2, sq, kv, h // kv, HD), k) / math.sqrt(HD)
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(sk)[None], s,
                     -np.inf)
    want_lse = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(2, h, sq)
    np.testing.assert_allclose(lse, want_lse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal,sq,sk,kv", [(True, 37, 37, 2),
                                             (False, 37, 45, 1)])
def test_flash_attention_autograd_on_cpu_matches_plain_autograd(causal, sq,
                                                                sk, kv):
    g = torch.Generator().manual_seed(sq + sk)
    q = torch.randn(2, sq, 4, HD, generator=g, requires_grad=True)
    k = torch.randn(2, sk, kv, HD, generator=g, requires_grad=True)
    v = torch.randn(2, sk, kv, HD, generator=g, requires_grad=True)
    do = torch.randn(2, sq, 4, HD, generator=g)
    before = dict(build.LAUNCHES)
    got = ops.attention(q, k, v, causal=causal, block_q=8)
    assert got.grad_fn is not None and \
        type(got.grad_fn).__name__.startswith("FlashAttention")
    got_g = torch.autograd.grad(got, (q, k, v), do)
    want = ref.attention(q, k, v, causal=causal, block=8)
    want_g = torch.autograd.grad(want, (q, k, v), do)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    assert build.LAUNCHES == before      # the CPU path launches nothing
    # without grad the forward alone runs: no autograd node
    with torch.no_grad():
        assert ops.attention(q, k, v, causal=causal).grad_fn is None


def test_backward_wrapper_on_cpu_returns_the_input_dtypes():
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(0, 1, 20, 20, 4, 2))
    o, lse = ref.attention_lse(q, k, v)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    want = ref.attention_bwd(q, k, v, o, lse, do)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b.bfloat16())


def tile_of(tile_id, kv, n_kt):
    """(batch, KV head, key tile) of a main-kernel CTA's tile id: by
    (batch, KV head), then key tile from last to first."""
    kt = n_kt - 1 - tile_id % n_kt
    return tile_id // n_kt // kv, tile_id // n_kt % kv, kt


def query_tiles(kt, n_qt, causal, first_shift=0, window=None):
    """The query tiles key tile ``kt`` walks per head: from the diagonal
    on (causal; ``first_shift`` moves the start, a planted fault), else
    all; under a causal ``window`` W up to the tile of row
    kt * TILE + TILE - 2 + W, the last that sees the tile's last key."""
    first = min(kt * TILE // Q_TILE + first_shift, n_qt) if causal else 0
    last = n_qt - 1
    if causal and window is not None:
        last = min(last, (kt * TILE + TILE - 2 + window) // Q_TILE)
    return range(first, last + 1)


def turn_of(qt, kt, n_kt, causal):
    """How many key tiles add their part of query tile ``qt`` before key
    tile ``kt`` does: those above it that reach the tile."""
    kt_max = min(n_kt - 1, (qt * Q_TILE + Q_TILE - 1) // TILE) \
        if causal else n_kt - 1
    return kt_max - kt


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
        .bfloat16().float().numpy()


def replay_bwd(q, k, v, o, lse, do, causal, first_shift=0, rounded=False,
               window=None):
    """The backward kernel's schedule in numpy (float32): the D pass, then
    one program per (batch, KV head, key tile) in tile-id order that sums
    its keys' dK and dV over the group's query heads and the query tiles
    from the diagonal on, and adds its dQ part of each query tile into
    the accumulator in its turn (the first part stored). ``rounded``
    rounds P and dS to bf16 where the kernel takes them as an operand;
    ``first_shift`` moves the first query tile of each program (a planted
    fault); ``window`` is the causal sliding window. Returns (dq, dk, dv,
    the (query tile, key tile) pairs visited
    once per head, each query tile's key tiles in the order they added,
    whether every part came in the turn the kernel computes for it)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    n_qt, n_kt = -(-Sq // Q_TILE), -(-Sk // TILE)
    scale = np.float32(1.0 / math.sqrt(hd))
    f32 = np.float32
    dsum = (do * o).sum(-1)                                  # (B, Sq, H)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)
    dq_acc, order, visited = {}, {}, []
    in_turn = True
    rnd = _bf16 if rounded else (lambda x: x)

    def rows(x, b, r0, n, head, tile):
        out = np.zeros((tile, x.shape[3]), f32)
        out[:max(0, min(tile, n - r0))] = x[b, r0:r0 + tile, head]
        return out

    for tile_id in range(B * KV * n_kt):
        b, kvh, kt = tile_of(tile_id, KV, n_kt)
        k0 = kt * TILE
        kt_rows = rows(k, b, k0, Sk, kvh, TILE)
        vt_rows = rows(v, b, k0, Sk, kvh, TILE)
        dk_acc = np.zeros((TILE, hd), f32)
        dv_acc = np.zeros((TILE, hd), f32)
        kr = k0 + np.arange(TILE)[:, None]
        for j in range(G):
            h = kvh * G + j
            for qt in query_tiles(kt, n_qt, causal, first_shift, window):
                q0 = qt * Q_TILE
                visited.append((qt, kt))
                qs = rows(q, b, q0, Sq, h, Q_TILE)
                dos = rows(do, b, q0, Sq, h, Q_TILE)
                n = max(0, min(Q_TILE, Sq - q0))
                lse_t = np.full(Q_TILE, np.inf, f32)   # P = 0 past Sq
                d_t = np.zeros(Q_TILE, f32)
                lse_t[:n] = lse[b, h, q0:q0 + n]
                d_t[:n] = dsum[b, q0:q0 + n, h]
                qr = q0 + np.arange(Q_TILE)[None, :]
                keep = (kr < Sk) & (qr >= kr) if causal else (kr < Sk)
                if causal and window is not None:
                    keep &= qr - kr < window
                pt = np.where(keep, np.exp(kt_rows @ qs.T * scale - lse_t), 0)
                dst = pt * (vt_rows @ dos.T - d_t)
                dv_acc += rnd(pt) @ dos
                dk_acc += rnd(dst) @ qs
                part = rnd(dst).T @ kt_rows                # (Q_TILE, hd)
                added = order.setdefault((b, h, qt), [])
                in_turn &= len(added) == turn_of(qt, kt, n_kt, causal)
                if added:
                    dq_acc[b, h, qt] += part
                else:
                    dq_acc[b, h, qt] = part
                added.append(kt)
        n = min(TILE, Sk - k0)
        dk[b, k0:k0 + n, kvh] = (dk_acc * scale)[:n]
        dv[b, k0:k0 + n, kvh] = dv_acc[:n]
    dq = np.zeros_like(q)
    for (b, h, qt), acc in dq_acc.items():
        n = min(Q_TILE, Sq - qt * Q_TILE)
        dq[b, qt * Q_TILE:qt * Q_TILE + n, h] = (acc * scale)[:n]
    return dq, dk, dv, visited, order, in_turn


def _pairs(sq, sk, causal, window=None):
    """The (query tile, key tile) pairs the kernel visits per head."""
    n_qt, n_kt = -(-sq // Q_TILE), -(-sk // TILE)
    return [(i, j) for j in range(n_kt)
            for i in query_tiles(j, n_qt, causal, window=window)]


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 2 * TILE + 3])
@pytest.mark.parametrize("causal,h,kv", [(True, 4, 2), (True, 2, 2),
                                         (False, 4, 1)])
def test_replay_of_the_kernel_tiling_matches_plain(n, causal, h, kv):
    sk = n if causal else n + 5
    q, k, v, do = _inputs(n + h, 1, n, sk, h, kv)
    o, lse, want = _plain(q, k, v, do, causal)
    dq, dk, dv, visited, order, in_turn = replay_bwd(q, k, v, o, lse, do,
                                                     causal)
    assert in_turn
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL)
    pairs = _pairs(n, sk, causal)
    # each program visits only the pairs at or below the diagonal, once
    # per query head of its group; every query tile takes a part from
    # each key tile that reaches it, in descending key-tile order
    assert sorted(set(visited)) == sorted(pairs)
    assert len(visited) == len(pairs) * h
    n_qt = -(-n // Q_TILE)
    assert sorted(order) == [(0, hh, qt) for hh in range(h)
                             for qt in range(n_qt)]
    for (_, _, qt), kts in order.items():
        assert kts == sorted((j for i, j in pairs if i == qt), reverse=True)


@pytest.mark.parametrize("sq,sk,causal,h,kv,hd", [
    (2 * TILE + 3, 2 * TILE + 3, True, 4, 2, HD),
    (Q_TILE + 7, 2 * TILE + 9, False, 4, 1, 2 * HD),
])
def test_replay_matches_jax_vjp(sq, sk, causal, h, kv, hd):
    q, k, v, do = _inputs(sq + sk, 2, sq, sk, h, kv, hd)

    @jax.jit
    def forward_and_vjp(a, b, c, d):
        out, vjp = jax.vjp(lambda x, y, z: block_causal_attention(
            x, y, z, causal=causal), a, b, c)
        return out, vjp(d)
    out, want = forward_and_vjp(*(jnp.asarray(x) for x in (q, k, v, do)))
    o, lse, _ = _plain(q, k, v, do, causal)
    got = replay_bwd(q, k, v, o, lse, do, causal)[:3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sq,sk,causal,h,kv", [
    (2 * TILE + 3, 2 * TILE + 3, True, 4, 2),
    (TILE + 1, 3 * TILE - 5, False, 2, 1),
])
def test_replay_rounded_where_the_kernel_rounds_is_within_the_card_bound(
        sq, sk, causal, h, kv):
    q, k, v, do = _inputs(sq * 3 + sk, 1, sq, sk, h, kv, 64)
    o, lse, want = _plain(q, k, v, do, causal)
    got = replay_bwd(q, k, v, o, lse, do, causal, rounded=True)[:3]
    for g, w in zip(got, want):
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        # the roundings show (the bf16 step is 2**-9) and stay inside the
        # bound the card holds the kernel to
        assert 1e-4 < rel <= BWD_REL_TOL


def _schedule_checks(B, sq, sk, h, kv, causal, window=None):
    """Replay the main kernel's index arithmetic: every (program, head,
    query tile) with a turn waits only on programs of smaller id, and
    exactly ``turn`` of them add a part of that query tile before it."""
    n_qt, n_kt = -(-sq // Q_TILE), -(-sk // TILE)
    G = h // kv
    adders = {}                       # (b, head, qt) -> [(tile id, kt)]
    for tile_id in range(B * kv * n_kt):
        b, kvh, kt = tile_of(tile_id, kv, n_kt)
        for j in range(G):
            for qt in query_tiles(kt, n_qt, causal, window=window):
                adders.setdefault((b, kvh * G + j, qt), []).append(
                    (tile_id, kt))
    assert len(adders) == B * h * n_qt       # every query tile gets a part
    waits = 0
    parts_all = sum(len(p) for p in adders.values())
    for (b, head, qt), parts in adders.items():
        for tile_id, kt in parts:
            turn = turn_of(qt, kt, n_kt, causal)
            before = [i for i, j in parts if j > kt]
            assert len(before) == turn
            assert all(i < tile_id for i in before)
            waits += turn > 0
    # one part of each query tile stores and every other one waits
    assert waits == parts_all - B * h * n_qt
    return waits


@pytest.mark.parametrize("shape", [
    *BWD_SHAPES,     # (B, Sq, Sk, H, KV, hd, causal)
    # ragged causal, Sq > Sk, Sq < Sk, MQA, one position
    (2, 333, 333, 4, 2, 64, True),
    (1, 700, 130, 4, 4, 64, True),
    (1, 100, 700, 8, 1, 128, True),
    (3, 257, 129, 8, 1, 64, False),
    (1, 1, 1, 2, 2, 64, True),
])
def test_tile_order_waits_only_on_smaller_ids(shape):
    B, sq, sk, h, kv, _, causal = shape
    waits = _schedule_checks(B, sq, sk, h, kv, causal)
    # several key tiles reach a query tile unless Sk is one tile, or
    # (causal) every query row sits above the second key tile
    assert (waits > 0) == (sk > TILE and (not causal or sq > TILE))


def test_replay_that_skips_the_diagonal_tile_is_caught():
    n = 2 * TILE + 3
    q, k, v, do = _inputs(1, 1, n, n, 4, 2)
    o, lse, want = _plain(q, k, v, do, True)
    _, dk, dv, _, _, in_turn = replay_bwd(q, k, v, o, lse, do, True,
                                          first_shift=1)
    assert not np.allclose(dk, want[1], rtol=TOL, atol=TOL)
    assert not np.allclose(dv, want[2], rtol=TOL, atol=TOL)
    # and dQ's parts no longer arrive in the turns the kernel waits for
    assert not in_turn


def test_chip_smoke_pads_the_planted_fault_to_the_backward_tile():
    import chip_smoke
    assert chip_smoke.BWD_TILE == TILE
    # the all-pairs shape has a ragged key tile, so its fault is real
    assert any(not causal and sk % TILE
               for _, _, sk, *_, causal in BWD_SHAPES)


def _trained_layers():
    """(arch, batch, tokens) of every config that the train and
    train_models phases train with attention layers (rwkv6 has none)."""
    import chip_smoke
    from repro_torch.configs import get_config
    return [(chip_smoke.TRAIN_ARCH, chip_smoke.TRAIN_BATCH,
             chip_smoke.TRAIN_SEQ)] + [
        (arch, b, s) for arch, cut, b, s in chip_smoke.TRAIN_MODELS
        if chip_smoke.attention_layers(
            chip_smoke.train_cut(get_config(arch), cut))]


@pytest.mark.parametrize("arch,b,s", _trained_layers())
def test_chip_smoke_holds_the_backward_at_every_trained_shape(arch, b, s):
    """chip_smoke's bwd phase holds the kernel against its plain version
    at each shape that its train and train_models phases run it at:
    (B, S, S, H, KV, hd, causal[, W]) of every config they train; for a
    config with a context, which trains through make_train_step, at its
    microbatch's rows: the decoder's causal self-attention, whisper's
    encoder over its frames and each cross attention (S x L), all
    pairs."""
    import chip_smoke
    from chip_smoke import BWD_ROWS
    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.launch import steps
    cfg = get_config(arch)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    if not (cfg.is_encdec or "cross" in cfg.slot_kinds()):
        shape = (b, s, s) + heads + (True,)
        if cfg.sliding_window and cfg.sliding_window < s:
            shape += (cfg.sliding_window,)
        assert shape in BWD_ROWS
        return
    cut = next(c for a, c, *_ in chip_smoke.TRAIN_MODELS if a == arch)
    cut = chip_smoke.train_cut(cfg, cut)
    mb = b // steps.pick_microbatches(cut, ShapeCfg("t", s, b, "train"))
    ctx, tokens = steps.context_sizes(cut, s)
    shapes = [(mb, tokens, tokens) + heads + (True,),
              (mb, tokens, ctx) + heads + (False,)]
    if cut.is_encdec:
        shapes.append((mb, ctx, ctx) + heads + (False,))
    assert all(shape in BWD_ROWS for shape in shapes)


# ------------------------------------------------------------ the window

# (Sq, Sk, H, KV, W): W below, on and off both tiles, W = 1, Sq < Sk, and
# Sq > Sk, where rows past Sk + W - 1 see no key and no program reaches
# their query tiles (their dq stays 0, as the plain version's)
WINDOW_CASES = [
    (2 * TILE + 3, 2 * TILE + 3, 4, 2, 40),
    (3 * TILE, 3 * TILE, 2, 2, TILE),
    (2 * TILE + 9, 2 * TILE + 9, 4, 1, Q_TILE + 1),
    (TILE + 5, TILE + 5, 2, 1, 1),
    (TILE + 7, 2 * TILE, 4, 2, 70),
    (3 * TILE, TILE, 2, 2, 30),
]


@pytest.mark.parametrize("sq,sk,h,kv,window", WINDOW_CASES)
def test_windowed_replay_matches_plain_and_jax_vjp(sq, sk, h, kv, window):
    q, k, v, do = _inputs(sq + window, 1, sq, sk, h, kv)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = ref.attention_lse(*t[:3], window=window)
    want = ref.attention_bwd(*t[:3], o, lse, t[3], window=window)
    # rows that see no key have an lse of about -1e30 (the forward's
    # masked scores): exp overflows there before the mask zeroes it, as
    # exp2 does in the kernel
    with np.errstate(over="ignore"):
        dq, dk, dv, visited, order, in_turn = replay_bwd(
            q, k, v, o.numpy(), lse.numpy(), do, True, window=window)
    assert in_turn
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got, w.numpy(), rtol=TOL, atol=TOL)
    pairs = _pairs(sq, sk, True, window)
    assert sorted(set(visited)) == sorted(pairs)
    # the window drops whole tile pairs below it: fewer than unwindowed
    # unless it spans the sequence
    assert len(pairs) < len(_pairs(sq, sk, True)) or window + TILE >= sq
    # every query tile's key tiles: one band that ends at its diagonal,
    # added in descending order
    for (_, _, qt), kts in order.items():
        assert kts == list(range(kts[0], kts[0] - len(kts), -1))
        assert kts[0] == min(-(-sk // TILE) - 1, (qt * Q_TILE + Q_TILE - 1)
                             // TILE)
    if sq <= sk:
        @jax.jit
        def forward_and_vjp(a, b, c, d):
            out, vjp = jax.vjp(lambda x, y, z: block_causal_attention(
                x, y, z, window=window), a, b, c)
            return out, vjp(d)
        _, jgrads = forward_and_vjp(*(jnp.asarray(x) for x in (q, k, v, do)))
        for got, w in zip((dq, dk, dv), jgrads):
            np.testing.assert_allclose(got, np.asarray(w), rtol=TOL, atol=TOL)
    else:
        assert not dq[:, sk + window - 1:].any()


@pytest.mark.parametrize("shape", [
    *(s[:6] + (s[6],) for s in BWD_WINDOW_SHAPES),   # (B, Sq, Sk, H, KV, hd, W)
    (2, 333, 333, 4, 2, 64, 100),
    (1, 700, 700, 4, 4, 64, 1),
    (1, 100, 700, 8, 1, 128, 64),
    (1, 1024, 1024, 8, 8, 64, 129),
])
def test_windowed_tile_order_waits_only_on_smaller_ids(shape):
    B, sq, sk, h, kv, _, window = shape
    _schedule_checks(B, sq, sk, h, kv, True, window)


def _masked(q0, kc0, sq, sk, win):
    """The backward kernel's tile-level mask test for the 64 query rows at
    q0 and one consumer's 64 keys at kc0 (causal; ``win`` INT_MAX for no
    window)."""
    return (q0 < kc0 + 63 or kc0 + 64 > sk
            or min(q0 + Q_TILE, sq) - 1 - kc0 >= win)


@pytest.mark.parametrize("sq,sk,window", [
    (1000, 1000, 300), (700, 700, 129), (1024, 1024, 256), (600, 600, 1),
    (300, 500, 77), (513, 513, 64), (2048, 2048, 2048), (4096, 4096, 1000)])
def test_tiles_that_skip_the_mask_need_none(sq, sk, window):
    """Every (query tile, consumer) the kernel runs without the element
    mask has every pair of its rows below Sq inside Sk, on or below the
    diagonal and inside the window; at W >= Sq the window's test changes
    no tile's path."""
    n_qt, n_kt = -(-sq // Q_TILE), -(-sk // TILE)
    unmasked = 0
    for kt in range(n_kt):
        for qt in query_tiles(kt, n_qt, True, window=window):
            for c in range(TILE // 64):
                q0, kc0 = qt * Q_TILE, kt * TILE + 64 * c
                masked = _masked(q0, kc0, sq, sk, window)
                if window >= sq:
                    assert masked == _masked(q0, kc0, sq, sk, 2**31 - 1)
                if masked:
                    continue
                unmasked += 1
                qr = np.arange(q0, min(q0 + Q_TILE, sq))[:, None]
                kr = np.arange(kc0, kc0 + 64)[None, :]
                assert ((kr < sk) & (qr >= kr) & (qr - kr < window)).all()
    assert unmasked > 0 or window < 2 * Q_TILE
