"""Attention's backward on the CPU: the plain versions against JAX's
automatic differentiation of the reference's attention, the autograd
function of the port, and a numpy replay of the backward kernel's tiling.

The kernel itself runs only on the card (``test_torch_card.py``). Its
arithmetic is held here through the plain version it is compared with
there, and its schedule through the replay: key tiles for dK/dV (the
group's query heads summed in one program), query tiles for dQ, and the
tiles above the diagonal skipped, at the tile seams.

Tolerances: float32 throughout. The plain versions against ``jax.vjp``
at rtol = atol = 1e-5 (the same math, sums in another order: the largest
gap measured is 1.7e-6); the replay against the plain version at 1e-5
(another blocking of the same sums); ``FlashAttention`` on the CPU
against torch's autograd of ``ref.attention`` at 1e-5.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import block_causal_attention
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

TOL = 1e-5
HD = 16
#: rows per query tile and per key tile of csrc/flash_attention_bwd.cu
TILE = int(re.search(r"constexpr int kT = (\d+);",
                     (build.CSRC / "flash_attention_bwd.cu").read_text())
           .group(1))


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


def replay_bwd(q, k, v, o, lse, do, causal, tile=TILE, first_shift=0):
    """The backward kernel's schedule in numpy (float32): attn_bwd_dot,
    then one program per (batch, KV head, key tile) that sums its keys'
    dK and dV over the group's query heads and the query tiles from the
    diagonal on, then one per (batch, head, query tile) over the key
    tiles up to the diagonal. ``first_shift`` moves the first query tile
    of the dK/dV programs (a planted fault). Returns (dq, dk, dv, the
    (query tile, key tile) pairs each pass visited)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = np.float32(1.0 / math.sqrt(hd))
    f32 = np.float32
    dsum = (do * o).sum(-1)                                  # (B, Sq, H)
    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)

    def rows(x, b, r0, n, head):
        out = np.zeros((tile, x.shape[3]), f32)
        out[:max(0, min(tile, n - r0))] = x[b, r0:r0 + tile, head]
        return out

    def keep(q0, k0):
        qr = q0 + np.arange(tile)[:, None]
        kr = k0 + np.arange(tile)[None, :]
        m = (qr < Sq) & (kr < Sk)
        return m & (qr >= kr) if causal else m

    visited_kv, visited_q = [], []
    for b in range(B):
        for kvh in range(KV):
            for k0 in range(0, Sk, tile):
                kt, vt = rows(k, b, k0, Sk, kvh), rows(v, b, k0, Sk, kvh)
                dk_acc = np.zeros((tile, hd), f32)
                dv_acc = np.zeros((tile, hd), f32)
                first = (k0 // tile + first_shift) * tile if causal else 0
                for j in range(G):
                    h = kvh * G + j
                    for q0 in range(first, Sq, tile):
                        visited_kv.append((q0 // tile, k0 // tile))
                        qs, dos = rows(q, b, q0, Sq, h), rows(do, b, q0, Sq, h)
                        lse_t = np.zeros(tile, f32)
                        d_t = np.zeros(tile, f32)
                        n = max(0, min(tile, Sq - q0))
                        lse_t[:n] = lse[b, h, q0:q0 + n]
                        d_t[:n] = dsum[b, q0:q0 + n, h]
                        pt = np.where(keep(q0, k0).T,
                                      np.exp(kt @ qs.T * scale - lse_t), 0)
                        dv_acc += pt @ dos
                        dst = pt * (vt @ dos.T - d_t)
                        dk_acc += dst @ qs
                n = min(tile, Sk - k0)
                dk[b, k0:k0 + n, kvh] = (dk_acc * scale)[:n]
                dv[b, k0:k0 + n, kvh] = dv_acc[:n]
        for h in range(H):
            kvh = h // G
            for q0 in range(0, Sq, tile):
                qs, dos = rows(q, b, q0, Sq, h), rows(do, b, q0, Sq, h)
                n = min(tile, Sq - q0)
                lse_t = np.zeros(tile, f32)
                d_t = np.zeros(tile, f32)
                lse_t[:n] = lse[b, h, q0:q0 + n]
                d_t[:n] = dsum[b, q0:q0 + n, h]
                k_end = min(Sk, q0 + tile) if causal else Sk
                dq_acc = np.zeros((tile, hd), f32)
                for k0 in range(0, k_end, tile):
                    visited_q.append((q0 // tile, k0 // tile))
                    kt, vt = rows(k, b, k0, Sk, kvh), rows(v, b, k0, Sk, kvh)
                    p = np.where(keep(q0, k0),
                                 np.exp(qs @ kt.T * scale - lse_t[:, None]), 0)
                    ds = p * (dos @ vt.T - d_t[:, None])
                    dq_acc += ds @ kt
                dq[b, q0:q0 + n, h] = (dq_acc * scale)[:n]
    return dq, dk, dv, visited_kv, visited_q


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 2 * TILE + 3])
@pytest.mark.parametrize("causal,h,kv", [(True, 4, 2), (True, 2, 2),
                                         (False, 4, 1)])
def test_replay_of_the_kernel_tiling_matches_plain(n, causal, h, kv):
    sk = n if causal else n + 5
    q, k, v, do = _inputs(n + h, 1, n, sk, h, kv)
    o, lse, want = _plain(q, k, v, do, causal)
    dq, dk, dv, vis_kv, vis_q = replay_bwd(q, k, v, o, lse, do, causal)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL)
    tiles_q, tiles_k = -(-n // TILE), -(-sk // TILE)
    pairs = ([(i, j) for i in range(tiles_q) for j in range(i + 1)]
             if causal else
             [(i, j) for i in range(tiles_q) for j in range(tiles_k)])
    # each program visits only the pairs at or below the diagonal, once
    # per query head of the group (dK/dV) or per head (dQ)
    assert sorted(set(vis_kv)) == sorted(pairs)
    assert len(vis_kv) == len(pairs) * h
    assert sorted(set(vis_q)) == sorted(pairs)
    assert len(vis_q) == len(pairs) * h


def test_replay_that_skips_the_diagonal_tile_is_caught():
    n = 2 * TILE + 3
    q, k, v, do = _inputs(1, 1, n, n, 4, 2)
    o, lse, want = _plain(q, k, v, do, True)
    _, dk, dv, _, _ = replay_bwd(q, k, v, o, lse, do, True, first_shift=1)
    assert not np.allclose(dk, want[1], rtol=TOL, atol=TOL)
    assert not np.allclose(dv, want[2], rtol=TOL, atol=TOL)


def test_chip_smoke_pads_the_planted_fault_to_the_backward_tile():
    import chip_smoke
    assert chip_smoke.BWD_TILE == TILE
    # the all-pairs shape has a ragged key tile, so its fault is real
    assert any(not causal and sk % TILE
               for _, _, sk, *_, causal in chip_smoke.BWD_SHAPES)
