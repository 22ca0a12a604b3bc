"""The port's attention and layer functions against the JAX reference.

Same numpy inputs (seeded) through ``repro`` and ``repro_torch`` on the
CPU. Float32 comparisons hold the algorithm at 2e-5 (sums run in another
order); bf16 ones at 2e-2 (each framework rounds at its own places). The
Pallas flash kernel runs in interpret mode, as the reference's own tests
run it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as r_layers
from repro_torch.kernels import build, ops, ref
from repro_torch.models import layers

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _both(a, bf16=False):
    """numpy f32 -> (jax array, torch tensor), optionally both in bf16."""
    j, t = jnp.asarray(a), torch.from_numpy(a)
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.bfloat16()
    return j, t


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk,hd,causal", [(64, 64, 16, True),
                                             (64, 80, 16, False),
                                             (128, 128, 64, True),
                                             (96, 100, 64, False),
                                             (32, 128, 64, True)])
def test_plain_attention_matches_the_pallas_kernel(sq, sk, hd, causal):
    rng = np.random.default_rng([sq, sk, hd, causal])
    q, k, v = (_normal(rng, (3, n, hd)) for n in (sq, sk, sk))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, block_q=32,
                                  block_k=32, interpret=True)
    # (BH, S, hd) -> the port's (B, S, H, hd) with one head per row
    got = ref.attention(*(torch.from_numpy(x)[:, :, None] for x in (q, k, v)),
                        causal=causal, block=32)[:, :, 0]
    _close(want, got, F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_the_gqa_dispatcher(causal):
    rng = np.random.default_rng(7)
    B, S, H, KV, hd = 2, 64, 4, 2, 16
    q = _normal(rng, (B, S, H, hd))
    k, v = _normal(rng, (B, S, KV, hd)), _normal(rng, (B, S, KV, hd))
    want = r_ops.attention(*(jnp.asarray(x) for x in (q, k, v)),
                           causal=causal, impl="pallas", block_q=32,
                           block_k=32, interpret=True)
    got = ref.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=causal, block=32)
    _close(want, got, F32_TOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("S,Sk,H,KV,block,causal", [
    (64, 64, 4, 2, 16, True), (48, 48, 4, 4, 32, True),
    (32, 40, 4, 1, 16, False), (96, 96, 2, 2, 1024, True)])
def test_block_causal_attention_matches_the_reference(S, Sk, H, KV, block,
                                                      causal, bf16):
    rng = np.random.default_rng([S, Sk, H, KV, block, causal])
    q, k, v = (_normal(rng, (2, n, h, 16))
               for n, h in ((S, H), (Sk, KV), (Sk, KV)))
    jq, tq = _both(q, bf16)
    jk, tk = _both(k, bf16)
    jv, tv = _both(v, bf16)
    want = r_layers.block_causal_attention(jq, jk, jv, block=block,
                                           causal=causal)
    before = dict(build.LAUNCHES)
    got = layers.block_causal_attention(tq, tk, tv, block=block,
                                        causal=causal)
    assert build.LAUNCHES == before        # the CPU runs the plain version
    assert got.dtype == tq.dtype
    assert torch.equal(got, ref.attention(tq, tk, tv, causal=causal,
                                          block=block))
    assert torch.equal(got, ops.attention(tq, tk, tv, causal=causal,
                                          block_q=block))
    _close(want, got, BF16_TOL if bf16 else F32_TOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_rms_norm_rope_and_mlp_match_the_reference(bf16):
    rng = np.random.default_rng(11)
    tol = BF16_TOL if bf16 else F32_TOL
    jx, tx = _both(_normal(rng, (2, 12, 64)) * 3, bf16)
    js, ts = _both(1 + 0.1 * _normal(rng, (64,)), bf16)
    _close(r_layers.rms_norm(jx, js), layers.rms_norm(tx, ts), tol)

    jh, th = _both(_normal(rng, (2, 12, 4, 16)), bf16)
    pos = rng.integers(0, 200, (2, 12)).astype(np.int32)
    for theta in (10_000.0, 1e6):
        _close(r_layers.rope(jh, jnp.asarray(pos), theta),
               layers.rope(th, torch.from_numpy(pos), theta), tol)

    jx, tx = _both(_normal(rng, (2, 12, 64)), bf16)
    w = {n: _both(_normal(rng, s) / 16, bf16) for n, s in
         (("w1", (64, 96)), ("w3", (64, 96)), ("w2", (96, 64)))}
    _close(r_layers.gated_mlp({n: a for n, (a, _) in w.items()}, jx),
           layers.gated_mlp({n: b for n, (_, b) in w.items()}, tx), tol)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cache_len,window", [(5, None), (12, None),
                                              (17, 12)])
def test_decode_attention_matches_the_reference(cache_len, window, bf16):
    rng = np.random.default_rng([cache_len, bf16])
    jq, tq = _both(_normal(rng, (2, 1, 4, 16)), bf16)
    jk, tk = _both(_normal(rng, (2, 12, 2, 16)), bf16)
    jv, tv = _both(_normal(rng, (2, 12, 2, 16)), bf16)
    want = r_layers.decode_attention(jq, jk, jv, jnp.int32(cache_len),
                                     window=window)
    got = layers.decode_attention(tq, tk, tv, cache_len, window=window)
    assert got.shape == (2, 1, 4, 16) and got.dtype == tq.dtype
    _close(want, got, BF16_TOL if bf16 else F32_TOL)
