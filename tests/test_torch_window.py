"""Sliding-window attention of the port against the JAX reference on the
CPU, and the reference's ring-buffer fault, kept by the port for parity.

The plain windowed attention (``kernels.ref.attention(window=)``) is held
against the reference's ``block_causal_attention(window=)`` on the same
numpy inputs: float32 at 2e-5 and bf16 at 2e-2, as
``tests/test_torch_attention.py`` holds the unwindowed one. A window that
never binds must leave the result unchanged bit for bit. Its gradient
(``ops.attention(window=)`` under autograd: the plain forward and the
plain backward, ``ref.attention_bwd(window=)``) is held against
``jax.vjp`` of the reference's windowed attention in float32 at
``GRAD_TOL`` = 1e-5, the plain backward's tolerance against ``jax.vjp``
in ``tests/test_torch_train_kernels.py`` (the same math, sums in another
order: 1.9e-6 the largest gap read here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import layers as r_layers
from repro.models import lm as r_lm
from repro_torch.configs import get_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM
from test_torch_attention import BF16_TOL, F32_TOL, _both, _close, _normal
from test_torch_serve import DECODE_TOL

#: decode-vs-forward gap (float32) the ring fault must exceed, and the one
#: a correct ring stays under (2.4e-6 measured at S = 16)
FAULT_GAP, CLEAN_GAP = 1e-2, 1e-4
#: float32 gradients of windowed attention against jax.vjp
GRAD_TOL = 1e-5


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("S,Sk,H,KV,block,window", [
    (48, 48, 4, 2, 16, 20),      # W off the block
    (64, 64, 4, 1, 16, 1),       # W = 1: each query sees itself only
    (32, 32, 2, 2, 8, 40),       # W >= S: the window never binds
    (96, 96, 4, 4, 32, 48),      # W a multiple of the block: pairs skipped
    (40, 56, 4, 2, 8, 12),       # Sk > S (top-left causal), GQA
    (64, 64, 4, 2, 64, 17),      # one block pair, masked inside
    (60, 60, 2, 1, 7, 9),        # ragged: blocks of 6 (the largest divisor)
])
def test_plain_windowed_attention_matches_the_reference(S, Sk, H, KV, block,
                                                        window, bf16):
    rng = np.random.default_rng([S, Sk, H, KV, block, window])
    q, k, v = (_normal(rng, (2, n, h, 16))
               for n, h in ((S, H), (Sk, KV), (Sk, KV)))
    jq, tq = _both(q, bf16)
    jk, tk = _both(k, bf16)
    jv, tv = _both(v, bf16)
    want = r_layers.block_causal_attention(jq, jk, jv, window=window,
                                           block=block)
    got = ref.attention(tq, tk, tv, window=window, block=block)
    assert got.dtype == tq.dtype
    _close(want, got, BF16_TOL if bf16 else F32_TOL)
    if window < S:   # the window binds: not the unwindowed result
        assert not torch.equal(got, ref.attention(tq, tk, tv, block=block))


@pytest.mark.parametrize("S,block", [(64, 16), (50, 64), (33, 11)])
def test_a_window_that_never_binds_changes_no_bit(S, block):
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(_normal(rng, (1, S, 2, 16))).bfloat16()
               for _ in range(3))
    plain, plain_lse = ref.attention_lse(q, k, v, block=block)
    for window in (S, S + 1, 2**40):
        out, lse = ref.attention_lse(q, k, v, block=block, window=window)
        assert torch.equal(out, plain) and torch.equal(lse, plain_lse)
    # all pairs: the window is ignored, as in the reference
    assert torch.equal(ref.attention(q, k, v, causal=False, window=3),
                       ref.attention(q, k, v, causal=False))


def test_windowed_layers_run_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_normal(rng, (2, 48, 4, 16)))
               for _ in range(3))
    before = dict(build.LAUNCHES)
    got = layers.block_causal_attention(q, k, v, window=20, block=16)
    assert build.LAUNCHES == before
    assert torch.equal(got, ref.attention(q, k, v, window=20, block=16))
    assert torch.equal(got, ops.attention(q, k, v, window=20, block_q=16))
    o, lse = flash_attention(q, k, v, block=16, window=20, return_lse=True)
    assert torch.equal(o, got)
    assert torch.equal(lse, ref.attention_lse(q, k, v, block=16,
                                              window=20)[1])


# (S, H, KV, block, window): W below, on and off the block, W >= S (never
# binds), W = 1, GQA and MQA
@pytest.mark.parametrize("S,H,KV,block,window", [
    (48, 4, 2, 16, 5),          # W below the block
    (64, 4, 2, 16, 16),         # W on the block
    (48, 4, 4, 16, 20),         # W off the block
    (96, 4, 2, 32, 64),         # W two blocks: whole pairs skipped
    (32, 4, 2, 8, 40),          # W >= S: the window never binds
    (40, 2, 2, 8, 1),           # W = 1: each query sees itself only
    (64, 4, 1, 16, 24),         # MQA
    (60, 6, 2, 12, 9),          # GQA 3:1, ragged
])
def test_windowed_attention_gradients_match_jax_vjp(S, H, KV, block, window):
    rng = np.random.default_rng([S, H, KV, block, window])
    q = _normal(rng, (2, S, H, 16))
    k, v = _normal(rng, (2, S, KV, 16)), _normal(rng, (2, S, KV, 16))
    do = _normal(rng, (2, S, H, 16))
    out, vjp = jax.vjp(lambda a, b, c: r_layers.block_causal_attention(
        a, b, c, window=window, block=block),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(build.LAUNCHES)
    got = ops.attention(tq, tk, tv, window=window, block_q=block)
    assert type(got.grad_fn).__name__.startswith("FlashAttention")
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    assert build.LAUNCHES == before      # the CPU runs the plain versions
    _close(out, got.detach(), F32_TOL)
    for g, w in zip(grads, want):
        _close(w, g, GRAD_TOL)
    if window < S:          # the window binds: not the unwindowed gradient
        plain = torch.autograd.grad(ops.attention(tq, tk, tv, block_q=block),
                                    (tq, tk, tv), torch.from_numpy(do))
        assert not torch.allclose(grads[1], plain[1], atol=GRAD_TOL)


def test_windowed_backward_equals_autograd_of_the_plain_forward():
    """ref.attention_bwd(window=) against torch's own autograd of the plain
    windowed forward (float32, GRAD_TOL), and the wrapper's CPU path: the
    plain backward cast to the inputs' dtypes."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 50, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 50, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 50, 2, 16, generator=g, requires_grad=True)
    do = torch.randn(2, 50, 4, 16, generator=g)
    want = torch.autograd.grad(ref.attention(q, k, v, window=11, block=10),
                               (q, k, v), do)
    o, lse = ref.attention_lse(q.detach(), k.detach(), v.detach(),
                               window=11, block=10)
    got = ref.attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, do,
                            window=11)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
    qb, kb, vb, ob, dob = (x.detach().bfloat16() for x in (q, k, v, o, do))
    for a, b in zip(flash_attention_bwd(qb, kb, vb, ob, lse, dob, window=11),
                    ref.attention_bwd(qb, kb, vb, ob, lse, dob, window=11)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.bfloat16())
    # no causal mask: the window is ignored, as in the forward
    for a, b in zip(ref.attention_bwd(q.detach(), k.detach(), v.detach(), o,
                                      lse, do, causal=False, window=11),
                    ref.attention_bwd(q.detach(), k.detach(), v.detach(), o,
                                      lse, do, causal=False)):
        assert torch.equal(a, b)


def test_backward_rows_that_see_no_key_get_no_gradient():
    """Sq > Sk + W - 1 (top-left causal): rows from Sk + W - 1 on see no
    key, so their dq is 0 and they add nothing to dk or dv."""
    g = torch.Generator().manual_seed(4)
    q, do = (torch.randn(1, 40, 2, 16, generator=g) for _ in range(2))
    k, v = (torch.randn(1, 20, 2, 16, generator=g) for _ in range(2))
    o, lse = ref.attention_lse(q, k, v, window=6, block=20)
    dq, dk, dv = ref.attention_bwd(q, k, v, o, lse, do, window=6)
    assert torch.isfinite(dq).all() and not dq[:, 25:].any()
    assert dq[:, :25].abs().amax(dim=(0, 2, 3)).min() > 0
    dq2, dk2, dv2 = ref.attention_bwd(q[:, :25], k, v, o[:, :25],
                                      lse[:, :, :25], do[:, :25], window=6)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("window", [0, -3])
def test_the_backward_refuses_a_window_below_one(window):
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        flash_attention_bwd(x, x, x, x, torch.zeros((1, 2, 8)), x,
                            window=window)


@pytest.mark.parametrize("window", [0, -4])
def test_a_window_below_one_is_refused(window):
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        flash_attention(x, x, x, window=window)


def _mixtral_pair():
    rcfg = dataclasses.replace(r_get_config("mixtral-8x7b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                               dtype="float32")
    tree = jax.tree.map(np.asarray,
                        r_lm.init_params(rcfg, jax.random.PRNGKey(0)))
    model = LM(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(tcfg, tree))
    return rcfg, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("S", [16, 24, 32, 40])
def test_ring_buffer_fault_is_reproduced_by_both_packages(S):
    """Reference fault kept for parity (ROADMAP Queue 3): after a prefill
    of S > W positions the last W sit in ring slots 0..W-1, and decode
    writes position S at slot S % W. When S % W != 0 that write evicts an
    in-window position and leaves the stale S - W in place, so the decode
    logits leave the full forward's; when S % W == 0 they agree."""
    rcfg, params, model = _mixtral_pair()
    W = rcfg.sliding_window
    assert W == 16
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, (1, S + 1))
    full, _, _ = r_lm.forward(rcfg, params, jnp.asarray(toks), attn_block=8)
    full = np.asarray(full[0, S])
    _, r_cache = r_lm.prefill(rcfg, params, jnp.asarray(toks[:, :S]),
                              seq_cap=S + 8, attn_block=8)
    want, _ = r_lm.decode_step(rcfg, params, jnp.asarray(toks[:, S:]),
                               r_cache)
    _, cache = model.prefill(torch.from_numpy(toks[:, :S]), seq_cap=S + 8,
                             attn_block=8)
    got, _ = model.decode_step(torch.from_numpy(toks[:, S:]), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    gap = float(np.abs(got[0].numpy() - full).max())
    r_gap = float(np.abs(np.asarray(want[0]) - full).max())
    if S % W:
        assert gap > FAULT_GAP and r_gap > FAULT_GAP
    else:
        assert gap < CLEAN_GAP and r_gap < CLEAN_GAP
