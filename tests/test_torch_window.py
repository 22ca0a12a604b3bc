"""Sliding-window attention of the port against the JAX reference on the
CPU, and the reference's ring-buffer fault, kept by the port for parity.

The plain windowed attention (``kernels.ref.attention(window=)``) is held
against the reference's ``block_causal_attention(window=)`` on the same
numpy inputs: float32 at 2e-5 and bf16 at 2e-2, as
``tests/test_torch_attention.py`` holds the unwindowed one. A window that
never binds must leave the result unchanged bit for bit.
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
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM
from test_torch_attention import BF16_TOL, F32_TOL, _both, _close, _normal
from test_torch_serve import DECODE_TOL

#: decode-vs-forward gap (float32) the ring fault must exceed, and the one
#: a correct ring stays under (2.4e-6 measured at S = 16)
FAULT_GAP, CLEAN_GAP = 1e-2, 1e-4


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


def test_a_window_under_autograd_raises():
    """The backward kernel has no window yet: no gradient path runs."""
    q, k, v = (torch.zeros((1, 32, 2, 16), requires_grad=True)
               for _ in range(3))
    with pytest.raises(NotImplementedError):
        ops.attention(q, k, v, window=8)
    with torch.no_grad():      # the forward alone serves
        assert ops.attention(q, k, v, window=8).shape == q.shape


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
