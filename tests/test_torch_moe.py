"""The port's MoE FFN, its other decoder configs and their serving path
against the JAX reference on the CPU.

Inputs come from numpy generators and reach both packages as the same
arrays; the reference's weights reach the port through
``models.convert.params_from_numpy``. Routing is held exactly in float32:
each token's experts, its slot in each expert and which choices are
dropped at capacity are equal, so the reference's dispatch tensor (read
from its own einsum) is equal to the one rebuilt from the port's route,
and so is the combine tensor's support. The combine's gate values are
held at ``GATE_TOL``: the router's float32 product and ``exp`` round their
last bit differently in XLA and in PyTorch. Outputs and the aux loss are
held at ``MOE_TOL`` (float32 sums in another order), whole models at the
serving tests' ``PREFILL_TOL`` / ``DECODE_TOL``.
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
from repro_torch.models import layers
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        stacked_ndim)
from repro_torch.models.lm import LM, loss_fn
from test_torch_serve import DECODE_TOL, PREFILL_TOL

#: float32 MoE outputs and aux: the same products summed in another order
MOE_TOL = 1e-5
#: float32 gates: router logits and their exp differ in the last bit
#: between the packages (at most 3e-7 on these inputs)
GATE_TOL = 1e-6
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "mixtral-8x7b")
#: every config of the slice beside qwen1.5-0.5b (tests/test_torch_serve.py)
ARCHS = MOE_ARCHS + ("deepseek-7b", "internlm2-1.8b", "granite-20b")


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _moe_inputs(seed, B, S, d, E, f):
    rng = np.random.default_rng(seed)
    params = {"router": rng.standard_normal((d, E)) * 0.5,
              "w1": rng.standard_normal((E, d, f)) / np.sqrt(d),
              "w3": rng.standard_normal((E, d, f)) / np.sqrt(d),
              "w2": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    return params, x


class _EinsumSpy:
    """Stands in for ``jax.numpy`` inside ``repro.models.layers`` and keeps
    the operands of the MoE's dispatch and combine einsums."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        self.seen.setdefault(spec, []).append(ops)
        return jnp.einsum(spec, *ops, **kw)


def _dense_masks(route, E, C):
    """(dispatch (B,sc,E,C) bool, combine (B,sc,E,C) float32) of a port
    ``Route``: the reference's one-hot tensors."""
    B, sc, k = route.expert.shape
    disp = np.zeros((B, sc, E, C), bool)
    comb = np.zeros((B, sc, E, C), np.float32)
    for b, s, j in np.ndindex(B, sc, k):
        if route.keep[b, s, j]:
            e, c = int(route.expert[b, s, j]), int(route.slot[b, s, j])
            disp[b, s, e, c] = True
            comb[b, s, e, c] += float(route.gate[b, s, j])
    return disp, comb


# (B, S, E, top_k, capacity_factor): phi3.5's and mixtral's routing at the
# reduced width, a tight capacity that drops, and top-1
@pytest.mark.parametrize("B,S,E,k,cf", [(2, 24, 4, 2, 1.25),
                                        (1, 40, 8, 2, 1.25),
                                        (2, 32, 4, 2, 0.5),
                                        (3, 16, 16, 1, 1.0)])
def test_moe_routing_is_exact_in_float32(monkeypatch, B, S, E, k, cf):
    params, x = _moe_inputs([B, S, E, k], B, S, 64, E, 32)
    spy = _EinsumSpy()
    monkeypatch.setattr(r_layers, "jnp", spy)
    want, want_aux = r_layers.moe_ffn(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x),
        n_experts=E, top_k=k, capacity_factor=cf)
    monkeypatch.undo()
    (r_disp, _), = spy.seen["bsec,bsd->becd"]
    (r_comb, _), = spy.seen["bsec,becd->bsd"]

    C = layers.moe_capacity(S, E, k, cf)
    assert r_disp.shape == (B, S, E, C)
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    route = layers.moe_route(tp["router"], torch.from_numpy(x), top_k=k,
                             capacity=C)
    disp, comb = _dense_masks(route, E, C)
    np.testing.assert_array_equal(disp, np.asarray(r_disp).astype(bool))
    r_comb = np.asarray(r_comb)
    np.testing.assert_array_equal(comb != 0, r_comb != 0)
    np.testing.assert_allclose(comb, r_comb, rtol=GATE_TOL, atol=GATE_TOL)
    if cf < 1.0:
        assert not route.keep.all()           # the case drops at capacity
    got, aux = layers.moe_ffn(tp, torch.from_numpy(x), n_experts=E,
                              top_k=k, capacity_factor=cf)
    _close(got, want, MOE_TOL)
    _close(aux, want_aux, MOE_TOL)


@pytest.mark.parametrize("S,seq_chunk", [(64, 32), (48, 16), (30, 8)])
def test_moe_ffn_in_chunks_matches_the_reference(S, seq_chunk):
    """S > seq_chunk: the sequence runs in chunks (30 at 8 takes the
    largest divisor, 6), each with its own capacity, and aux is their
    mean."""
    params, x = _moe_inputs(S, 2, S, 64, 8, 32)
    kw = dict(n_experts=8, top_k=2, capacity_factor=1.25,
              seq_chunk=seq_chunk)
    want, want_aux = r_layers.moe_ffn(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x), **kw)
    got, aux = layers.moe_ffn({n: torch.from_numpy(a)
                               for n, a in params.items()},
                              torch.from_numpy(x), **kw)
    _close(got, want, MOE_TOL)
    _close(aux, want_aux, MOE_TOL)


def test_moe_ffn_in_bf16_matches_the_reference():
    params, x = _moe_inputs(7, 2, 32, 64, 4, 32)
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.25)
    want, want_aux = r_layers.moe_ffn(
        {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in params.items()},
        jnp.asarray(x).astype(jnp.bfloat16), **kw)
    got, aux = layers.moe_ffn({n: torch.from_numpy(a).bfloat16()
                               for n, a in params.items()},
                              torch.from_numpy(x).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close(got, want, 3e-2)
    _close(aux, want_aux, 1e-2)


def _pair(arch, dtype="float32", seed=0):
    rcfg = dataclasses.replace(r_get_config(arch).reduced(), dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        r_lm.init_params(rcfg, jax.random.PRNGKey(seed)))
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(tcfg, tree))
    return rcfg, jax.tree.map(jnp.asarray, tree), model


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_the_reference_f32(arch):
    rcfg, params, model = _pair(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, rcfg.vocab, (2, 48))
    targets = rng.integers(-1, rcfg.vocab, (2, 48))
    want, want_aux, _ = r_lm.forward(rcfg, params, jnp.asarray(toks),
                                     attn_block=16)
    got, aux = model(torch.from_numpy(toks), attn_block=16, return_aux=True)
    _close(got, want, PREFILL_TOL)
    _close(aux, want_aux, MOE_TOL)
    assert (float(aux) > 0) == bool(rcfg.moe)
    batch = {"tokens": toks, "targets": targets}
    want = r_lm.loss_fn(rcfg, params, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                        attn_block=16)
    got = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                  attn_block=16)
    _close(got, want, PREFILL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference_f32(arch):
    """Prefill of 32 positions (twice mixtral's reduced window of 16, so
    its ring holds the last 16) into a cache of 48, then three decode
    steps, each against the reference's logits and cache."""
    rcfg, params, model = _pair(arch)
    toks = np.random.default_rng(12).integers(0, rcfg.vocab, (2, 35))
    want, r_cache = r_lm.prefill(rcfg, params, jnp.asarray(toks[:, :32]),
                                 seq_cap=48, attn_block=16)
    got, cache = model.prefill(torch.from_numpy(toks[:, :32]), seq_cap=48,
                               attn_block=16)
    _close(got, want, PREFILL_TOL)
    cap = 16 if rcfg.sliding_window else 48
    assert cache["slot0"]["k"].shape == r_cache["slot0"]["k"].shape
    assert cache["slot0"]["k"].shape[2] == cap
    for name in ("k", "v"):
        _close(cache["slot0"][name], r_cache["slot0"][name], PREFILL_TOL)
    for i in range(32, 35):
        nxt = toks[:, i:i + 1]
        want, r_cache = r_lm.decode_step(rcfg, params, jnp.asarray(nxt),
                                         r_cache)
        got, cache = model.decode_step(torch.from_numpy(nxt), cache)
        _close(got, want, DECODE_TOL)
        assert cache["len"] == int(r_cache["len"]) == i + 1
        for name in ("k", "v"):
            _close(cache["slot0"][name], r_cache["slot0"][name], DECODE_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_weights_carry_bit_for_bit_both_ways(arch):
    rcfg = r_get_config(arch).reduced()
    tree = jax.tree.map(np.asarray,
                        r_lm.init_params(rcfg, jax.random.PRNGKey(3)))
    tcfg = get_config(arch).reduced()
    sd = params_from_numpy(tcfg, tree)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(sd)                 # every leaf has its home
    assert set(model.state_dict()) == set(sd)
    E, d, f = tcfg.moe.n_experts, tcfg.d_model, tcfg.d_ff
    assert sd["layers.0.router"].shape == (d, E)
    assert sd["layers.1.moe_w2"].shape == (E, f, d)
    back = params_to_numpy(tcfg, model.state_dict())
    slot = tree["blocks"]["slot0"]
    assert set(back["blocks"]["slot0"]) == set(slot) >= {
        "router", "moe_w1", "moe_w3", "moe_w2"}
    for name, leaf in slot.items():
        np.testing.assert_array_equal(back["blocks"]["slot0"][name],
                                      leaf.view(np.uint16))
        # the reference's ndim rules (weight decay) see the stacked leaf
        assert stacked_ndim(name, sd[f"layers.0.{name}"]) == leaf.ndim


@pytest.mark.parametrize("arch", ARCHS + ("qwen1.5-0.5b",))
def test_chip_smoke_param_count_is_the_models(arch):
    """chip_smoke's serve_models checks each model's parameter count
    against ``param_count``, worked out from the config's fields."""
    from chip_smoke import param_count
    cfg = get_config(arch).reduced()
    model = LM(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == param_count(cfg)


def test_server_takes_a_config_or_a_name():
    from repro_torch.launch.serve import Server
    cut = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              n_layers=1)
    srv = Server(cut, reduced=False, device="cpu")
    assert srv.cfg == cut and len(srv.model.layers) == 1
    by_name = Server("mixtral-8x7b", device="cpu")
    assert by_name.cfg == get_config("mixtral-8x7b").reduced()
    assert Server(get_config("mixtral-8x7b"), device="cpu").cfg == by_name.cfg


def test_serve_batch_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_batch
    done = serve_batch.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 10 requests / 240 tokens in ")
    assert len(out) == 4 and out[1].startswith("  req 0: prompt[")
    assert all(len(r.out) == 24 for r in done)
    # some prompts pad past the reduced window of 16: the ring is used
    assert max(len(r.prompt) for r in done) > 16


def test_capacity_routing_lets_a_later_token_change_an_earlier_output():
    """Reference fault kept for parity (ROADMAP Queue 3): the j-major
    slot order queues every token's first choice before any second
    choice, so a later token's first choice can push an earlier token's
    second choice past capacity. Changing only the last token then
    changes earlier positions' outputs, in both packages alike."""
    rng = np.random.default_rng(0)
    d, E, f, S = 16, 4, 8, 8
    params = {"router": rng.standard_normal((d, E)),
              "w1": rng.standard_normal((E, d, f)),
              "w3": rng.standard_normal((E, d, f)),
              "w2": rng.standard_normal((E, f, d))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((1, S, d)).astype(np.float32)
    x2 = x.copy()
    x2[0, -1] = rng.standard_normal(d)
    kw = dict(n_experts=E, top_k=2, capacity_factor=1.0)
    outs = []
    for a in (x, x2):
        want, _ = r_layers.moe_ffn({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   jnp.asarray(a), **kw)
        got, _ = layers.moe_ffn({k: torch.from_numpy(v)
                                 for k, v in params.items()},
                                torch.from_numpy(a), **kw)
        _close(got, want, MOE_TOL)
        outs.append(got[0, :-1])
    moved = (outs[0] - outs[1]).abs().amax(-1)
    assert (moved[:5] == 0).all() and (moved[5:] > 0.5).all()


def _wide_moe(arch, n_layers):
    """A few float32 layers of ``arch`` with head dim 128 at a width the
    CPU runs (mixtral's window cut to 32), random weights from seed 0."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, d_model=256, n_heads=2, n_kv_heads=1,
                              head_dim=128, d_ff=64, vocab=512,
                              n_layers=n_layers, dtype="float32",
                              sliding_window=cfg.sliding_window and 32)
    return LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def test_fixed_routes_replay_the_prefill_routes_exactly():
    """While routes are replayed, the shorter prefill and each decode step
    get the whole prefill's expert, keep and gate at their positions,
    layer by layer."""
    from repro_torch.models import routes as hooks
    model = _wide_moe("phi3.5-moe-42b-a6.6b", 3)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        2, 512, 80))[None]
    whole, served = [], []
    with hooks.calls(whole):
        model.prefill(prompt, seq_cap=80)
    routes = [(r.expert, r.keep, r.gate) for r in whole]
    with hooks.served(routes, 3, 72), hooks.calls(served):
        _, cache = model.prefill(prompt[:, :72], seq_cap=81)
        for i in range(72, 80):
            _, cache = model.decode_step(prompt[:, i:i + 1], cache)
    assert len(served) == 3 + 8 * 3
    for call, r in enumerate(served):
        layer = call % 3
        pos = slice(0, 72) if call < 3 else slice(72 + (call - 3) // 3,
                                                  73 + (call - 3) // 3)
        for got, want in zip((r.expert, r.keep, r.gate), routes[layer]):
            assert torch.equal(got, want[:, pos])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_fixed_routes_hold_moe_consistency_and_keep_the_faults(arch):
    """The replay brings the gap of an MoE model (its own routing is
    recorded beside it) down to float32 rounding, and a decode one
    position ahead or behind still moves it past chip_smoke's limit."""
    from chip_smoke import SERVE_REL_TOL
    from repro_torch.benchmarks.serve_consistency import (
        FAULTS, prefill_decode_logits, rel_gap)
    model = _wide_moe(arch, 4)
    W = model.cfg.sliding_window
    n = (2 * W if W else 96) + 16        # mixtral: the window binds
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        2, 512, n))[None]
    clean = rel_gap(*prefill_decode_logits(model, prompt, 16,
                                           fixed_routes=True))
    assert clean < 1e-4
    for name in ("ahead", "behind"):
        assert rel_gap(*prefill_decode_logits(
            model, prompt, 16, plant=FAULTS[name],
            fixed_routes=True)) > SERVE_REL_TOL
