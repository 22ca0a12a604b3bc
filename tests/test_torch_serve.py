"""The port's LM and server against the JAX reference on the CPU.

Weights come from the reference's ``init_params`` (seeded) and reach the
port through ``models.convert.params_from_numpy``; token inputs come from
numpy generators. Float32 logits are held at the tolerances of the
reference's own prefill/decode test (tests/test_models_smoke.py:74-81):
2e-4 for forward and prefill, 3e-3 for a decode step. bf16 weights carry
bit for bit. bf16 token streams must be equal; the stream test guards
itself against near-ties (see ``LOGIT_TOL``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.launch import serve as r_serve
from repro.models import lm as r_lm
from repro_torch.benchmarks.serve_consistency import (FAULTS,
                                                      prefill_decode_logits,
                                                      rel_gap)
from repro_torch.configs import all_arch_names, get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM
from chip_smoke import SERVE_REL_TOL

ARCH = "qwen1.5-0.5b"
#: every architecture the port registers
PORTED = ("deepseek-7b", "granite-20b", "internlm2-1.8b",
          "jamba-1.5-large-398b", "llama-3.2-vision-90b", "mixtral-8x7b",
          "phi3.5-moe-42b-a6.6b", "qwen1.5-0.5b", "rwkv6-7b",
          "whisper-medium")
PREFILL_TOL = 2e-4
DECODE_TOL = 3e-3
#: bf16 logits of the two packages differ by up to LOGIT_TOL / 2 on the
#: stream test's inputs (XLA and torch round at different places), and the
#: reference's top-2 margin exceeds LOGIT_TOL at every greedy step there,
#: so equal streams are implied and a near-tie cannot make the test flaky
LOGIT_TOL = 0.02
#: params seed, prompt lengths (16 is off the 32-token attn_block: the pad
#: path) and new tokens of the stream test; the seed was picked for its
#: margins, which the test re-checks
STREAM_SEED, STREAM_PROMPTS, STREAM_NEW = 17, (32, 16, 48), 3


def _cfgs(dtype):
    return (dataclasses.replace(r_get_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype))


def _port(cfg, tree) -> LM:
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_numpy(cfg, tree))
    return model


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def f32_pair():
    """Reference params (norm scales and QKV biases moved off 1 and 0 so
    the comparison reaches them) in both packages, float32."""
    rcfg, tcfg = _cfgs("float32")
    tree = jax.tree.map(np.asarray,
                        r_lm.init_params(rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def nudge(a, base):
        return (base + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)

    tree["final_norm"] = nudge(tree["final_norm"], 1.0)
    for sp in tree["blocks"].values():
        for name, base in (("ln1", 1.0), ("ln2", 1.0), ("bq", 0.0),
                           ("bk", 0.0), ("bv", 0.0)):
            sp[name] = nudge(sp[name], base)
    return rcfg, jax.tree.map(jnp.asarray, tree), _port(tcfg, tree)


@pytest.mark.parametrize("arch", PORTED)
def test_configs_match_the_reference(arch):
    assert all_arch_names() == list(PORTED)
    for reduced in (False, True):
        want, got = r_get_config(arch), get_config(arch)
        if reduced:
            want, got = want.reduced(), got.reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_forward_matches_the_reference_f32(f32_pair):
    rcfg, params, model = f32_pair
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 32))
    want, _, _ = r_lm.forward(rcfg, params, jnp.asarray(toks), attn_block=16)
    got = model(torch.from_numpy(toks), attn_block=16)
    assert got.shape == (2, 32, rcfg.vocab)
    _close(got, want, PREFILL_TOL)


def test_prefill_and_decode_match_the_reference_f32(f32_pair):
    rcfg, params, model = f32_pair
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, (2, 24))
    want, r_cache = r_lm.prefill(rcfg, params, jnp.asarray(toks), seq_cap=40,
                                 attn_block=16)
    got, cache = model.prefill(torch.from_numpy(toks), seq_cap=40,
                               attn_block=16)
    _close(got, want, PREFILL_TOL)
    assert cache["len"] == int(r_cache["len"]) == 24
    assert set(cache) == set(r_cache)
    for name in ("k", "v"):
        assert cache["slot0"][name].shape == r_cache["slot0"][name].shape
        _close(cache["slot0"][name], r_cache["slot0"][name], PREFILL_TOL)

    nxt = np.asarray([[3], [5]])
    want, r_cache = r_lm.decode_step(rcfg, params, jnp.asarray(nxt), r_cache)
    got, cache = model.decode_step(torch.from_numpy(nxt), cache)
    _close(got, want, DECODE_TOL)
    assert cache["len"] == int(r_cache["len"]) == 25
    for name in ("k", "v"):
        _close(cache["slot0"][name], r_cache["slot0"][name], DECODE_TOL)
    empty = model.init_cache(2, 40)
    assert empty["len"] == 0 and empty["slot0"]["k"].shape == \
        r_lm.init_cache(rcfg, 2, 40)["slot0"]["k"].shape


def test_prefill_matches_decode_in_float32_at_depth():
    """The serving check's two paths agree to rounding when rounding is
    float32 (bf16 noise is what chip_smoke's tolerance allows for)."""
    _, tcfg = _cfgs("float32")
    model = LM(dataclasses.replace(tcfg, n_layers=6), device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        2, tcfg.vocab, 96))[None]
    assert rel_gap(*prefill_decode_logits(model, prompt, 16)) < 1e-4


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_cache_faults_break_prefill_decode_consistency(fault):
    """Each fault ``serve_consistency`` plants in the decode's cache moves
    the float32 logits far past the agreement of the test above (a lost
    slot by ~3e-2, a position off by one by more than chip_smoke's bf16
    limit)."""
    _, tcfg = _cfgs("float32")
    model = LM(dataclasses.replace(tcfg, n_layers=6), device="cpu")
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        2, tcfg.vocab, 96))[None]
    gap = rel_gap(*prefill_decode_logits(model, prompt, 16,
                                         plant=FAULTS[fault]))
    assert gap > (1e-2 if fault == "lost_slot" else SERVE_REL_TOL)


def test_bf16_weights_carry_bit_for_bit():
    rcfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray,
                        r_lm.init_params(rcfg, jax.random.PRNGKey(5)))
    sd = _port(tcfg, tree).state_dict()

    def bits(t):
        return t.view(torch.int16).numpy().view(np.uint16)

    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(bits(sd[name]),
                                      tree[name].view(np.uint16))
    for name, stacked in tree["blocks"]["slot0"].items():
        for p in range(rcfg.n_periods):
            np.testing.assert_array_equal(bits(sd[f"layers.{p}.{name}"]),
                                          stacked[p].view(np.uint16))
    assert all(t.dtype == torch.bfloat16 for t in sd.values())


def test_server_streams_match_the_reference():
    rcfg, tcfg = _cfgs("bfloat16")
    params = r_lm.init_params(rcfg, jax.random.PRNGKey(STREAM_SEED))
    model = _port(tcfg, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(STREAM_SEED)
    prompts = [rng.integers(2, rcfg.vocab, n).astype(np.int32)
               for n in STREAM_PROMPTS]
    decode = jax.jit(lambda p, t, c: r_lm.decode_step(rcfg, p, t, c))

    # The servers' path one request at a time, with both packages' logits
    # at every greedy step: the margin guard.
    greedy = []
    for prompt in prompts:
        pad = (-len(prompt)) % 32
        toks = np.pad(prompt, (0, pad))[None]
        r_lg, r_c = r_lm.prefill(rcfg, params, jnp.asarray(toks),
                                 seq_cap=256, attn_block=32)
        r_c["len"] = r_c["len"] - pad
        t_lg, t_c = model.prefill(torch.from_numpy(toks).long(), seq_cap=256,
                                  attn_block=32)
        t_c["len"] -= pad
        out = []
        for step in range(STREAM_NEW):
            want = np.asarray(r_lg[0].astype(jnp.float32))
            top2 = np.sort(want)[-2:]
            assert top2[1] - top2[0] > LOGIT_TOL, (prompt.shape, step, top2)
            delta = np.abs(t_lg[0].float().numpy() - want).max()
            assert delta <= LOGIT_TOL / 2, (prompt.shape, step, delta)
            out.append(int(np.argmax(want)))
            if step + 1 < STREAM_NEW:
                r_lg, r_c = decode(params, jnp.asarray([[out[-1]]]), r_c)
                t_lg, t_c = model.decode_step(torch.tensor([[out[-1]]]), t_c)
        greedy.append(out)

    r_done, _, r_steps = r_serve.Server(ARCH, batch=2, params=params).run(
        [r_serve.Request(i, p, STREAM_NEW) for i, p in enumerate(prompts)])
    srv = serve.Server(ARCH, batch=2, device="cpu",
                       params=params_from_numpy(tcfg, jax.tree.map(
                           np.asarray, params)))
    t_done, _, t_steps = srv.run(
        [serve.Request(i, p, STREAM_NEW) for i, p in enumerate(prompts)])
    assert [r.out for r in t_done] == [r.out for r in r_done] == greedy
    assert t_steps == r_steps
    assert len(srv.timings["prefill_s"]) == len(prompts)
    assert len(srv.timings["decode_step_s"]) == t_steps


def test_padded_prompt_first_token_comes_from_the_pad_position():
    """Reference fault kept for parity (ROADMAP Queue 3): a prompt off the
    attn_block is right-padded with token 0, and the first token is the
    argmax at the last PAD position, not at the prompt's last token."""
    rcfg, tcfg = _cfgs("bfloat16")
    r_srv = r_serve.Server(ARCH, batch=1)
    t_srv = serve.Server(ARCH, batch=1, device="cpu",
                         params=params_from_numpy(tcfg, jax.tree.map(
                             np.asarray, r_srv.params)))
    prompt = np.random.default_rng(1).integers(2, rcfg.vocab, 16) \
        .astype(np.int32)
    r_out = r_srv.run([r_serve.Request(0, prompt, 1)])[0][0].out
    t_out = t_srv.run([serve.Request(0, prompt, 1)])[0][0].out

    def last_logits(toks):
        lg, _, _ = r_lm.forward(rcfg, r_srv.params, jnp.asarray(toks)[None],
                                attn_block=32)
        return np.asarray(lg[0, -1].astype(jnp.float32))

    padded = np.pad(prompt, (0, 16))
    at_pad, at_last = last_logits(padded), last_logits(prompt)
    port_at_pad = t_srv.model(torch.from_numpy(padded)[None].long(),
                              attn_block=32)[0, -1].float().numpy()
    # no near-tie at the pad position: the top-2 margin exceeds twice the
    # packages' largest logit difference there
    delta = np.abs(port_at_pad - at_pad).max()
    assert np.diff(np.sort(at_pad)[-2:])[0] > 2 * delta
    assert r_out == t_out == [int(np.argmax(at_pad))] == [373]
    assert int(np.argmax(at_last)) == 164


def test_lm_and_server_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    _, tcfg = _cfgs("bfloat16")
    with pytest.raises(RuntimeError):
        LM(tcfg)
    with pytest.raises(RuntimeError):
        serve.Server(ARCH)
    assert serve.Server(ARCH, device="cpu").model.device.type == "cpu"


@pytest.mark.parametrize("change,ctx_width,error", [
    ({"slots": ("hyena",)}, None, NotImplementedError),
    ({"ffn_slots": ("glu2",)}, None, NotImplementedError),
    ({"slots": ("cross",), "cross_len": 8}, None, ValueError),
    ({"encoder_layers": 2, "learned_pos": True}, None, ValueError),
    ({"slots": ("cross",), "cross_len": 8}, 32, ValueError)])
def test_other_architectures_raise(change, ctx_width, error):
    """An unknown mixer or FFN kind raises when the model is built; a
    cross or encoder-decoder config raises at its forward without a
    context, or with one whose width is not d_model."""
    _, tcfg = _cfgs("bfloat16")
    ctx = None if ctx_width is None else torch.zeros((1, 8, ctx_width))
    with pytest.raises(error):
        LM(dataclasses.replace(tcfg, **change), device="cpu")(
            torch.zeros((1, 4), dtype=torch.long), ctx)
