"""Training the state-space and hybrid configs: the port against the JAX
reference on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``: the gradients of
``mamba_mix``, ``_chunked_decay_attn`` and ``rwkv6_mix`` with respect to
every parameter, the input and a carried state against ``jax.grad``, at S
128 (whole 64-token chunks) and 100 (chunks of 50), so that the chunk
loop carries the state; the decay clamp at a planted exact tie, where
``jnp.maximum`` splits the gradient in half; the loss and every gradient
leaf of reduced rwkv6-7b and of reduced jamba cut to three slots of its
period (mamba, mamba with the MoE, attention; the same cut of the
reference's config) against ``jax.value_and_grad`` of the
reference's ``loss_fn``; remat against none; both trainers side by side,
with a fault and without; AdamW on the float32 leaves; checkpoint shards;
the decay set and the probe; the slot cut of ``configs.period_slots``;
rwkv's ``u`` carrying nearly all of one layer's gradient norm at the
reference's init; and ``chip_smoke``'s model FLOPs, launch counts and
cuts on these configs, its published init scale on every depth cut, its
leaf-by-leaf card-vs-CPU hold and its device times from complete traces.

The weights are the reference's ``init_params`` with the constants drawn
off their values and rwkv's four hash-keyed matrices drawn from numpy
(``test_torch_hybrid._nudged``), so every test is the same in every
process (ROADMAP Queue 3). ``dec_bias`` is drawn around -1.5, so rwkv's
decay lies on both sides of its clamp: at the reference's init (0.5)
every channel is clamped and ``w_dec``, ``mu_w`` and ``dec_bias`` get
exactly 0 in both packages.

Tolerances, float32: each mixer gradient within ``MIX_GRAD_TOL`` = 5e-5
of its leaf's largest magnitude (read: at most 7.8e-6, mamba's
``a_log``); the models at ``test_torch_train.py``'s loss and gradient
tolerances (the gradients' largest gap read here is 2.3e-4 of a leaf's
largest gradient, jamba's attention ``wk``, whose gradients are ~1e-6);
remat against no remat bit for bit; the trainers' losses at
``TRAIN_RTOL``; AdamW at ``OPT_RTOL``. Shard blobs, decay sets, dtypes
and counts are compared exactly.
"""
import contextlib
import dataclasses
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.checkpoint import VcsCheckpointer as RCkpt
from repro.configs import get_config as r_get_config
from repro.core import Engine as REngine
from repro.launch import train as r_train
from repro.models import lm as r_lm
from repro.models import ssm as r_ssm
from repro.optim import adamw as r_adamw
from repro_torch.checkpoint import VcsCheckpointer
from repro_torch.configs import first_layers, get_config, period_slots
from repro_torch.core import Engine
from repro_torch.launch import train
from repro_torch.models import ssm
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, params_to_numpy,
                                        stack_tree)
from repro_torch.models.lm import LM, loss_fn
from repro_torch.optim import AdamWCfg, OptState, init_opt_state
from test_torch_hybrid import _dehashed, _nudged
from test_torch_ssm import HD, MAMBA, _mamba_params, _rwkv_params
from test_torch_train import (GRAD_RTOL, GRAD_SCALE_TOL, LOSS_RTOL, OPT_RTOL,
                              TRAIN_RTOL, _leaves_equal, _shard_rows, _t)

MIX_GRAD_TOL = 5e-5
#: the reduced configs: rwkv6-7b whole (2 rwkv layers), jamba cut to the
#: slots 0, 1 and 4 of its first period (``configs.period_slots``): one
#: layer of each kind, mamba/mlp, mamba/moe and attn/mlp
ARCHS = {"rwkv6-7b": None, "jamba-1.5-large-398b": (0, 1, 4)}
#: float32 inputs that hit the clamps exactly: softplus(MAMBA_TIE_DT_BIAS)
#: is 1.0 and exp(MAMBA_TIE_A_LOG) 0.5 in both packages, so at a zero
#: input row mamba's log-decay dt * -exp(a_log) is -0.5, its bound;
#: exp(RWKV_TIE_DEC_BIAS) is 0.25, so at two zero rows in a row rwkv's
#: -exp(wr) is -0.25, its bound
MAMBA_TIE_DT_BIAS = np.float32(0.54132485)
MAMBA_TIE_A_LOG = np.float32(-0.6931472)
RWKV_TIE_DEC_BIAS = np.float32(-1.3862944)
#: the zero rows of the tie tests' input, in pairs (rwkv's decay reads a
#: row and the one before it), a few nonzero rows apart, so that the state
#: the tied decays act on is not decayed away
TIE_ROWS = [t + i for t in range(10, 100, 6) for i in (-1, 0)]


# ------------------------------------------------------------ the mixers

def _mixer(kind):
    """(reference's mixer, port's mixer) as f(params, x, state) ->
    (y, state)."""
    if kind == "mamba":
        return (lambda p, x, s: r_ssm.mamba_mix(p, x, s, **MAMBA),
                lambda p, x, s: ssm.mamba_mix(p, x, s, **MAMBA))
    return (lambda p, x, s: r_ssm.rwkv6_mix(p, x, s, head_dim=HD),
            lambda p, x, s: ssm.rwkv6_mix(p, x, s, head_dim=HD))


def _state_shapes(kind, B=2):
    if kind == "mamba":             # conv (B, d_conv-1, di), ssm
        return (B, 3, 128), (B, 8, 4, 16)
    if kind == "rwkv":              # shift (B, 1, d), wkv
        return (B, 1, 64), (B, 4, 16, 16)
    return ((B, 8, 4, 16),)         # _chunked_decay_attn's state


def _grads(r_fn, t_fn, args, seed):
    """Gradients of sum(y * dy) + sum(state * ds) with respect to every
    tensor of ``args`` (a dict of arrays, or of dicts of arrays), through
    the reference and the port: (want, got), flat dicts of numpy."""
    rng = np.random.default_rng(seed)

    def flat(tree, fn):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update({f"{k}.{n}": fn(a) for n, a in v.items()})
            elif v is not None:
                out[k] = fn(v)
        return out
    r_args = {k: (jax.tree.map(jnp.asarray, v) if v is not None else None)
              for k, v in args.items()}
    t_args = {k: (jax.tree.map(lambda a: torch.from_numpy(a)
                               .requires_grad_(), v)
                  if v is not None else None) for k, v in args.items()}
    y, st = t_fn(**t_args)
    dy = rng.standard_normal(y.shape).astype(np.float32)
    ds = [rng.standard_normal(s.shape).astype(np.float32) for s in st]

    def r_loss(a):
        ry, rst = r_fn(**a)
        return jnp.sum(ry * dy) + sum(jnp.sum(s * d) for s, d in zip(rst, ds))
    want = flat(jax.jit(jax.grad(r_loss))(r_args), np.asarray)
    ((y * torch.from_numpy(dy)).sum()
     + sum((s * torch.from_numpy(d)).sum() for s, d in zip(st, ds))
     ).backward()
    got = flat(t_args, lambda t: t.grad.numpy())
    return want, got


def _mix_grads(kind, S, carry, params=None, x=None):
    rng = np.random.default_rng([S, carry, len(kind)])
    params = params if params is not None else (
        _mamba_params() if kind == "mamba" else _rwkv_params())
    x = x if x is not None else \
        rng.standard_normal((2, S, 64)).astype(np.float32)
    state = tuple(rng.standard_normal(s).astype(np.float32)
                  for s in _state_shapes(kind)) if carry else None
    r_mix, t_mix = _mixer(kind)

    def r_fn(p, x, s):
        return r_mix(p, x, None if s is None else tuple(s.values()))

    def t_fn(p, x, s):
        return t_mix(p, x, None if s is None else tuple(s.values()))
    args = {"p": params, "x": x,
            "s": None if state is None else dict(enumerate(state))}
    return _grads(r_fn, t_fn, args, [S, carry])


def _held(want, got, tol=MIX_GRAD_TOL):
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= tol * np.abs(w).max(), name


@pytest.mark.parametrize("S,carry", [(128, False), (100, True)])
@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_mixer_gradients_match_jax_grad(kind, S, carry):
    want, got = _mix_grads(kind, S, carry)
    _held(want, got)
    names = set(_mamba_params() if kind == "mamba" else _rwkv_params())
    assert {n.split(".", 1)[1] for n in want if n.startswith("p.")} == names
    assert carry == any(n.startswith("s.") for n in want)
    # the decay's leaves carry a gradient (their clamp is not everywhere
    # active at these inputs)
    for n in (("p.a_log", "p.dt_bias") if kind == "mamba"
              else ("p.w_dec", "p.mu_w", "p.dec_bias")):
        assert np.abs(want[n]).max() > 0 and np.abs(got[n]).max() > 0


@pytest.mark.parametrize("S,carry", [(128, False), (100, True)])
def test_chunked_decay_attn_gradients_match_jax_grad(S, carry):
    rng = np.random.default_rng([S, carry])
    B, ds, nh, hp = 2, 4, 8, 16
    args = {"q": rng.standard_normal((B, S, ds)).astype(np.float32),
            "k": rng.standard_normal((B, S, ds)).astype(np.float32),
            "v": rng.standard_normal((B, S, nh, hp)).astype(np.float32),
            "logw": -rng.uniform(0, 0.5, (B, S, nh)).astype(np.float32),
            "state": rng.standard_normal((B, nh, ds, hp)).astype(np.float32)
            if carry else None}

    def wrap(fn):
        def run(**a):
            y, h = fn(a["q"], a["k"], a["v"], a["logw"], chunk=64,
                      state=a["state"])
            return y, (h,)
        return run
    want, got = _grads(wrap(r_ssm._chunked_decay_attn),
                       wrap(ssm._chunked_decay_attn), args, [S, 7])
    _held(want, got)
    assert set(want) == {"q", "k", "v", "logw"} | ({"state"} if carry
                                                    else set())


def _tie_inputs(kind):
    """Params and an input with the clamp's bound hit exactly on the
    zero rows: mamba's head 0 (a_log and dt_bias planted), rwkv's first 8
    channels (dec_bias planted)."""
    x = np.random.default_rng(3).standard_normal((2, 100, 64)) \
        .astype(np.float32)
    x[:, TIE_ROWS] = 0.0
    if kind == "mamba":
        p = _mamba_params()
        p["dt_bias"][0], p["a_log"][0] = MAMBA_TIE_DT_BIAS, MAMBA_TIE_A_LOG
        return p, x, ("p.a_log", "p.dt_bias")
    p = _rwkv_params()
    p["dec_bias"][:8] = RWKV_TIE_DEC_BIAS
    return p, x, ("p.dec_bias",)


def test_the_planted_values_hit_the_clamps_exactly_in_both_packages():
    one = np.float32(1.0)
    assert float(jax.nn.softplus(jnp.float32(MAMBA_TIE_DT_BIAS))) == one
    assert float(ssm._softplus(torch.tensor(MAMBA_TIE_DT_BIAS))) == one
    for exp in (lambda a: float(jnp.exp(jnp.float32(a))),
                lambda a: float(torch.exp(torch.tensor(a)))):
        assert exp(MAMBA_TIE_A_LOG) == 0.5
        assert exp(RWKV_TIE_DEC_BIAS) == 0.25
    assert np.float32(1.0) * -np.float32(0.5) == np.float32(ssm._LOGW_MIN)
    assert -np.float32(0.25) == np.float32(ssm._LOGW_MIN_RWKV)


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_the_clamp_splits_the_gradient_at_a_tie_as_jax_does(monkeypatch,
                                                            kind):
    """At a planted exact tie the reference's ``jnp.maximum`` passes half
    the gradient to the decay and the port's ``_floor`` does the same;
    ``torch.clamp(min=)``, which the port used before, passes all of it,
    and its gradients of the planted leaves leave the tolerance (ROADMAP
    Queue 3, closed)."""
    p, x, planted = _tie_inputs(kind)
    want, got = _mix_grads(kind, 100, True, p, x)
    _held(want, got)
    monkeypatch.setattr(ssm, "_floor",
                        lambda t, lo: torch.clamp(t, min=lo))
    _, clamped = _mix_grads(kind, 100, True, p, x)
    for n in planted:
        gap = np.abs(clamped[n] - want[n]).max() / np.abs(want[n]).max()
        assert gap > 100 * MIX_GRAD_TOL, (n, gap)


# ------------------------------------------------------------ the models

def _cfgs(arch, dtype="float32"):
    """Both packages' reduced config, jamba cut to ARCHS' slots (the
    reference's by hand, as ``period_slots`` cuts the port's)."""
    rcfg = dataclasses.replace(r_get_config(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    slots = ARCHS[arch]
    if slots:
        tcfg = period_slots(tcfg, slots)
        rcfg = dataclasses.replace(rcfg, n_layers=len(slots),
                                   period=len(slots), slots=tcfg.slots,
                                   ffn_slots=tcfg.ffn_slots,
                                   moe=rcfg.moe if tcfg.moe else None)
    return rcfg, tcfg


def _tree(rcfg, seed=0):
    return _nudged(jax.tree.map(
        np.asarray, r_lm.init_params(rcfg, jax.random.PRNGKey(seed))), seed)


def _batch(rng, vocab, s):
    tokens = rng.integers(0, vocab, (2, s)).astype(np.int32)
    targets = rng.integers(0, vocab, (2, s)).astype(np.int32)
    targets[0, -5:] = -1                               # masked targets
    return tokens, targets


def _port_loss_and_grads(tcfg, tree, tokens, targets, remat):
    model = LM(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(tcfg, tree))
    model.requires_grad_()
    loss = loss_fn(model, {"tokens": _t(tokens).long(),
                           "targets": _t(targets).long()}, attn_block=16,
                   remat=remat)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch,S", [("rwkv6-7b", 100),
                                    ("jamba-1.5-large-398b", 128)])
def test_ssm_loss_and_every_gradient_match_the_reference(arch, S):
    rcfg, tcfg = _cfgs(arch)
    tree = _tree(rcfg)
    tokens, targets = _batch(np.random.default_rng([S, len(arch)]),
                             rcfg.vocab, S)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_lm.loss_fn(rcfg, p, {"tokens": jnp.asarray(tokens),
                                         "targets": jnp.asarray(targets)},
                               attn_block=16)))(
        jax.tree.map(jnp.asarray, tree))
    loss, grads = _port_loss_and_grads(tcfg, tree, tokens, targets, False)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=LOSS_RTOL)
    got_tree = params_to_numpy(tcfg, grads)
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, r_grads))
    assert len(leaves) == len(jax.tree_util.tree_leaves(got_tree))
    for path, w in leaves:
        got = got_tree
        for key in path:
            got = got[key.key]
        assert got.dtype == w.dtype
        np.testing.assert_allclose(got, w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE_TOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    blocks = got_tree["blocks"]
    if arch == "rwkv6-7b":
        # the decay's leaves: a gradient on the channels where the clamp
        # is not active, none on those where it is, in both packages
        for name in ("w_dec", "mu_w", "dec_bias", "u"):
            assert np.abs(blocks["slot0"][name]).max() > 0, name
        for g in (blocks["slot0"]["dec_bias"],
                  np.asarray(r_grads["blocks"]["slot0"]["dec_bias"])):
            assert 0 < np.count_nonzero(g) < g.size
    else:
        assert {blocks[s]["a_log"].any() for s in blocks
                if "a_log" in blocks[s]} == {True}
        assert np.abs(blocks["slot1"]["router"]).max() > 0
        assert np.abs(blocks["slot2"]["wq"]).max() > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_gives_the_same_bits(arch):
    rcfg, tcfg = _cfgs(arch)
    tree = _tree(rcfg, 1)
    tokens, targets = _batch(np.random.default_rng(2), rcfg.vocab, 96)
    loss, grads = _port_loss_and_grads(tcfg, tree, tokens, targets, False)
    loss_r, grads_r = _port_loss_and_grads(tcfg, tree, tokens, targets, True)
    assert torch.equal(loss, loss_r)
    assert grads.keys() == grads_r.keys()
    assert all(torch.equal(grads[n], grads_r[n]) for n in grads)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_keeps_the_float32_leaves_and_moments(arch):
    """A bf16 model's train_step: the leaves the reference keeps in
    float32 (a_log, dt_bias, d_skip, dec_bias, u) stay float32 and the
    others bf16, the moments are float32, and one AdamW step of the same
    gradients gives the reference's parameters and moments, dtype for
    dtype."""
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    model = LM(tcfg, device="cpu")
    model.requires_grad_()
    live = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in live.items()}
    opt_cfg = AdamWCfg(warmup_steps=2, decay_steps=4)
    tokens, targets = _batch(np.random.default_rng(4), tcfg.vocab, 64)
    opt = init_opt_state(live, opt_cfg)
    opt, _ = train.train_step(model, {"tokens": _t(tokens).long(),
                                      "targets": _t(targets).long()},
                              opt, opt_cfg, train.decay_names(live), 16,
                              remat=True)
    grads = {n: p.grad for n, p in live.items()}
    f32 = {n for n, p in live.items() if p.dtype == torch.float32}
    assert {n.rsplit(".", 1)[1] for n in f32} == (
        {"dec_bias", "u"} if arch == "rwkv6-7b"
        else {"a_log", "dt_bias", "d_skip"})
    assert all(live[n].dtype == torch.bfloat16 for n in live if n not in f32)
    assert all(t.dtype == torch.float32 for t in (*opt.mu.values(),
                                                  *opt.nu.values()))
    # the reference's step from the same parameters and gradients (bf16
    # leaves come back from params_to_numpy as their uint16 bits)
    def to_jax(flat):
        return jax.tree.map(lambda a: jnp.asarray(
            a.view(jnp.bfloat16) if a.dtype == np.uint16 else a),
            params_to_numpy(tcfg, flat))
    r_params, r_grads = to_jax(before), to_jax(grads)
    rcfg_opt = r_adamw.AdamWCfg(warmup_steps=2, decay_steps=4)
    r_p, r_o, _ = jax.jit(r_adamw.apply_updates, static_argnums=3)(
        r_params, r_grads, r_adamw.init_opt_state(r_params, rcfg_opt),
        rcfg_opt)
    got = {"params": stack_tree(tcfg, live), "mu": stack_tree(tcfg, opt.mu),
           "nu": stack_tree(tcfg, opt.nu)}
    for key, want in (("params", r_p), ("mu", r_o.mu), ("nu", r_o.nu)):
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            g = got[key]
            for k in path:
                g = g[k.key]
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
            w = np.asarray(w.astype(jnp.float32))
            np.testing.assert_allclose(
                g.detach().float().numpy(), w, rtol=OPT_RTOL,
                atol=OPT_RTOL * np.abs(w).max(),
                err_msg=f"{key}{jax.tree_util.keystr(path)}")


# ------------------------------------------------------------ trainer

def _both_loops(monkeypatch, arch, **kw):
    """One train_loop per package from the same float32 weights (the
    reference's config and init patched to the cut and to those weights);
    returns ((losses, engine, printed) for the reference, then the
    port)."""
    rcfg, tcfg = _cfgs(arch)
    tree = _tree(rcfg)
    monkeypatch.setattr(r_train, "get_config", lambda a: rcfg)
    monkeypatch.setattr(r_lm, "init_params",
                        lambda cfg, key: jax.tree.map(jnp.asarray, tree))
    out = []
    for run in (lambda: r_train.train_loop(arch, reduced=False, **kw),
                lambda: train.train_loop(
                    tcfg, reduced=False, device="cpu",
                    params=params_from_numpy(tcfg, tree), **kw)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, losses, engine = run()
        out.append((np.asarray(losses), engine, buf.getvalue()))
    return out


@pytest.mark.parametrize("fault", [None, 2])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_three_train_loop_steps_match_the_reference(monkeypatch, arch,
                                                    fault):
    """Three steps of each trainer, with a checkpoint after every step;
    with a fault injected at step 2, both roll back to step 1 once and
    replay it."""
    (r_l, r_e, r_out), (t_l, t_e, t_out) = _both_loops(
        monkeypatch, arch, steps=3, seq_len=32, global_batch=4,
        ckpt_every=1, log_every=100, inject_fault_at=fault)
    assert len(r_l) == len(t_l) == 3
    assert np.isfinite(t_l).all()
    np.testing.assert_allclose(t_l, r_l, rtol=TRAIN_RTOL)
    assert sorted(t_e.snapshots) == sorted(r_e.snapshots)
    rolled = [ln for ln in t_out.splitlines() if "rolled back" in ln]
    assert rolled == [ln for ln in r_out.splitlines() if "rolled back" in ln]
    assert rolled == ([] if fault is None else
                      ["[train] fault detected @ 2: rolled back to "
                       "run1-step-1"])
    assert _shard_rows(t_e, "run1-step-3") and \
        [len(b) for b in _shard_rows(t_e, "run1-step-3")] == \
        [len(b) for b in _shard_rows(r_e, "run1-step-3")]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ssm_checkpoint_shards_equal_the_reference(monkeypatch, arch):
    """A training state of bf16 params with their float32 leaves, float32
    moments and the step, saved by both packages: the same layout and the
    same shard rows, restored bit for bit."""
    from repro.checkpoint import vcs_ckpt as r_vcs_ckpt
    from repro_torch.checkpoint import vcs_ckpt
    monkeypatch.setattr(r_vcs_ckpt, "SHARD_BYTES", 4096)
    monkeypatch.setattr(vcs_ckpt, "SHARD_BYTES", 4096)
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, _dehashed(
        r_lm.init_params(rcfg, jax.random.PRNGKey(3))))
    rng = np.random.default_rng(3)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    nu = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), tree)
    r_state = {"params": tree,
               "opt": r_adamw.OptState(np.asarray(7, np.int32), mu, nu)}
    opt = opt_state_from_numpy(tcfg, r_state["opt"])
    t_state = {"params": stack_tree(tcfg, params_from_numpy(tcfg, tree)),
               "opt": OptState(opt.step, stack_tree(tcfg, opt.mu),
                               stack_tree(tcfg, opt.nu))}
    f32 = {n for sp in t_state["params"]["blocks"].values()
           for n, t in sp.items() if t.dtype == torch.float32}
    assert f32 == ({"dec_bias", "u"} if arch == "rwkv6-7b"
                   else {"a_log", "dt_bias", "d_skip"})
    r_e, t_e = REngine(), Engine(device="cpu")
    r_ck, t_ck = RCkpt(r_e), VcsCheckpointer(t_e)
    r_ck.save(r_state, 0)
    t_ck.save(t_state, 0)
    assert t_ck._layout == [(n, tuple(s), d, k)
                            for n, s, d, k in r_ck._layout]
    assert _shard_rows(t_e, "step-0") == _shard_rows(r_e, "step-0")
    like_t = jax.tree.map(torch.zeros_like, t_state)
    _leaves_equal(r_state, t_ck.restore("step-0", like_t))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decay_and_probe_on_the_ssm_leaves_follow_the_reference(arch):
    """AdamW decays the reference's leaves of two or more dimensions on its
    stacked tree: every SSM leaf carries the period axis, so all of them
    (a_log, dec_bias, u and the mu_* among them; Queue 3, weight decay
    reaches norms and biases), and the health probe is the reference's
    global norm of each leaf's first slice."""
    from repro.optim.adamw import global_norm as r_global_norm
    rcfg, tcfg = _cfgs(arch)
    tree = _tree(rcfg, 4)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(tcfg, tree))
    live = dict(model.named_parameters())
    decay = set(train.decay_names(live))
    want = {jax.tree_util.keystr(path) for path, a in
            jax.tree_util.tree_leaves_with_path(tree) if a.ndim >= 2}
    marks = params_to_numpy(tcfg, {n: torch.full(p.shape, float(n in decay))
                                   for n, p in live.items()})
    got = {jax.tree_util.keystr(path) for path, a in
           jax.tree_util.tree_leaves_with_path(marks) if a.all()}
    assert got == want
    assert decay == {n for n in live if n.startswith("layers.")} \
        | {"embed", "lm_head"}
    r_probe = float(r_global_norm(jax.tree.map(lambda a: a[:1], tree)))
    np.testing.assert_allclose(float(train.probe_norm(tcfg, live)), r_probe,
                               rtol=LOSS_RTOL)


# ------------------------------------------------------------ the cut

def test_period_slots_cuts_jamba_to_its_training_layers():
    """jamba's training cut: slots 0, 2 and 4 of its first period (mamba,
    mamba, attention, each with its MLP), the serve cut's first five
    layers less their two MoE layers; at the published widths, 3.85 B
    parameters, no MoE left."""
    full = get_config("jamba-1.5-large-398b")
    cut = period_slots(full, (0, 2, 4))
    five = first_layers(full, 5)
    keep = tuple(i for i, f in enumerate(five.ffn_kinds()) if f != "moe")
    assert keep == (0, 2, 4)
    assert period_slots(five, keep) == cut
    assert (cut.n_layers, cut.period, cut.n_periods) == (3, 3, 1)
    assert cut.slot_kinds() == ("mamba", "mamba", "attn")
    assert cut.ffn_kinds() == ("mlp",) * 3 and cut.moe is None
    assert (cut.d_model, cut.d_ff, cut.n_heads, cut.n_kv_heads, cut.hd,
            cut.ssm) == (full.d_model, full.d_ff, full.n_heads,
                         full.n_kv_heads, full.hd, full.ssm)
    assert chip_smoke.param_count(cut) == 3_846_891_008
    assert cut.n_params() == cut.n_params_active()
    # the same cut of the reference's config counts the same parameters
    r_full = r_get_config("jamba-1.5-large-398b")
    r_cut = dataclasses.replace(
        r_full, n_layers=3, period=3, slots=("mamba", "mamba", "attn"),
        ffn_slots=("mlp",) * 3, moe=None)
    assert r_cut.n_params() == cut.n_params()
    # a cut that keeps an MoE layer keeps the MoE
    assert period_slots(full, (1,)).moe == full.moe
    assert period_slots(full, (0,)).slot_kinds() == ("mamba",)
    for bad in ((), (2, 0), (0, 0), (8,), (-1, 2)):
        with pytest.raises(ValueError):
            period_slots(full, bad)


def test_rwkv_u_carries_the_gradient_norm_at_the_reference_init(d=256):
    """At the reference's own init (every decay clamped, ``u`` zero, the
    block matrices drawn at 1/sqrt(periods), here taken to the published
    32 layers' scale as ``chip_smoke.published_init_scale`` takes them)
    one rwkv6 layer's gradient norm is nearly all ``u``'s, in both
    packages alike: why ``chip_smoke``'s card-vs-CPU step holds each leaf
    as well as the global norm. The clamped decay's leaves get exactly
    none. rwkv's four hash-keyed matrices are drawn from numpy at the
    init's scale, so the test is the same in every process."""
    kw = dict(n_layers=1, d_model=d, n_heads=d // 64, n_kv_heads=d // 64,
              d_ff=int(3.5 * d), vocab=4096, dtype="float32")
    rcfg = dataclasses.replace(r_get_config("rwkv6-7b"), **kw)
    tcfg = dataclasses.replace(get_config("rwkv6-7b"), **kw)
    tree = jax.tree.map(np.asarray, r_lm.init_params(
        rcfg, jax.random.PRNGKey(0)))
    sp = tree["blocks"]["slot0"]
    rng = np.random.default_rng(d)
    for name in ("w_r", "w_k", "w_v", "w_g"):
        sp[name] = rng.standard_normal(sp[name].shape).astype(np.float32)
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "w1", "w2", "w3"):
        sp[name] = (sp[name] * np.float32(math.sqrt(1 / 32))).astype(
            np.float32)
    tokens, targets = _batch(rng, rcfg.vocab, 64)
    r_grads = jax.jit(jax.grad(lambda p: r_lm.loss_fn(
        rcfg, p, {"tokens": jnp.asarray(tokens),
                  "targets": jnp.asarray(targets)})))(
        jax.tree.map(jnp.asarray, tree))
    _, grads = _port_loss_and_grads(tcfg, tree, tokens, targets, False)
    got = params_to_numpy(tcfg, grads)
    want = jax.tree.map(np.asarray, r_grads)
    total = math.sqrt(sum(float(np.sum(np.square(g)))
                          for g in jax.tree_util.tree_leaves(want)))
    u = float(np.linalg.norm(want["blocks"]["slot0"]["u"]))
    assert u / total > 0.999
    np.testing.assert_allclose(np.linalg.norm(got["blocks"]["slot0"]["u"]),
                               u, rtol=GRAD_RTOL)
    for name in ("w_dec", "mu_w", "dec_bias"):
        assert not got["blocks"]["slot0"][name].any()
        assert not want["blocks"]["slot0"][name].any()


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_trains_the_ssm_cuts_it_names():
    """train_models' rows for the two configs: rwkv6-7b at 8 of 32
    layers, jamba at slots 0, 2 and 4 (a tuple), both at 4 x 2048."""
    rows = {arch: (cut, b, s) for arch, cut, b, s in chip_smoke.TRAIN_MODELS}
    assert rows["rwkv6-7b"] == (8, 4, 2048)
    assert rows["jamba-1.5-large-398b"] == ((0, 2, 4), 4, 2048)
    rwkv = chip_smoke.train_cut(get_config("rwkv6-7b"), 8)
    assert rwkv == first_layers(get_config("rwkv6-7b"), 8)
    assert chip_smoke.param_count(rwkv) == 2_751_795_200
    jamba = chip_smoke.train_cut(get_config("jamba-1.5-large-398b"),
                                 (0, 2, 4))
    assert jamba == period_slots(get_config("jamba-1.5-large-398b"),
                                 (0, 2, 4))
    assert chip_smoke.train_cut(get_config("deepseek-7b"), 16) == \
        dataclasses.replace(get_config("deepseek-7b"), n_layers=16)
    assert chip_smoke.cut_note(get_config("rwkv6-7b"), rwkv, 8) == \
        "n_layers 32 -> 8"
    # the bwd phase holds the kernel at jamba's attention layer
    assert (4, 2048, 2048, 64, 8, 128, True) in chip_smoke.BWD_ROWS


def test_chip_smoke_counts_attention_on_attention_slots_only():
    """The model FLOPs add attention's over its pairs on attention layers
    only, and the launch check expects the kernels there only: rwkv6 none
    (6 N T alone, N without the token embedding, a lookup), jamba's cut
    one layer (8 forwards and 4 backwards in 4 remat steps)."""
    b, s, steps = 4, 2048, chip_smoke.TRAIN_MODELS_STEPS
    rwkv = first_layers(get_config("rwkv6-7b"), 16)
    n = chip_smoke.param_count(rwkv)
    assert chip_smoke.attention_layers(rwkv) == 0
    assert chip_smoke.train_flops(n, rwkv, b, s) == \
        6.0 * (n - rwkv.vocab * rwkv.d_model) * b * s
    assert chip_smoke.train_launches(rwkv, steps) == {
        "flash_attention": 0, "flash_attention_bwd": 0}
    jamba = period_slots(get_config("jamba-1.5-large-398b"), (0, 2, 4))
    n = chip_smoke.param_count(jamba)
    fwd = 4.0 * b * 64 * 128 * chip_smoke.attention_pairs(s, s, True)
    assert chip_smoke.attention_layers(jamba) == 1
    assert chip_smoke.train_flops(n, jamba, b, s) == \
        6.0 * (n - jamba.vocab * jamba.d_model) * b * s + 3.5 * fwd
    assert chip_smoke.train_launches(jamba, steps) == {
        "flash_attention": 8, "flash_attention_bwd": 4}
    # a dense config: every layer, as before
    ds = first_layers(get_config("deepseek-7b"), 16)
    assert chip_smoke.train_launches(ds, steps)["flash_attention_bwd"] == 64


def test_chip_smoke_checks_the_ssm_configs_at_their_first_trained_slot():
    """train_models' card-vs-CPU step runs rwkv6 at its one rwkv layer and
    jamba at its slot 0 (mamba and MLP), each at the published init
    scale."""
    one = period_slots(get_config("rwkv6-7b"), (0,))
    assert (one.n_layers, one.slot_kinds(), one.ffn_kinds()) == (
        1, ("rwkv",), ("mlp",))
    j0 = period_slots(get_config("jamba-1.5-large-398b"), (0,))
    assert (j0.slot_kinds(), j0.ffn_kinds(), j0.moe) == (("mamba",),
                                                          ("mlp",), None)
    model = LM(dataclasses.replace(
        period_slots(get_config("jamba-1.5-large-398b").reduced(), (0,)),
        dtype="float32"), device="cpu")
    w_in = model.layers[0].w_in.detach().clone()
    conv = model.layers[0].conv.detach().clone()
    chip_smoke.published_init_scale(torch, model)
    # the cut's one period is drawn at 1, the published stack's first
    # period at 1/sqrt(9), bf16-rounded; the conv keeps its fixed scale
    assert get_config("jamba-1.5-large-398b").n_periods == 9
    assert torch.equal(model.layers[0].w_in,
                       (w_in * math.sqrt(1 / 9)).bfloat16().float())
    assert torch.equal(model.layers[0].conv, conv)


@pytest.mark.parametrize("arch,matrix,fixed", [
    ("deepseek-7b", "wq", None),
    ("mixtral-8x7b", "moe_w1", "router"),
])
def test_chip_smoke_draws_every_depth_cut_at_the_published_init_scale(
        arch, matrix, fixed):
    """``train_model`` takes every cut row, dense and MoE as well as the
    state-space ones, to the published depth's init scale: a layer
    matrix by sqrt(cut periods / published periods), bf16-rounded, the
    router at its fixed scale."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = LM(cfg, device="cpu")
    layer = model.layers[0]
    before = {n: getattr(layer, n).detach().clone()
              for n in (matrix, fixed) if n}
    chip_smoke.published_init_scale(torch, model)
    scale = math.sqrt(cfg.n_periods / get_config(arch).n_periods)
    assert scale < 1
    assert torch.equal(getattr(layer, matrix),
                       (before[matrix] * scale).bfloat16().float())
    if fixed:
        assert torch.equal(getattr(layer, fixed), before[fixed])


def test_chip_smoke_holds_the_gradient_leaf_by_leaf():
    """``leaf_gaps`` reads each leaf against the bf16 floor: a leaf that
    carries nearly all of the global norm (rwkv's ``u``) cannot hide a
    fault in another leaf, and a leaf that float32 gives no gradient must
    have none on either bf16 side."""
    rng = np.random.default_rng(0)
    f32 = {"u": 1e6 * rng.standard_normal((64, 64)),
           "w_r": rng.standard_normal((64, 64)),
           "ln_x": 1e-2 * rng.standard_normal(64),
           "w_dec": np.zeros((8, 8))}

    def bf16(tree, **fault):
        # a bf16 path: float32's gradient with 2% noise of its own
        return {n: torch.from_numpy(
            g * fault.get(n, 1.0)
            + 0.02 * np.abs(g).mean() * rng.standard_normal(g.shape))
            .bfloat16() for n, g in tree.items()}
    want = {n: torch.from_numpy(g).float() for n, g in f32.items()}
    cpu, card = bf16(f32), bf16(f32)
    out = chip_smoke.leaf_gaps(torch, card, cpu, want)
    assert out["leaves"] == 4 and out["zero_in_f32"] == ["w_dec"]
    assert out["zero_on_both"]
    assert out["largest"]["leaf"] == "u" and out["largest"]["share"] > 0.999
    assert out["median_gap"]["rel_diff"] < chip_smoke.TRAIN_GNORM_TOL
    assert out["worst_err_ratio"]["err_ratio"] < \
        chip_smoke.TRAIN_LEAF_ERR_RATIO
    # w_r 10% off on the card: the global norm's check does not see it,
    # the leaf's does
    faulty = dict(card, w_r=(card["w_r"].float() * 1.1).bfloat16())

    def norm(tree):
        return math.sqrt(sum(float(torch.sum(g.double() ** 2))
                             for g in tree.values()))
    assert abs(norm(faulty) - norm(cpu)) / norm(cpu) < \
        chip_smoke.TRAIN_GNORM_TOL
    out = chip_smoke.leaf_gaps(torch, faulty, cpu, want)
    assert out["worst_err_ratio"]["leaf"] == "w_r"
    assert out["worst_err_ratio"]["err_ratio"] > \
        chip_smoke.TRAIN_LEAF_ERR_RATIO
    card["w_dec"] = card["w_dec"] + 1e-3
    assert not chip_smoke.leaf_gaps(torch, card, cpu, want)["zero_on_both"]


def test_chip_smoke_takes_a_device_time_only_from_a_complete_trace(
        monkeypatch):
    """``per_launch_ms`` divides a trace's focus time by its calls only
    when the trace holds every launch (a one-call trace's count times the
    calls); a trace that lost some launches is taken again, three pairs
    at most, and each reading is logged."""
    counts = []

    def profile(torch_, fn, focus):
        n = counts.pop(0)
        return {"focus_count": n, "focus_ms": 0.5 * n}
    monkeypatch.setattr(chip_smoke, "device_profile", profile)
    monkeypatch.setattr(chip_smoke, "DEVICE_READINGS", [])
    counts[:] = [3, 57, 3, 60]              # 3 of 60 lost, then complete
    assert chip_smoke.per_launch_ms(torch, None, "attn_bwd") == 1.5
    counts[:] = [0, 0, 1, 19, 1, 19]        # never complete
    assert chip_smoke.per_launch_ms(torch, None, "rowhash_kernel") is None
    first, second = chip_smoke.DEVICE_READINGS
    assert (first["traces"], first["per_call"], first["complete"]) == (
        2, 3, True)
    assert (second["traces"], second["complete"]) == (3, False)
