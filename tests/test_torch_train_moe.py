"""Training the MoE and sliding-window configs: the port against the JAX
reference on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``: the MoE FFN's
gradients against ``jax.grad`` of the reference's dispatch/combine
einsums (gates renormalised over the top k, choices dropped past
capacity, the aux loss, chunks), the loss and every gradient leaf of
reduced phi3.5-moe and mixtral (MoE aux and a binding window together)
against ``jax.value_and_grad`` of the reference's ``loss_fn``, with and
without ``remat``, the trainer side by side (three steps, and a fault with
its rollback), checkpoint shards of an MoE state, AdamW's decay set and
the health probe on the MoE leaves, the parameter counts of every config,
the recorded and replayed routing, and the reference's ``--reduced`` CLI
fault, kept for parity.

Tolerances, float32: the MoE FFN's gradients rtol 1e-4 with an atol of
``MOE_GRAD_SCALE_TOL`` = 1e-4 times each leaf's largest gradient (the
largest gap read is 7.6e-5, top-1's router gradient: its gate p / p = 1
has a derivative that cancels to rounding, differently in each package;
every other leaf reads below 7e-7); whole models at
``test_torch_train.py``'s loss and gradient tolerances (the gradients'
largest gap read here, 1.3e-4 of a leaf's largest gradient, is phi3.5's at
64 tokens); remat against no remat bit for bit; the trainers' losses at
``TRAIN_RTOL``. Parameter counts, decay sets, shard blobs and routes are
compared exactly.
"""
import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import VcsCheckpointer as RCkpt
from repro.configs import all_arch_names as r_all_arch_names
from repro.configs import get_config as r_get_config
from repro.core import Engine as REngine
from repro.launch import train as r_train
from repro.models import layers as r_layers
from repro.models import lm as r_lm
from repro.optim import adamw as r_adamw
from repro_torch.checkpoint import VcsCheckpointer
from repro_torch.configs import all_arch_names, get_config
from repro_torch.core import Engine
from repro_torch.launch import train
from repro_torch.models import layers, routes
from repro_torch.models import lm as t_lm
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, params_to_numpy,
                                        stack_tree)
from repro_torch.models.lm import LM, loss_fn
from repro_torch.optim import AdamWCfg, OptState, init_opt_state
from test_torch_train import (GRAD_RTOL, GRAD_SCALE_TOL, LOSS_RTOL,
                              TRAIN_RTOL, _leaves_equal, _shard_rows, _t)

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "mixtral-8x7b")
MOE_GRAD_SCALE_TOL = 1e-4
#: the MoE FFN's sequence chunk in the model tests: S 32 and 64 run in
#: two and four chunks, so aux is a mean over chunks
SEQ_CHUNK = 16


# ------------------------------------------------------------ the MoE FFN

def _moe_inputs(seed, B, S, d, E, f):
    rng = np.random.default_rng(seed)
    params = {"router": rng.standard_normal((d, E)) * 0.5,
              "w1": rng.standard_normal((E, d, f)) / np.sqrt(d),
              "w3": rng.standard_normal((E, d, f)) / np.sqrt(d),
              "w2": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    dy = rng.standard_normal((B, S, d)).astype(np.float32)
    return params, x, dy


def _moe_grads(params, x, dy, aux_coef, **kw):
    """Gradients of sum(out * dy) + aux_coef * aux with respect to the
    params and x: (reference's, port's), numpy."""
    def r_loss(p, xx):
        out, aux = r_layers.moe_ffn(p, xx, **kw)
        return jnp.sum(out * dy) + aux_coef * aux
    r_p, r_x = jax.grad(r_loss, argnums=(0, 1))(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x))
    tp = {n: torch.from_numpy(a).requires_grad_() for n, a in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = layers.moe_ffn(tp, tx, **kw)
    ((out * torch.from_numpy(dy)).sum() + aux_coef * aux).backward()
    want = {**{n: np.asarray(a) for n, a in r_p.items()}, "x": np.asarray(r_x)}
    got = {**{n: t.grad.numpy() for n, t in tp.items()}, "x": tx.grad.numpy()}
    return want, got


# (B, S, E, top_k, capacity_factor, seq_chunk): phi3.5's and mixtral's
# routing at the reduced width, a tight capacity that drops, top-1, and
# chunks (30 at 8 takes the largest divisor, 6)
@pytest.mark.parametrize("B,S,E,k,cf,sc", [(2, 24, 4, 2, 1.25, 4096),
                                           (1, 40, 8, 2, 1.25, 4096),
                                           (2, 32, 4, 2, 0.5, 4096),
                                           (3, 16, 16, 1, 1.0, 4096),
                                           (2, 48, 8, 2, 1.25, 16),
                                           (2, 30, 8, 2, 1.25, 8)])
def test_moe_ffn_gradients_match_jax_grad(B, S, E, k, cf, sc):
    params, x, dy = _moe_inputs([B, S, E, k], B, S, 64, E, 32)
    want, got = _moe_grads(params, x, dy, 0.37, n_experts=E, top_k=k,
                           capacity_factor=cf, seq_chunk=sc)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=GRAD_RTOL,
                                   atol=MOE_GRAD_SCALE_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_a_dropped_token_has_no_gradient_through_the_experts():
    """At a capacity that drops, a token whose every choice is dropped
    gets an output of 0 and, without the aux term, no gradient at all, in
    both packages; a kept token gets one."""
    B, S, E, k, cf = 2, 32, 4, 2, 0.5
    params, x, dy = _moe_inputs(9, B, S, 64, E, 32)
    kw = dict(n_experts=E, top_k=k, capacity_factor=cf)
    C = layers.moe_capacity(S, E, k, cf)
    keep = layers.moe_route(torch.from_numpy(params["router"]),
                            torch.from_numpy(x), top_k=k, capacity=C).keep
    dropped = ~keep.any(-1)
    assert dropped.any() and keep.any()
    want, got = _moe_grads(params, x, dy, 0.0, **kw)
    for g in (want["x"], got["x"]):
        assert not g[dropped.numpy()].any()
        assert np.abs(g[keep.all(-1).numpy()]).sum(-1).min() > 0


def test_aux_carries_no_gradient_through_its_one_hot():
    """aux = E * sum(me * ce): ``ce`` counts top-1 choices (a one-hot, no
    gradient), so aux's gradient is E * ce . d(me), through the router's
    probabilities alone, in both packages."""
    params, x, _ = _moe_inputs(3, 2, 24, 64, 4, 32)
    kw = dict(n_experts=4, top_k=2, capacity_factor=1.25)
    want, got = _moe_grads(params, x, np.zeros_like(x), 1.0, **kw)
    for name in ("w1", "w3", "w2"):
        assert not want[name].any() and not got[name].any()
    for name in ("router", "x"):
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_RTOL,
                                   atol=MOE_GRAD_SCALE_TOL
                                   * np.abs(want[name]).max())
        assert np.abs(want[name]).max() > 0


# ------------------------------------------------------------ the models

def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(r_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        r_lm.init_params(rcfg, jax.random.PRNGKey(seed)))


@pytest.fixture
def chunked(monkeypatch):
    """Both packages' models run their MoE FFN in chunks of SEQ_CHUNK."""
    monkeypatch.setattr(r_lm, "moe_ffn", functools.partial(
        r_layers.moe_ffn, seq_chunk=SEQ_CHUNK))
    monkeypatch.setattr(t_lm, "moe_ffn", functools.partial(
        layers.moe_ffn, seq_chunk=SEQ_CHUNK))


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


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_every_gradient_match_the_reference(chunked, arch, S,
                                                         remat):
    rcfg, tcfg = _cfgs(arch)
    if rcfg.sliding_window:
        assert rcfg.sliding_window < S          # the window binds
    tree = _tree(rcfg)
    rng = np.random.default_rng([S, len(arch)])
    # move the norm scales off 1, so their gradients count
    for sp in tree["blocks"].values():
        for name in ("ln1", "ln2"):
            sp[name] = (1.0 + 0.1 * rng.standard_normal(sp[name].shape)
                        ).astype(np.float32)
    tokens, targets = _batch(rng, rcfg.vocab, S)
    r_loss, r_grads = jax.value_and_grad(
        lambda p: r_lm.loss_fn(rcfg, p, {"tokens": jnp.asarray(tokens),
                                         "targets": jnp.asarray(targets)},
                               attn_block=16, remat=remat))(
        jax.tree.map(jnp.asarray, tree))
    loss, grads = _port_loss_and_grads(tcfg, tree, tokens, targets, remat)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=LOSS_RTOL)
    got_tree = params_to_numpy(tcfg, grads)
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, r_grads))
    # embed, final_norm, lm_head and per slot ln1, ln2, wq, wk, wv, wo,
    # router, moe_w1, moe_w3, moe_w2
    assert len(leaves) == len(jax.tree_util.tree_leaves(got_tree)) == 13
    for path, w in leaves:
        got = got_tree
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE_TOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(got_tree["blocks"]["slot0"]["router"]).max() > 0


@pytest.mark.parametrize("arch", MOE_ARCHS + ("qwen1.5-0.5b",))
def test_remat_gives_the_same_bits(chunked, arch):
    rcfg, tcfg = _cfgs(arch)
    tree = _tree(rcfg, 1)
    tokens, targets = _batch(np.random.default_rng(2), rcfg.vocab, 48)
    loss, grads = _port_loss_and_grads(tcfg, tree, tokens, targets, False)
    loss_r, grads_r = _port_loss_and_grads(tcfg, tree, tokens, targets, True)
    assert torch.equal(loss, loss_r)
    assert grads.keys() == grads_r.keys()
    assert all(torch.equal(grads[n], grads_r[n]) for n in grads)


def test_remat_keeps_only_each_periods_input():
    """Under remat the forward keeps no layer's activations: the autograd
    graph holds only the embedding, each period's checkpoint and the
    head, so its saved tensors shrink."""
    _, tcfg = _cfgs("mixtral-8x7b")
    model = LM(dataclasses.replace(tcfg, n_layers=4), device="cpu")
    model.requires_grad_()
    tokens = torch.randint(0, tcfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(0))
    saved = {}
    for remat in (False, True):
        n = [0]

        def pack(t):
            n[0] += t.numel()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(tokens, attn_block=16, remat=remat)
        saved[remat] = n[0]
    assert saved[True] < saved[False] / 4


def test_train_step_with_remat_equals_train_step_without(chunked):
    """``train_step(remat=True)``: the loss, the metrics and the updated
    parameters and moments of one AdamW step equal those without remat,
    bit for bit."""
    _, tcfg = _cfgs("mixtral-8x7b")
    tokens, targets = _batch(np.random.default_rng(5), tcfg.vocab, 32)
    batch = {"tokens": _t(tokens).long(), "targets": _t(targets).long()}
    opt_cfg = AdamWCfg(warmup_steps=2, decay_steps=4)
    out = []
    for remat in (False, True):
        model = LM(tcfg, device="cpu")
        model.requires_grad_()
        live = dict(model.named_parameters())
        opt = init_opt_state(live, opt_cfg)
        opt, m = train.train_step(model, batch, opt, opt_cfg,
                                  train.decay_names(live), 16, remat=remat)
        out.append((m, live, opt))
    (m0, p0, o0), (m1, p1, o1) = out
    for key in ("loss", "grad_norm", "lr", "clip_scale"):
        assert torch.equal(m0[key], m1[key])
    for name in p0:
        assert torch.equal(p0[name], p1[name])
        assert torch.equal(o0.mu[name], o1.mu[name])
        assert torch.equal(o0.nu[name], o1.nu[name])


# ------------------------------------------------------------ routes

def test_replayed_routes_give_the_recording_runs_bits(chunked):
    """Replaying a run's own routes (a CPU step replays the card's in
    chip_smoke) changes no bit of the loss or the gradients, with or
    without remat, and a remat recompute routes as its forward did. The
    64 tokens route in four chunks of SEQ_CHUNK, each keyed by its layer
    and first position, also in remat's recompute."""
    _, tcfg = _cfgs("mixtral-8x7b")
    tcfg = dataclasses.replace(tcfg, n_layers=3)
    tokens = torch.randint(0, tcfg.vocab, (2, 65),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def step(ctx, remat):
        model = LM(tcfg, device="cpu")
        model.requires_grad_()
        with ctx:
            loss = loss_fn(model, batch, attn_block=16, remat=remat)
            loss.backward()
        return loss, [p.grad for p in model.parameters()]
    log = routes.RouteLog(64)
    want = step(routes.recorded(log), True)
    assert sorted(log.choices) == [(i, c) for i in range(tcfg.n_layers)
                                   for c in range(0, 64, SEQ_CHUNK)]
    assert log.recompute_flips == 0
    for ctx, remat in ((routes.replayed(log), True),
                       (routes.replayed(log), False),
                       (contextlib.nullcontext(), False)):
        loss, grads = step(ctx, remat)
        assert torch.equal(loss, want[0])
        assert all(torch.equal(a, b) for a, b in zip(grads, want[1]))


def test_replay_serves_another_models_choices_and_keeps_its_gradients():
    """A bf16 model replaying a float32 model's choices routes every token
    as the float32 one did; its gates and aux are its own (differentiable),
    so the router still gets a gradient."""
    _, tcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    tokens = torch.randint(0, tcfg.vocab, (1, 33),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    log, seen = routes.RouteLog(32), []
    with routes.recorded(log):
        loss_fn(LM(tcfg, device="cpu"), batch, attn_block=16)
    route = layers.moe_route

    def spy(router, x, **kw):
        r = route(router, x, **kw)
        seen.append(r.expert)
        return r
    model = LM(dataclasses.replace(tcfg, dtype="bfloat16"), device="cpu")
    model.requires_grad_()
    layers.moe_route = spy
    try:
        with routes.replayed(log):
            loss_fn(model, batch, attn_block=16).backward()
    finally:
        layers.moe_route = route
    assert [torch.equal(a, b) for a, b in zip(seen, log.choices.values())] \
        == [True] * len(log.choices)
    assert model.layers[0].router.grad.abs().max() > 0


# ------------------------------------------------------------ trainer

@contextlib.contextmanager
def _f32_reference(monkeypatch):
    """The reference's train_loop on the float32 reduced config."""
    orig = r_train.get_config
    monkeypatch.setattr(r_train, "get_config", lambda a: dataclasses.replace(
        orig(a), dtype="float32"))
    yield


def _both_loops(monkeypatch, arch, **kw):
    """One train_loop per package from the same float32 weights; returns
    ((losses, engine, printed) for the reference, then the port)."""
    rcfg, tcfg = _cfgs(arch)
    params = params_from_numpy(tcfg, _tree(rcfg))
    out = []
    with _f32_reference(monkeypatch):
        for run in (lambda: r_train.train_loop(arch, **kw),
                    lambda: train.train_loop(
                        dataclasses.replace(get_config(arch),
                                            dtype="float32"),
                        device="cpu", params=params, **kw)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, losses, engine = run()
            out.append((np.asarray(losses), engine, buf.getvalue()))
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_three_train_loop_steps_match_the_reference(monkeypatch, arch):
    (r_l, r_e, _), (t_l, t_e, _) = _both_loops(
        monkeypatch, arch, steps=3, seq_len=32, global_batch=4,
        ckpt_every=2, log_every=100)
    assert len(r_l) == len(t_l) == 3
    np.testing.assert_allclose(t_l, r_l, rtol=TRAIN_RTOL)
    assert sorted(t_e.snapshots) == sorted(r_e.snapshots)


def test_mixtral_trainer_with_a_fault_matches_the_reference(monkeypatch):
    """Reduced mixtral (MoE, window 16 binding at 32 tokens) through both
    trainers with a fault at step 5: the same rollback line and tags, the
    same losses, the same checkpoint shard rows' sizes."""
    (r_l, r_e, r_out), (t_l, t_e, t_out) = _both_loops(
        monkeypatch, "mixtral-8x7b", steps=8, seq_len=32, global_batch=4,
        ckpt_every=3, inject_fault_at=5, log_every=100)
    rolled = [ln for ln in t_out.splitlines() if "rolled back" in ln]
    assert rolled == [ln for ln in r_out.splitlines() if "rolled back" in ln]
    assert rolled == ["[train] fault detected @ 4: rolled back to "
                      "run1-step-3"]
    assert len(t_l) == len(r_l) == 9          # steps 4 and 5 run twice
    assert np.isfinite(t_l).all()
    np.testing.assert_allclose(t_l, r_l, rtol=TRAIN_RTOL)
    assert sorted(t_e.snapshots) == sorted(r_e.snapshots)
    r_rows = _shard_rows(r_e, "run1-step-6")
    t_rows = _shard_rows(t_e, "run1-step-6")
    assert len(t_rows) == len(r_rows) > 0
    assert t_rows[0] == r_rows[0]             # opt/.step, then the tensors
    assert [len(b) for b in t_rows] == [len(b) for b in r_rows]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_checkpoint_shards_equal_the_reference(monkeypatch, arch):
    """An MoE training state (bf16 params with the router and experts,
    float32 moments, the step) saved by both packages: the same layout
    and the same shard rows, restored bit for bit."""
    from repro.checkpoint import vcs_ckpt as r_vcs_ckpt
    from repro_torch.checkpoint import vcs_ckpt
    monkeypatch.setattr(r_vcs_ckpt, "SHARD_BYTES", 4096)
    monkeypatch.setattr(vcs_ckpt, "SHARD_BYTES", 4096)
    rcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = _tree(rcfg, 3)
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
    assert {"router", "moe_w1", "moe_w3", "moe_w2"} <= set(
        t_state["params"]["blocks"]["slot0"])
    r_e, t_e = REngine(), Engine(device="cpu")
    r_ck, t_ck = RCkpt(r_e), VcsCheckpointer(t_e)
    r_ck.save(r_state, 0)
    t_ck.save(t_state, 0)
    assert t_ck._layout == [(n, tuple(s), d, k)
                            for n, s, d, k in r_ck._layout]
    assert _shard_rows(t_e, "step-0") == _shard_rows(r_e, "step-0")
    like_t = jax.tree.map(torch.zeros_like, t_state)
    _leaves_equal(r_state, t_ck.restore("step-0", like_t))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decay_and_probe_on_the_moe_leaves_follow_the_reference(arch):
    """AdamW decays the reference's leaves of two or more dimensions on its
    stacked tree (the router (P, d, E) among them, the norms (P, d) too),
    and the health probe is the reference's global norm of each leaf's
    first slice."""
    from repro.optim.adamw import global_norm as r_global_norm
    rcfg, tcfg = _cfgs(arch)
    tree = _tree(rcfg, 4)
    model = LM(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(tcfg, tree))
    live = dict(model.named_parameters())
    decay = set(train.decay_names(live))
    want = {jax.tree_util.keystr(path) for path, a in
            jax.tree_util.tree_leaves_with_path(tree) if a.ndim >= 2}
    # each leaf marked 1 where decayed, in the reference's tree
    marks = params_to_numpy(tcfg, {n: torch.full(p.shape, float(n in decay))
                                   for n, p in live.items()})
    got = {jax.tree_util.keystr(path) for path, a in
           jax.tree_util.tree_leaves_with_path(marks) if a.all()}
    assert got == want
    assert any("router" in n for n in decay)
    assert all(n in decay for n in live if n.endswith((".moe_w1", ".moe_w3",
                                                       ".moe_w2")))
    r_probe = float(r_global_norm(jax.tree.map(lambda a: a[:1], tree)))
    # float32 sums of squares in another order: 2.8e-6 apart here
    np.testing.assert_allclose(float(train.probe_norm(tcfg, live)), r_probe,
                               rtol=LOSS_RTOL)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(set(all_arch_names())))
def test_parameter_counts_equal_the_reference(arch, reduced):
    assert arch in r_all_arch_names()
    r_cfg, t_cfg = r_get_config(arch), get_config(arch)
    if reduced:
        r_cfg, t_cfg = r_cfg.reduced(), t_cfg.reduced()
    assert t_cfg.n_params() == r_cfg.n_params()
    assert t_cfg.n_params_active() == r_cfg.n_params_active()
    if t_cfg.moe:
        assert t_cfg.n_params_active() < t_cfg.n_params()


def test_the_reduced_flag_cannot_be_turned_off_in_either_cli(monkeypatch):
    """Reference fault kept for parity (ROADMAP Queue 3): both train CLIs
    declare ``--reduced`` with ``action="store_true", default=True``, so
    ``main(["--arch", "mixtral-8x7b"])`` trains the reduced config and no
    flag reaches the published widths."""
    seen = []

    def fake(arch, **kw):
        seen.append((arch, kw["reduced"]))
        return None, [1.0], None
    monkeypatch.setattr(r_train, "train_loop", fake)
    monkeypatch.setattr(train, "train_loop", fake)
    for main in (r_train.main, lambda a: train.main(a + ["--device", "cpu"])):
        main(["--arch", "mixtral-8x7b"])
        main(["--arch", "mixtral-8x7b", "--reduced"])
        with pytest.raises(SystemExit):
            main(["--arch", "mixtral-8x7b", "--no-reduced"])
    assert seen == [("mixtral-8x7b", True)] * 4
