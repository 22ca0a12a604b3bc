"""The port's training path against the JAX reference on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``: AdamW, the loss
and its gradients, the trainer side by side (three steps, and a run with
an injected fault), the batch pipeline, the pinned corpus, checkpoint
layouts and shard blobs (and restores across the packages), rollback,
fork and ``changed_shards``, the manager's NaN rollback, and the example.

Tolerances, float32 (``cfg.dtype = "float32"``, as the reference's own
consistency tests run): ``apply_updates`` rtol 1e-6, each leaf with an
atol of 1e-6 times its largest magnitude (the same float32 arithmetic;
only pow, cos and the order of the global norm's sum may round
differently, and a moment whose two terms cancel turns an ulp of the
clip scale into a large relative error); the loss rtol 1e-5; every
gradient rtol 1e-4 with an atol of 1e-3 times the leaf's largest
gradient. An absolute floor of 1e-6 is below the two frameworks' float32
noise here: the gradients (at most 0.11, most near 5e-3) are what is
left of cross entropy near ln(vocab) after large cancellations, and the
gaps measured grow with depth from 4.6e-6 (final_norm) through 8.7e-6
(lm_head) to 1.1e-4 (embed) and 3.2e-4 (bk) of each leaf's largest
gradient, the same with one attention block as with two; the
forward is held at 2e-4 for float32 logits in test_torch_serve.py for
the same reason. The trainer's losses rtol 1e-4 (three optimizer steps
on those gradients). Batches, shard
blobs and restored tensors are compared bit for bit.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.checkpoint import VcsCheckpointer as RCkpt
from repro.checkpoint import vcs_ckpt as r_vcs_ckpt
from repro.configs import get_config as r_get_config
from repro.core import Engine as REngine
from repro.data import BatchPipeline as RPipe
from repro.data import PinnedDataset as RDataset
from repro.data import PipelineCfg as RPipeCfg
from repro.data import add_samples as r_add_samples
from repro.data import create_token_table as r_create
from repro.data import synth_corpus as r_synth
from repro.launch import train as r_train
from repro.models import lm as r_lm
from repro.optim import adamw as r_adamw
from repro_torch.checkpoint import CheckpointManager, VcsCheckpointer
from repro_torch.checkpoint import vcs_ckpt
from repro_torch.configs import get_config
from repro_torch.core import Engine
from repro_torch.data import (BatchPipeline, PinnedDataset, PipelineCfg,
                              add_samples, create_token_table, synth_corpus)
from repro_torch.examples import train_versioned
from repro_torch.launch import train
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, params_to_numpy,
                                        stack_tree)
from repro_torch.models.lm import LM, loss_fn
from repro_torch.optim import AdamWCfg, OptState, apply_updates

ARCH = "qwen1.5-0.5b"
OPT_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_SCALE_TOL = 1e-4, 1e-3
TRAIN_RTOL = 1e-4


def _cfgs(dtype="float32"):
    return (dataclasses.replace(r_get_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype))


def _tree(rcfg, seed=0):
    return jax.tree.map(np.asarray,
                        r_lm.init_params(rcfg, jax.random.PRNGKey(seed)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- optimizer

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("step", [3, 57])          # warmup, cosine decay
def test_apply_updates_matches_reference(dtype, clipped, step):
    rng = np.random.default_rng([step, clipped, len(dtype)])
    shapes = {"w": (2, 16, 24), "m": (24, 8), "b": (8,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = {n: (rng.standard_normal(s) * (3.0 if clipped else 0.01))
             .astype(np.float32) for n, s in shapes.items()}
    mu = {n: rng.standard_normal(s).astype(np.float32) * 0.01
          for n, s in shapes.items()}
    nu = {n: np.abs(rng.standard_normal(s)).astype(np.float32) * 1e-4
          for n, s in shapes.items()}
    cfg = AdamWCfg(warmup_steps=10, decay_steps=100)
    rcfg = r_adamw.AdamWCfg(warmup_steps=10, decay_steps=100)
    jdt = jnp.dtype(dtype)
    r_p, r_o, r_m = r_adamw.apply_updates(
        {n: jnp.asarray(a).astype(jdt) for n, a in params.items()},
        {n: jnp.asarray(a) for n, a in grads.items()},
        r_adamw.OptState(jnp.asarray(step - 1, jnp.int32),
                         {n: jnp.asarray(a) for n, a in mu.items()},
                         {n: jnp.asarray(a) for n, a in nu.items()}), rcfg)
    p = {n: _t(a).to(getattr(torch, dtype)) for n, a in params.items()}
    state = OptState(torch.tensor(step - 1, dtype=torch.int32),
                     {n: _t(a).clone() for n, a in mu.items()},
                     {n: _t(a).clone() for n, a in nu.items()})
    p, state, m = apply_updates(p, {n: _t(a) for n, a in grads.items()},
                                state, cfg)
    assert int(state.step) == int(r_o.step) == step
    assert float(r_m["clip_scale"]) < 1.0 if clipped else \
        float(r_m["clip_scale"]) == 1.0
    for key in ("lr", "grad_norm", "clip_scale"):
        np.testing.assert_allclose(float(m[key]), float(r_m[key]),
                                   rtol=OPT_RTOL)
    for n in shapes:
        for got, want in ((p[n].float(), r_p[n].astype(jnp.float32)),
                          (state.mu[n], r_o.mu[n]), (state.nu[n], r_o.nu[n])):
            want = np.asarray(want)
            # rtol of the leaf's scale: where b1 * m and (1 - b1) * g
            # cancel, an ulp of the clip scale is a large relative error
            np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL,
                                       atol=OPT_RTOL * np.abs(want).max())
        assert p[n].dtype == getattr(torch, dtype)


# ------------------------------------------------------------- loss

def _batch(rng, vocab, b=2, s=32):
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets = rng.integers(0, vocab, (b, s)).astype(np.int32)
    targets[0, -5:] = -1                               # masked targets
    return tokens, targets


def test_loss_and_gradients_match_reference():
    rcfg, tcfg = _cfgs()
    tree = _tree(rcfg)
    rng = np.random.default_rng(0)
    # move norm scales and biases off 1 and 0, so their gradients count
    for sp in tree["blocks"].values():
        for name, base in (("ln1", 1.0), ("ln2", 1.0), ("bq", 0.0),
                           ("bk", 0.0), ("bv", 0.0)):
            sp[name] = (base + 0.1 * rng.standard_normal(sp[name].shape)
                        ).astype(np.float32)
    tokens, targets = _batch(rng, rcfg.vocab)
    r_loss, r_grads = jax.value_and_grad(
        lambda p: r_lm.loss_fn(rcfg, p, {"tokens": jnp.asarray(tokens),
                                         "targets": jnp.asarray(targets)},
                               attn_block=16))(jax.tree.map(jnp.asarray,
                                                            tree))
    model = LM(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(tcfg, tree))
    model.requires_grad_()
    loss = loss_fn(model, {"tokens": _t(tokens).long(),
                           "targets": _t(targets).long()}, attn_block=16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=LOSS_RTOL)
    grads = params_to_numpy(tcfg, {n: p.grad for n, p in
                                   model.named_parameters()})
    want = jax.tree.map(np.asarray, r_grads)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(grads)) == 15
    for path, w in leaves:
        got = grads
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, w, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE_TOL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- trainer

@contextlib.contextmanager
def _f32_reference(monkeypatch):
    """The reference's train_loop on the float32 reduced config."""
    orig = r_train.get_config
    monkeypatch.setattr(r_train, "get_config", lambda a: dataclasses.replace(
        orig(a), dtype="float32"))
    yield


def _both_loops(monkeypatch, **kw):
    """One train_loop per package from the same float32 weights; returns
    ((losses, engine, printed) for the reference, then the port)."""
    rcfg, tcfg = _cfgs()
    params = params_from_numpy(tcfg, _tree(rcfg))
    out = []
    with _f32_reference(monkeypatch):
        for run in (lambda: r_train.train_loop(ARCH, **kw),
                    lambda: train.train_loop(
                        dataclasses.replace(get_config(ARCH),
                                            dtype="float32"),
                        device="cpu", params=params, **kw)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, losses, engine = run()
            out.append((np.asarray(losses), engine, buf.getvalue()))
    return out


def test_three_train_loop_steps_match_reference(monkeypatch):
    (r_l, r_e, _), (t_l, t_e, _) = _both_loops(
        monkeypatch, steps=3, seq_len=32, global_batch=4, ckpt_every=2,
        log_every=100)
    assert len(r_l) == len(t_l) == 3
    np.testing.assert_allclose(t_l, r_l, rtol=TRAIN_RTOL)
    assert sorted(t_e.snapshots) == sorted(r_e.snapshots)


def test_trainer_with_fault_matches_reference_side_by_side(monkeypatch):
    """The counterpart of test_checkpoint_data.py's trainer test with a
    fault, both packages: the same rollback step, tags and losses."""
    (r_l, r_e, r_out), (t_l, t_e, t_out) = _both_loops(
        monkeypatch, steps=8, seq_len=32, global_batch=4, ckpt_every=3,
        inject_fault_at=5, log_every=100)
    rolled = [ln for ln in t_out.splitlines() if "rolled back" in ln]
    assert rolled == [ln for ln in r_out.splitlines() if "rolled back" in ln]
    assert rolled == ["[train] fault detected @ 4: rolled back to "
                      "run1-step-3"]
    assert len(t_l) == len(r_l) == 9          # steps 4 and 5 run twice
    assert np.isfinite(t_l).all()
    np.testing.assert_allclose(t_l, r_l, rtol=TRAIN_RTOL)
    assert sorted(t_e.snapshots) == sorted(r_e.snapshots)
    # the checkpoint shards of the last tag: equal in both packages
    tag = "run1-step-6"
    r_rows = _shard_rows(r_e, tag)
    t_rows = _shard_rows(t_e, tag)
    assert len(t_rows) == len(r_rows) > 0
    assert t_rows[0] == r_rows[0]             # opt/.step, then the tensors
    assert [len(b) for b in t_rows] == [len(b) for b in r_rows]


def test_a_fault_that_repeats_raises_instead_of_looping(monkeypatch):
    calls = []
    orig = train.train_step

    def always_nan(model, batch, opt, *a):
        opt, m = orig(model, batch, opt, *a)
        calls.append(1)
        if len(calls) >= 3:
            m["loss"] = torch.tensor(float("nan"))
        return opt, m
    monkeypatch.setattr(train, "train_step", always_nan)
    with pytest.raises(RuntimeError, match="fault repeats"):
        train.train_loop(ARCH, steps=6, seq_len=16, global_batch=2,
                         ckpt_every=2, device="cpu", log_every=100)


def test_train_loop_wants_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_loop(ARCH, steps=1)


def test_train_cli_runs_on_the_cpu(capsys):
    train.main(["--arch", ARCH, "--steps", "3", "--seq-len", "16",
                "--batch", "2", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "first loss ")


# ------------------------------------------------------------- data

def _corpora(n=32, length=33, vocab=100):
    r_e, t_e = REngine(), Engine(device="cpu")
    r_create(r_e, "c")
    r_synth(r_e, "c", n_samples=n, sample_len=length, vocab=vocab)
    create_token_table(t_e, "c")
    synth_corpus(t_e, "c", n_samples=n, sample_len=length, vocab=vocab)
    return (r_e, RDataset(r_e, r_e.create_snapshot("pin", "c"))), \
        (t_e, PinnedDataset(t_e, t_e.create_snapshot("pin", "c")))


@pytest.mark.parametrize("hosts", [1, 4])
def test_pipeline_batches_equal_reference_bit_for_bit(hosts):
    (_, r_ds), (_, t_ds) = _corpora()
    assert np.array_equal(t_ds.sample_ids, r_ds.sample_ids)
    for i in range(hosts):
        r_p = RPipe(r_ds, RPipeCfg(seq_len=32, global_batch=8, seed=7,
                                   host_index=i, host_count=hosts))
        t_p = BatchPipeline(t_ds, PipelineCfg(seq_len=32, global_batch=8,
                                              seed=7, host_index=i,
                                              host_count=hosts))
        for step in (0, 3, 11):
            want, got = r_p.batch_at(step), t_p.batch_at(step)
            for key in ("tokens", "targets"):
                assert got[key].dtype == want[key].dtype
                assert np.array_equal(got[key], want[key])
            assert torch.equal(t_p.tensors_at(step, "cpu")["tokens"],
                               torch.from_numpy(want["tokens"]).long())


def test_pinned_snapshot_isolates_training_from_edits():
    (r_e, r_ds), (t_e, t_ds) = _corpora(n=16)
    for eng, add, ds_cls in ((r_e, r_add_samples, RDataset),
                             (t_e, add_samples, PinnedDataset)):
        add(eng, "c", np.arange(1000, 1010),
            [np.arange(33, dtype=np.uint32)] * 10)
    assert PinnedDataset(t_e, t_e.snapshots["pin"]).n == \
        RDataset(r_e, r_e.snapshots["pin"]).n == 16
    now = PinnedDataset(t_e, t_e.current_snapshot("c"))
    assert now.n == RDataset(r_e, r_e.current_snapshot("c")).n == 26
    assert np.array_equal(now.sample_tokens(20), np.arange(33))


# ------------------------------------------------------------- checkpoints

def _states(seed=0):
    """One training state in both packages: the reference's tree (bf16
    params, float32 moments with values, an int32 step) and the port's
    stacked tree of the same bits."""
    rcfg, tcfg = _cfgs("bfloat16")
    tree = _tree(rcfg, seed)
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    nu = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), tree)
    r_state = {"params": tree,
               "opt": r_adamw.OptState(np.asarray(seed + 5, np.int32), mu,
                                       nu)}
    opt = opt_state_from_numpy(tcfg, r_state["opt"])
    t_state = {"params": stack_tree(tcfg, params_from_numpy(tcfg, tree)),
               "opt": OptState(opt.step, stack_tree(tcfg, opt.mu),
                               stack_tree(tcfg, opt.nu))}
    return r_state, t_state


def _shard_rows(engine, tag, table="ckpt"):
    snap = engine.snapshots[tag]
    batch, _ = engine.table(table).scan(snap.directory)
    ids = np.asarray(batch["shard_id"]) if not torch.is_tensor(
        batch["shard_id"]) else batch["shard_id"].numpy()
    return [bytes(batch["data"][i]) for i in np.argsort(ids, kind="stable")]


def _leaves_equal(r_tree, t_tree):
    r_leaves = r_vcs_ckpt._flatten_state(r_tree)
    t_leaves = vcs_ckpt._flatten_state(t_tree)
    assert [n for n, _ in r_leaves] == [n for n, _ in t_leaves]
    for (_, a), (_, b) in zip(r_leaves, t_leaves):
        assert b.shape == a.shape
        assert b.reshape(-1).view(torch.uint8).numpy().tobytes() == \
            np.ascontiguousarray(a).tobytes()


@pytest.fixture
def small_shards(monkeypatch):
    """1 KiB shards in both packages, so every matrix spans many."""
    monkeypatch.setattr(r_vcs_ckpt, "SHARD_BYTES", 1024)
    monkeypatch.setattr(vcs_ckpt, "SHARD_BYTES", 1024)


def test_checkpoint_layout_and_shards_equal_and_restore_across(small_shards):
    r_state, t_state = _states()
    r_e, t_e = REngine(), Engine(device="cpu")
    r_ck, t_ck = RCkpt(r_e), VcsCheckpointer(t_e)
    r_ck.save(r_state, 0)
    t_ck.save(t_state, 0)
    assert t_ck._layout == [(n, tuple(s), d, k)
                            for n, s, d, k in r_ck._layout]
    assert any(k > 1 for *_, k in t_ck._layout)
    assert _shard_rows(t_e, "step-0") == _shard_rows(r_e, "step-0")
    # restore in the same package, then across both ways: each reads the
    # other's shard rows, copied into a table of its own
    like_t = jax.tree.map(torch.zeros_like, t_state)
    _leaves_equal(r_state, t_ck.restore("step-0", like_t))
    rows = _shard_rows(r_e, "step-0")
    t_e.create_table("from_ref", vcs_ckpt.CKPT_SCHEMA)
    t_e.insert("from_ref", {"shard_id": np.arange(len(rows)), "data": rows})
    t_e.create_snapshot("ref-0", "from_ref")
    got = VcsCheckpointer(t_e, "from_ref").restore("ref-0", like_t)
    _leaves_equal(r_state, got)
    rows = _shard_rows(t_e, "step-0")
    r_e.create_table("from_port", r_vcs_ckpt.CKPT_SCHEMA)
    r_e.insert("from_port", {"shard_id": np.arange(len(rows)),
                             "data": rows})
    r_e.create_snapshot("port-0", "from_port")
    got = RCkpt(r_e, "from_port").restore(
        "port-0", jax.tree.map(np.zeros_like, r_state))
    _leaves_equal(got, t_state)


def test_rollback_fork_and_changed_shards_equal_reference(small_shards):
    (r0, t0), (r1, t1) = _states(0), _states(1)
    # the second state changes only the step
    r1 = {"params": r0["params"], "opt": r0["opt"]._replace(step=r1["opt"]
                                                            .step)}
    t1 = {"params": t0["params"], "opt": t0["opt"]._replace(step=t1["opt"]
                                                            .step)}
    r_e, t_e = REngine(), Engine(device="cpu")
    r_ck, t_ck = RCkpt(r_e), VcsCheckpointer(t_e)
    for ck, s0, s1 in ((r_ck, r0, r1), (t_ck, t0, t1)):
        ck.save(s0, 0)
        ck.save(s1, 1)
    assert t_ck.changed_shards("step-0", "step-1") == \
        r_ck.changed_shards("step-0", "step-1") == 2
    # opt/.step's shard only: its old row out, its new row in
    like_t = jax.tree.map(torch.zeros_like, t0)
    t_ck.rollback("step-0")
    r_ck.rollback("step-0")
    got = t_ck.restore(t_e.current_snapshot("ckpt"), like_t)
    _leaves_equal(r0, got)
    assert _shard_rows(t_e, "step-0") == _shard_rows(r_e, "step-0")
    fork = t_ck.fork("ckpt_ft", "step-1")
    r_ck.fork("ckpt_ft", "step-1")
    _leaves_equal(r1, fork.restore(t_e.current_snapshot("ckpt_ft"), like_t))
    assert t_e.table("ckpt_ft").count() == r_e.table("ckpt_ft").count()


def test_manager_nan_rollback():
    t_e, r_e = Engine(device="cpu"), REngine()
    r_state, t_state = _states()
    cm, r_cm = CheckpointManager(t_e, every=1, keep=2), \
        RManager(r_e, every=1, keep=2)
    cm.maybe_save(t_state, 0)
    r_cm.maybe_save(r_state, 0)
    assert not cm.healthy(float("nan")) and not cm.healthy(
        torch.tensor(1.0), torch.tensor(float("inf")))
    assert cm.healthy(torch.tensor(2.5))
    bad = jax.tree.map(lambda a: a * float("nan"), t_state)
    _leaves_equal(r_state, cm.recover(bad))
    assert cm.last_tag == r_cm.last_tag == "step-0"
    for step in (1, 2, 3):
        cm.maybe_save(t_state, step)
        r_cm.maybe_save(r_state, step)
    assert cm.tags == r_cm.tags == ["step-2", "step-3"]
    assert sorted(t_e.snapshots) == sorted(r_e.snapshots)


# ------------------------------------------------------------- example

def test_example_runs_on_the_cpu(capsys):
    train_versioned.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "rolled back to run1-step-20" in out
    assert "phase 2: review diff = 64 new/changed samples" in out
    assert "phase 2: merged 64 curated samples" in out
    assert out.rstrip().endswith("versioned data + versioned checkpoints, "
                                 "one engine.")
