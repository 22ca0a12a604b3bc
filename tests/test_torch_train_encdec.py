"""Training the encoder-decoder and cross-attention configs: the port
against the JAX reference on the CPU, through the reference's own train
step (``launch/steps.py``'s ``make_train_step`` and ``input_specs``,
``distributed/collectives.py``).

The reduced configs of both packages (whisper-medium: 2 encoder and 2
decoder layers; llama-3.2-vision-90b: 2 periods of a cross layer and four
attention layers), in float32, take the reference's ``init_params``
through ``models.convert`` with the norms drawn off one and whisper's
encoder ``w3`` and ``enc_pos`` drawn apart from ``w1`` and ``pos``
(``test_torch_crossattn._nudged``), so that every leaf's gradient
counts; for the gradients and the step, their query matrices are scaled
so that the attention scores sit near one standard deviation
(``_weights`` says why). Tokens, targets (some masked) and the context (frame or patch
embeddings) come from numpy generators, at ``ShapeCfg("t", 64, 4,
"train")``: whisper 64 frames and min(448, 64) tokens, llama-vision 64
tokens over its 8 patches.

Held: the loss with a context (the port once dropped it); every gradient
leaf against ``jax.value_and_grad``; remat against none bit for bit;
``collectives.py`` against the reference on the same numpy trees (the
bf16 cast bit for bit; accumulation at the reference test's tolerances,
and the port's float32 carry bit for bit against the sum it must be);
``ShapeCfg``, ``pick_microbatches`` and ``input_specs`` for every
registered config and every shape of the reference's ``LM_SHAPES``; the
whole step against the reference's ``make_train_step`` on a one-device
mesh under ``jax.set_mesh``, each config with one and two microbatches
and with ``grad_compress_bf16`` off and on (each pairing once: one
reference compile, ~17 s here, each);
the health probe's encoder rows; and ``chip_smoke``'s model FLOPs,
launch counts, rows and query scale for these configs.

Tolerances are ``test_torch_train.py``'s: the loss ``LOSS_RTOL``; each
gradient ``GRAD_RTOL`` with an atol of ``GRAD_SCALE_TOL`` times the
leaf's largest gradient; after a step, each parameter ``TRAIN_RTOL`` with
an atol of ``TRAIN_RTOL`` times the leaf's largest magnitude (but where
its gradient is within that atol of zero: ``_close_params``), the first
moment at the gradients' tolerances (it is 0.1 x the clipped gradient)
and the second at twice them (a square doubles a relative error); under
``grad_compress_bf16`` the moments' relative tolerance is one bf16
rounding step, 2^-7, where the gradients are rounded to bf16 first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from repro.configs import all_arch_names as r_all_arch_names
from repro.configs import base as r_base
from repro.configs import get_config as r_get_config
from repro.distributed import collectives as r_coll
from repro.distributed import sharding as r_sharding
from repro.launch import steps as r_steps
from repro.models import lm as r_lm
from repro.optim import adamw as r_adamw
from repro_torch.configs import (ShapeCfg, all_arch_names, get_config,
                                 period_slots)
from repro_torch.distributed import collectives
from repro_torch.models import lm
from repro_torch.launch import steps, train
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.lm import LM, loss_fn
from repro_torch.optim import AdamWCfg
from test_torch_crossattn import _nudged
from test_torch_hybrid import _dehashed
from test_torch_train import (GRAD_RTOL, GRAD_SCALE_TOL, LOSS_RTOL,
                              TRAIN_RTOL, _t)

ARCHS = ("whisper-medium", "llama-3.2-vision-90b")
SHAPE = (64, 4)                      # ShapeCfg seq_len, global_batch
ATTN_BLOCK = 32
#: the train steps' AdamW: warmup 2, so the first step's rate (1.5e-4)
#: moves each parameter past TRAIN_RTOL of its size
OPT = dict(warmup_steps=2, decay_steps=10)
#: one bf16 rounding step, relative to the value rounded: at most 2^-7
#: (7 stored mantissa bits)
BF16_STEP = 2.0 ** -7
#: (arch, n_micro, grad_compress_bf16): each config with one and two
#: microbatches, and with the bf16 cast off and on
STEP_CASES = [("whisper-medium", 1, False), ("whisper-medium", 2, True),
              ("llama-3.2-vision-90b", 2, False),
              ("llama-3.2-vision-90b", 1, True)]


def _cfgs(arch):
    return (dataclasses.replace(r_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(),
                                dtype="float32"))


def _shape():
    seq, batch = SHAPE
    return ShapeCfg("t", seq, batch, "train")


def _batch(cfg, seed=0):
    """Numpy tokens, targets (the last 5 of row 0 masked) and context at
    ``input_specs``' shapes for SHAPE."""
    specs = steps.input_specs(cfg, _shape())["batch"]
    rng = np.random.default_rng(seed)
    b, s = specs["tokens"].shape
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "ctx": rng.standard_normal(tuple(specs["ctx"].shape))
           .astype(np.float32)}
    out["targets"][0, -5:] = -1
    return out


def _t_batch(batch):
    return {k: _t(v).long() if v.dtype == np.int32 else _t(v)
            for k, v in batch.items()}


def _weights(rcfg, seed, unit_scores=True):
    """The reference's float32 weights, nudged (``_nudged``), rwkv's
    w_r, w_k, w_v and w_g drawn from numpy at the reference's scale
    (``test_torch_hybrid._dehashed``: the reference draws each from
    ``ks[hash(name) % 20]``, and Python salts ``hash`` per process, ROADMAP
    Queue 3; so the same bits in every process), with every
    query matrix (``wq``, the cross sublayer's ``xq``) scaled by P / d,
    P the stacked axis the reference draws it over (the periods, or the
    encoder's layers): the scores' standard deviation, d / P = 32 at the
    reduced configs' d 64 and P 2, goes to one (``chip_smoke.unit_scores``
    does the same at the published widths). At 32 deviations, with
    whisper's encoder queries equal to its keys (the reference draws wq
    and wk from one key), each softmax row is nearly one-hot and the
    backward's P (dP - D) cancels: two correct backwards, the port's from
    the saved LSE and the reference's autodiff through its blocks, then
    part by up to 2.0e-3 of a leaf's largest float32 gradient (whisper's
    ``xq``; llama-vision 3.1e-4), where the reference against itself at
    other attention blocks reads 7e-5. With the queries scaled they agree
    within 4.6e-6 and 8.5e-6 (the reference against itself 1-2.5e-6)."""
    tree = _nudged(jax.tree.map(np.asarray, _dehashed(
        r_lm.init_params(rcfg, jax.random.PRNGKey(seed)), seed)))
    if unit_scores:
        for sp, n in [(sp, rcfg.n_periods) for sp in tree["blocks"].values()]\
                + [(tree.get("encoder", {}), rcfg.encoder_layers)]:
            for name in ("wq", "xq"):
                if name in sp:
                    sp[name] = sp[name] * np.float32(n / rcfg.d_model)
    return tree


def _model(cfg, tree):
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_numpy(cfg, tree))
    return model


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _close_trees(got, want, rtol, scale, what):
    """Every leaf of ``want`` (numpy) within rtol and ``scale`` x its
    largest magnitude of ``got``'s leaf at the same path."""
    leaves = list(_leaf_paths(want))
    assert len(leaves) == len(list(_leaf_paths(got)))
    for path, w in leaves:
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            np.asarray(_at(got, path), np.float32), w, rtol=rtol,
            atol=scale * np.abs(w).max(), err_msg=f"{what} {path}")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One config in both packages, its numpy weights and batch, and the
    reference's loss and gradients on them (jitted once)."""
    arch = request.param
    rcfg, tcfg = _cfgs(arch)
    tree = _weights(rcfg, 0)
    batch = _batch(tcfg)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: r_lm.loss_fn(rcfg, p, b, attn_block=ATTN_BLOCK)))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return {"arch": arch, "rcfg": rcfg, "tcfg": tcfg, "tree": tree,
            "batch": batch, "r_loss": float(r_loss),
            "r_grads": jax.tree.map(np.asarray, r_grads)}


# ------------------------------------------------------------- the loss

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_a_context_matches_the_reference(arch):
    """The port's loss_fn passes the batch's context to the forward, as
    the reference's does (``batch.get("ctx")``): before, it dropped it and
    the forward raised ValueError where the reference returns a number.
    On the reference's weights as its init draws them (nudged, the
    queries not scaled) and on numpy tokens and context."""
    rcfg, tcfg = _cfgs(arch)
    tree = _weights(rcfg, 0, unit_scores=False)
    batch = _batch(tcfg)
    want = float(r_lm.loss_fn(rcfg, jax.tree.map(jnp.asarray, tree),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              attn_block=ATTN_BLOCK))
    with torch.no_grad():
        got = loss_fn(_model(tcfg, tree), _t_batch(batch),
                      attn_block=ATTN_BLOCK)
    assert np.isfinite(want)
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)


def test_a_batch_without_a_context_keeps_its_behaviour(case):
    """Without ``ctx`` a config that needs one still raises, as before;
    a config without cross slots reads no context."""
    model = _model(case["tcfg"], case["tree"])
    batch = _t_batch(case["batch"])
    del batch["ctx"]
    with pytest.raises(ValueError, match="needs a context"):
        loss_fn(model, batch)
    dense = LM(dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                                   dtype="float32"), device="cpu")
    with torch.no_grad():
        assert torch.equal(loss_fn(dense, batch),
                           loss_fn(dense, {**batch, "ctx": None}))


def test_every_gradient_leaf_matches_the_reference(case):
    """Every leaf of the reference's tree against ``jax.value_and_grad``:
    the encoder's, ``enc_pos``, ``enc_norm`` and ``pos``, whisper's cross
    sublayer (``ln_x``, ``xq``..``xo``), llama-vision's cross ``wk`` and
    ``wv`` among them, each with a gradient that is not zero."""
    model = _model(case["tcfg"], case["tree"])
    model.requires_grad_()
    loss = loss_fn(model, _t_batch(case["batch"]), attn_block=ATTN_BLOCK)
    loss.backward()
    np.testing.assert_allclose(loss.item(), case["r_loss"], rtol=LOSS_RTOL)
    got = params_to_numpy(case["tcfg"], {n: p.grad for n, p in
                                         model.named_parameters()})
    want = case["r_grads"]
    _close_trees(got, want, GRAD_RTOL, GRAD_SCALE_TOL, "gradient")
    named = {"whisper-medium": [
        ("encoder", n) for n in ("wq", "wk", "wv", "wo", "w1", "w2", "w3",
                                 "ln1", "ln2")]
        + [("enc_pos",), ("enc_norm",), ("pos",)]
        + [("blocks", "slot0", n) for n in ("ln_x", "xq", "xk", "xv",
                                            "xo")],
        "llama-3.2-vision-90b": [("blocks", "slot0", n)
                                 for n in ("wq", "wk", "wv", "wo")]}
    for path in named[case["arch"]]:
        assert np.abs(_at(want, path)).max() > 0, path
        assert np.abs(_at(got, path)).max() > 0, path


def test_remat_gives_the_same_bits(case):
    """``remat`` recomputes each decoder period in the backward (the
    encoder runs once, as in the reference): the same loss and gradients,
    bit for bit."""
    out = []
    for remat in (False, True):
        model = _model(case["tcfg"], case["tree"])
        model.requires_grad_()
        loss = loss_fn(model, _t_batch(case["batch"]), attn_block=ATTN_BLOCK,
                       remat=remat)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1].keys() == out[1][1].keys()
    assert all(torch.equal(out[0][1][n], out[1][1][n]) for n in out[0][1])


# ------------------------------------------------------------- collectives

def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((16, 24)) * 3e-3,
            "b": rng.standard_normal((24,)) * 40.0,
            "zero": np.zeros((3, 5))}
    return {k: v.astype(dtype) for k, v in tree.items()}


def _bits(x):
    x = x.detach().cpu()
    return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
        else x.numpy()


def _r_bits(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_compress_bf16_matches_the_reference_bit_for_bit():
    tree = _tree(0)
    got = collectives.compress_bf16({k: _t(v) for k, v in tree.items()})
    want = r_coll.compress_bf16({k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got[k]), _r_bits(want[k]))


def _linear_loss_pair():
    """The reference test's loss in both packages: mean((x w - y)^2)."""
    def t_loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def r_loss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 4)).astype(np.float32)
    return t_loss, r_loss, w, x, y


def test_accumulate_microbatches_matches_the_reference():
    """Four microbatches of the reference test's regression: the mean
    loss and gradient against the reference's scan, and against the
    full batch's (the reference's test, rtol 1e-6 and 1e-5)."""
    t_loss, r_loss, w, x, y = _linear_loss_pair()
    p = {"w": _t(w).requires_grad_()}
    mbs = {"x": _t(x).reshape(4, 4, 8), "y": _t(y).reshape(4, 4, 4)}
    loss, grads = collectives.accumulate_microbatches(t_loss, p, mbs)
    r_l, r_g = r_coll.accumulate_microbatches(
        r_loss, {"w": jnp.asarray(w)},
        {"x": jnp.asarray(x).reshape(4, 4, 8),
         "y": jnp.asarray(y).reshape(4, 4, 4)})
    assert loss.dtype == grads["w"].dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(r_l), rtol=1e-6)
    np.testing.assert_allclose(grads["w"].numpy(), np.asarray(r_g["w"]),
                               rtol=1e-5, atol=1e-7)
    full = t_loss(p, {"x": _t(x), "y": _t(y)})
    full_g, = torch.autograd.grad(full, [p["w"]])
    np.testing.assert_allclose(loss.item(), full.item(), rtol=1e-6)
    np.testing.assert_allclose(grads["w"].numpy(), full_g.numpy(), rtol=1e-5)


def test_accumulate_microbatches_carries_float32_over_bf16_params():
    """Over bf16 parameters each microbatch's gradient is cast to float32
    and added to a float32 sum from zero, in order, then times 1 /
    n_micro: bit for bit that sum, where autograd's ``.grad`` would have
    summed in bf16. A parameter the loss does not reach gets zeros."""
    t_loss, _, w, x, y = _linear_loss_pair()
    p = {"w": _t(w).bfloat16().requires_grad_(),
         "unused": torch.ones(3, dtype=torch.bfloat16, requires_grad=True)}
    xb, yb = _t(x).bfloat16(), _t(y).bfloat16()
    mbs = {"x": xb.reshape(2, 8, 8), "y": yb.reshape(2, 8, 4)}
    loss, grads = collectives.accumulate_microbatches(t_loss, p, mbs)
    parts = [torch.autograd.grad(t_loss(p, {"x": xb[i:i + 8],
                                            "y": yb[i:i + 8]}), [p["w"]])[0]
             for i in (0, 8)]
    want = (torch.zeros(8, 4) + parts[0].float() + parts[1].float()) * 0.5
    assert grads["w"].dtype == torch.float32
    assert torch.equal(grads["w"], want)
    assert torch.equal(grads["unused"], torch.zeros(3))
    autograd_sum = (parts[0] + parts[1]) * 0.5          # bf16 all the way
    assert not torch.equal(grads["w"], autograd_sum.float())


# ------------------------------------------------------------- the shapes

def test_the_shape_config_is_the_reference_s():
    """``ShapeCfg`` copies the reference's fields, and the registries
    name the same configs."""
    assert [f.name for f in dataclasses.fields(ShapeCfg)] == \
        [f.name for f in dataclasses.fields(r_base.ShapeCfg)]
    assert all_arch_names() == r_all_arch_names()


@pytest.mark.parametrize("arch", all_arch_names())
@pytest.mark.parametrize("shape", list(r_base.LM_SHAPES))
def test_microbatches_and_input_specs_match_the_reference(arch, shape):
    """``pick_microbatches`` and every step input's shape and dtype
    against the reference's on a one-device CPU mesh: the batch (with the
    context of a cross or encoder-decoder config), the prefill's tokens
    and context, the decode token and every cache leaf (the cross K/V at
    the context's length)."""
    mesh = _mesh()
    rcfg, tcfg = r_get_config(arch), get_config(arch)
    rs = r_base.LM_SHAPES[shape]
    ts = ShapeCfg(*dataclasses.astuple(rs))
    assert steps.pick_microbatches(tcfg, ts) == \
        r_steps.pick_microbatches(rcfg, rs, mesh)
    want, _ = r_steps.input_specs(rcfg, rs, mesh)
    got = steps.input_specs(tcfg, ts)
    flat = [(p, v) for p, v in _leaf_paths(want) if p != ("cache", "len")]
    assert sorted(p for p, _ in flat) == sorted(
        p for p, v in _leaf_paths(got) if p != ("cache", "len"))
    for path, w in flat:
        g = _at(got, path)
        if isinstance(g, tuple):          # an SSM slot's (P, ...) pair
            w = jax.tree_util.tree_leaves(w)
            assert [tuple(x.shape) for x in g] == [x.shape for x in w]
            assert [str(x.dtype).split(".")[-1] for x in g] == \
                [str(x.dtype) for x in w]
            continue
        assert g.device.type == "meta", path
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path


# ------------------------------------------------------------- the step

@pytest.fixture(scope="module")
def step_weights():
    """Each config's float32 numpy weights and a batch of SHAPE."""
    out = {}
    for arch in ARCHS:
        rcfg, tcfg = _cfgs(arch)
        out[arch] = (rcfg, tcfg, _weights(rcfg, 1), _batch(tcfg, seed=1))
    return out


def _close_params(got, want, before, mu, lr):
    """The parameters after one AdamW step, leaf by leaf, at TRAIN_RTOL
    with an atol of TRAIN_RTOL x the leaf's largest magnitude. A first
    step moves each element by lr x g / (|g| + eps) (and the decay): by
    about lr whatever the gradient's size, in its sign. Where the
    reference's first moment is not zero but within the gradients' own
    atol of it (GRAD_SCALE_TOL x its leaf's largest), the two packages'
    gradients may take either sign, so those elements (1.7-1.8% of them
    here; the test requires under 5%) are held to their step of at most
    lr each way: within 2 lr of each other, and within lr of where they
    started (plus the decay's move). An element that the reference does
    not move but by its decay (a zero gradient) is held strictly."""
    n_noise = n_all = 0
    for path, w in _leaf_paths(want):
        w, g = np.asarray(w, np.float32), np.asarray(_at(got, path))
        m = np.abs(np.asarray(_at(mu, path)))
        noise = (m > 0) & (m <= GRAD_SCALE_TOL * m.max())
        tol = TRAIN_RTOL * np.abs(w) + TRAIN_RTOL * np.abs(w).max()
        assert (np.abs(g - w) <= tol)[~noise].all(), path
        assert (np.abs(g - w) <= 2 * lr + tol)[noise].all(), path
        moved = np.abs(g - np.asarray(_at(before, path), np.float32))
        assert (moved <= lr * (1 + 0.1 * np.abs(w)) + tol)[noise].all(), path
        n_noise, n_all = n_noise + noise.sum(), n_all + noise.size
    assert n_noise < 0.05 * n_all


@pytest.mark.parametrize("arch,n_micro,compress", STEP_CASES)
def test_the_train_step_matches_the_reference(step_weights, arch, n_micro,
                                              compress):
    """One step of the port's ``make_train_step`` against one of the
    reference's (jitted, on a one-device mesh under ``jax.set_mesh``):
    the loss, the gradient norm and the step's rate, then every parameter
    (``_close_params``), both AdamW moments and the step count."""
    rcfg, tcfg, tree, batch = step_weights[arch]
    shape = _shape()
    r_shape = r_base.ShapeCfg(*dataclasses.astuple(shape))
    opt_cfg, r_opt_cfg = AdamWCfg(**OPT), r_adamw.AdamWCfg(**OPT)
    mesh = _mesh()
    with jax.set_mesh(mesh):
        r_step, _, _ = r_steps.make_train_step(
            rcfg, r_shape, mesh,
            sc=r_sharding.ShardCfg(grad_compress_bf16=compress),
            opt_cfg=r_opt_cfg, n_micro=n_micro, attn_block=ATTN_BLOCK)
        params = jax.tree.map(jnp.asarray, tree)
        r_state, r_m = r_step(
            {"params": params,
             "opt": r_adamw.init_opt_state(params, r_opt_cfg)},
            {k: jnp.asarray(v) for k, v in batch.items()})
    step = steps.make_train_step(
        tcfg, shape, grad_compress_bf16=compress,
        opt_cfg=opt_cfg, n_micro=n_micro, attn_block=ATTN_BLOCK,
        device="cpu")
    state, m = step(steps.init_state(_model(tcfg, tree), opt_cfg),
                    _t_batch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(r_m["grad_norm"]),
                               rtol=GRAD_RTOL)
    assert float(m["lr"]) == float(r_m["lr"]) > 0
    r_state = jax.tree.map(np.asarray, r_state)
    assert int(state["opt"].step) == int(r_state["opt"].step) == 1
    # under the bf16 cast, a gradient that the packages' float32 noise
    # puts on either side of a bf16 rounding boundary rounds to neighbours
    # one bf16 step apart
    rtol = max(GRAD_RTOL, BF16_STEP if compress else 0.0)
    _close_trees(params_to_numpy(tcfg, state["opt"].mu), r_state["opt"].mu,
                 rtol, GRAD_SCALE_TOL, "mu")
    _close_trees(params_to_numpy(tcfg, state["opt"].nu), r_state["opt"].nu,
                 2 * rtol, 2 * GRAD_SCALE_TOL, "nu")
    _close_params(params_to_numpy(tcfg, state["params"]), r_state["params"],
                  tree, r_state["opt"].mu, float(r_m["lr"]))


def test_the_train_step_wants_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.make_train_step(get_config("whisper-medium").reduced(),
                              _shape())
    cfg = get_config("whisper-medium").reduced()
    step = steps.make_train_step(cfg, _shape(), device="cpu")
    state = steps.init_state(LM(cfg, device="cpu"))
    state["model"].to("meta")
    with pytest.raises(ValueError, match="the step on cpu"):
        step(state, {})


def test_init_cache_wants_the_card_unless_asked_for_the_cpu():
    """``init_cache`` of a config, as the other entry points: no device
    means the card, and without one it raises; the CPU and ``meta`` when
    asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("whisper-medium").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 8, 4)
    for dev in ("cpu", "meta"):
        cache = lm.init_cache(cfg, 1, 8, 4, device=dev)
        assert cache["slot0"]["xk"].device.type == dev
        assert tuple(cache["slot0"]["xk"].shape) == \
            (cfg.n_periods, 1, 4, cfg.n_kv_heads, cfg.hd)


# ------------------------------------------------------------- the probe

def test_probe_reads_the_first_encoder_layer_as_the_reference_does():
    """The trainer's health probe takes row 0 of every stacked leaf, as
    the reference's ``a[:1]``: the first period's layers and the first
    encoder layer. A whisper-shaped config with a period of 2 shows it:
    keying the encoder by the period would read its second layer too."""
    rcfg, tcfg = _cfgs("whisper-medium")
    cut = dict(n_layers=4, period=2, slots=("attn", "attn"))
    rcfg, tcfg = (dataclasses.replace(c, **cut) for c in (rcfg, tcfg))
    tree = _nudged(jax.tree.map(
        np.asarray, r_lm.init_params(rcfg, jax.random.PRNGKey(3))))
    want = float(r_adamw.global_norm(jax.tree.map(
        lambda a: a[:1], jax.tree.map(jnp.asarray, tree))))
    params = params_from_numpy(tcfg, tree)
    got = float(train.probe_norm(tcfg, params))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    by_period = float(torch.sqrt(
        train.probe_norm(tcfg, params) ** 2 + sum(
            torch.sum(p.float() ** 2) for n, p in params.items()
            if n.startswith("encoder.1."))))
    assert abs(by_period - want) > 1e-3 * want


# ------------------------------------------------------------- chip_smoke

def test_chip_smoke_trains_the_context_configs_it_names():
    """train_models' rows: whisper-medium whole at 16 x 1,500 frames
    (448 tokens, two microbatches) and llama-3.2-vision-90b's slots 0 and
    1 at 1 x 2,048 over 6,404 patches (one microbatch), with the
    parameters and FLOPs the PERF.md estimates name."""
    rows = {arch: (cut, b, s) for arch, cut, b, s in chip_smoke.TRAIN_MODELS}
    assert rows["whisper-medium"] == (None, 16, 1500)
    assert rows["llama-3.2-vision-90b"] == ((0, 1), 1, 2048)
    whisper = get_config("whisper-medium")
    llama = period_slots(get_config("llama-3.2-vision-90b"), (0, 1))
    assert chip_smoke.train_cut(get_config("llama-3.2-vision-90b"),
                                (0, 1)) == llama
    assert chip_smoke.param_count(whisper) == 1_146_531_840
    assert chip_smoke.param_count(llama) == 3_812_663_296
    for cfg, (b, s), want in ((whisper, (16, 1500), (448, 1500, 2)),
                              (llama, (1, 2048), (2048, 6404, 1))):
        shape = ShapeCfg("t", s, b, "train")
        specs = steps.input_specs(cfg, shape)["batch"]
        assert (specs["tokens"].shape[1], specs["ctx"].shape[1],
                steps.pick_microbatches(cfg, shape)) == want
    assert chip_smoke.cut_note(get_config("llama-3.2-vision-90b"), llama,
                               (0, 1)).startswith("n_layers 100 -> 2")


def test_chip_smoke_counts_the_encoder_and_cross_work():
    """Model FLOPs: the encoder's parameters over the frames and the rest
    over the tokens (the lookup tables left out: the token embedding and
    the learned position tables); attention's
    causal pairs on self-attention layers, S^2 on encoder layers, S x L
    on cross layers and sublayers, 3.5 x 4 FLOPs a pair and head dim.
    Launches: two forwards (remat) and a backward a decoder attention,
    one of each an encoder layer (not rematerialised), per microbatch."""
    w = get_config("whisper-medium")
    n = chip_smoke.param_count(w)
    enc = int(w.n_params_encoder())
    lookup = w.vocab * w.d_model + 2 * w.max_seq * w.d_model
    b, s, L = 16, 448, 1500
    attn = 3.5 * 4.0 * b * 16 * 64 * (
        24 * chip_smoke.attention_pairs(s, s, True) + 24 * L * L
        + 24 * s * L)
    assert chip_smoke.train_flops(n, w, b, s, L) == \
        6.0 * (n - enc - lookup) * b * s + 6.0 * enc * b * L + attn
    assert chip_smoke.train_launches(w, 4, 2) == {
        "flash_attention": 4 * 2 * (2 * 48 + 24),
        "flash_attention_bwd": 4 * 2 * 72}
    llama = period_slots(get_config("llama-3.2-vision-90b"), (0, 1))
    n = chip_smoke.param_count(llama)
    attn = 3.5 * 4.0 * 64 * 128 * (chip_smoke.attention_pairs(2048, 2048,
                                                              True)
                                   + 2048 * 6404)
    assert chip_smoke.train_flops(n, llama, 1, 2048, 6404) == \
        6.0 * (n - llama.vocab * llama.d_model) * 2048 + attn
    assert chip_smoke.train_launches(llama, 4) == {
        "flash_attention": 16, "flash_attention_bwd": 8}
    # a config without a context: its embedding left out alike
    qwen = get_config("qwen1.5-0.5b")
    n = chip_smoke.param_count(qwen)
    assert chip_smoke.train_flops(n, qwen, 4, 2048) == \
        6.0 * (n - qwen.vocab * qwen.d_model) * 4 * 2048 \
        + 3.5 * 4.0 * 4 * 16 * 64 * 24 * \
        chip_smoke.attention_pairs(2048, 2048, True)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_unit_scores_bring_the_scores_to_one_deviation(arch):
    """``unit_scores`` on a cut at the published init scale (narrowed to
    d 512 here): the first decoder layer's (llama-vision's cross layer's,
    whose keys are the raw context's) and whisper's first encoder layer's
    attention scores over a unit-variance input have a standard deviation
    of d / P before (well above one) and near one after."""
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=1, encoder_layers=1) \
        if cfg.is_encdec else period_slots(cfg, (0,))
    cfg = dataclasses.replace(cfg, d_model=512, n_heads=8, n_kv_heads=8,
                              head_dim=64, d_ff=64, vocab=64, max_seq=64)
    model = LM(cfg, device="cpu",
               generator=torch.Generator().manual_seed(0))
    chip_smoke.published_init_scale(torch, model)
    stacks = ["layers"] + (["encoder"] if cfg.is_encdec else [])
    published = get_config(arch)
    h = torch.randn((256, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))

    def score_std(stack):
        layer = getattr(model, stack)[0]
        q = (h.bfloat16() @ layer.wq).float().reshape(256, 8, 64)
        k = (h.bfloat16() @ layer.wk).float().reshape(256, 8, 64)
        return float(torch.einsum("qhd,khd->hqk", q, k).std() / 8.0)
    before = {s: score_std(s) for s in stacks}
    factor = chip_smoke.unit_scores(torch, model)
    for s in stacks:
        n_pub = published.n_periods if s == "layers" \
            else published.encoder_layers
        assert factor[s] == n_pub / cfg.d_model
        assert before[s] == pytest.approx(cfg.d_model / n_pub, rel=0.2)
        assert score_std(s) == pytest.approx(1.0, rel=0.2)
