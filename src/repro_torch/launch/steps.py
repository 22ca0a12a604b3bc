"""Step builders: the sharded train / prefill / decode steps of
``repro.launch.steps`` and their input specs, on a ``DeviceMesh``, and
the train step on one device.

``make_train_step`` is the reference's microbatched step: each
microbatch's ``loss_fn(..., remat=True)`` and its gradients, accumulated
in float32 by ``distributed.collectives``, optionally cast to bf16
(``grad_compress_bf16``; on a mesh, the ``ShardCfg`` field it sets), then
AdamW in place with the reference's decay rule. One step body serves
both forms. It is the reference's only way to train a config
with a context (whisper's frames, llama-vision's patches): ``input_specs``
puts ``ctx`` beside the tokens. Without a mesh it runs on one device;
with one (``distributed.elastic.make_mesh_for``) the parameters, the
optimizer state, the batch and the cache are DTensors placed by
``state_specs`` and ``input_specs`` (:func:`place_inputs`, the
counterpart of the reference's ``in_shardings``), the model runs under a
``ModelSharding``, the embed and head are taken to their at-use
placements once per step, and the gradients' float32 carry is placed by
the parameters' specs. ``input_specs`` gives every step input's shape and
dtype as tensors on the ``meta`` device, and with a mesh also their specs.

The reference's ``as_shardings`` converts specs for an old version of JAX
and has no counterpart here.

One step of a reduced config on the CPU (without ``device`` it runs on
the card):

    cfg = get_config("whisper-medium").reduced()
    shape = ShapeCfg("t", 64, 4, "train")
    step = make_train_step(cfg, shape, device="cpu")
    state = init_state(LM(cfg, device="cpu"))
    state, metrics = step(state, batch)   # batch as input_specs shapes it

and over a mesh, in each rank of a started process group:

    mesh = make_mesh_for(4, device="cpu", model_cap=2)    # data 2, model 2
    step, st_specs, b_specs = make_train_step(cfg, shape, mesh)
    state, batch = place_inputs(init_state(LM(cfg, device="cpu")), batch,
                                st_specs, b_specs, mesh)
    state, metrics = step(state, batch)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig, ShapeCfg
from ..device import resolve_device
from ..distributed.collectives import accumulate_microbatches, compress_bf16
from ..distributed.sharding import (ModelSharding, ShardCfg, Spec,
                                    batch_spec, dp_size, place_tree,
                                    spec, to_spec, tree_cache_specs,
                                    tree_param_specs)
from ..models import lm
from ..optim import AdamWCfg, OptState, apply_updates, init_opt_state
from .train import decay_names

BF16 = torch.bfloat16
#: whisper's published decoder length: an encoder-decoder config's step
#: takes min(DEC_LEN, frames) tokens
DEC_LEN = 448


# -------------------------------------------------------------- policies

def pick_microbatches(cfg: ArchConfig, shape: ShapeCfg, mesh=None,
                      act_budget: int = 128 << 20) -> int:
    """Accumulation factor: keep per-microbatch live activations (bf16,
    d_model-width, with remat) under ``act_budget`` per device, which
    holds the batch over :func:`dp_size` of ``mesh`` (the whole batch
    without one)."""
    dp = 1 if mesh is None else dp_size(mesh)
    local_b = max(1, shape.global_batch // dp)
    width = max(cfg.d_model,
                cfg.ssm.expand * cfg.d_model if cfg.ssm else cfg.d_model)
    per_item = shape.seq_len * width * 2 * 4  # x4: residuals + mixer buffers
    n = 1
    while local_b % (2 * n) == 0 and (local_b // n) * per_item > act_budget:
        n *= 2
    return n


def shard_cfg_for(cfg: ArchConfig, shape: ShapeCfg) -> ShardCfg:
    """Default sharding strategy per (arch, shape) cell."""
    return ShardCfg(
        fsdp=True, tp=True,
        seq_shard_cache=(shape.name == "long_500k"),
        # GQA decode: kv-heads rarely divide the TP axis, so the cache
        # sequence goes over 'model' instead of being replicated
        cache_seq_model=(shape.kind == "decode"),
    )


# ------------------------------------------------------------ input specs

def context_sizes(cfg: ArchConfig, seq_len: int) -> Tuple[int, int]:
    """(context positions, tokens) of a step of ``seq_len``: a cross
    config attends its ``cross_len`` patches; an encoder-decoder config's
    ``seq_len`` is its frames and its tokens are min(DEC_LEN, frames);
    any other config has no context."""
    if cfg.is_encdec:
        return seq_len, min(DEC_LEN, seq_len)  # frames drive the long dim
    return cfg.cross_len, seq_len


def input_specs(cfg: ArchConfig, shape: ShapeCfg, mesh=None,
                sc: Optional[ShardCfg] = None):
    """Stand-ins for every input of the step of ``shape.kind``, as tensors
    on the ``meta`` device (shapes and dtypes, no memory), keyed per
    argument: train ``{"batch": {tokens, targets[, ctx]}}``, prefill
    ``{tokens[, ctx]}``, decode ``{token, cache}`` (``lm.init_cache`` at
    the reference's capacity: min(DEC_LEN + 128, S) tokens for an
    encoder-decoder config, else S + 128). Tokens are int32, the context
    (B, L, d_model) bf16.

    With a ``mesh`` (a ``DeviceMesh`` or a layout) returns (stand-ins,
    specs), the specs keyed alike: tokens by the batch spec where the
    batch divides the data-parallel size, else replicated, the context's
    batch dim likewise, the cache by ``tree_cache_specs`` of ``sc``
    (default :func:`shard_cfg_for`)."""
    out = _abstract_inputs(cfg, shape)
    if mesh is None:
        return out
    sc = sc or shard_cfg_for(cfg, shape)
    B = shape.global_batch
    bspec = batch_spec(mesh) if B % dp_size(mesh) == 0 else ()
    cspec = spec(bspec[0] if len(bspec) else None, None, None)
    if shape.kind == "train":
        sh = {"batch": {k: (cspec if k == "ctx" else bspec)
                        for k in out["batch"]}}
    elif shape.kind == "prefill":
        sh = {k: (cspec if k == "ctx" else bspec) for k in out}
    else:
        sh = {"token": bspec,
              "cache": tree_cache_specs(cfg, sc, out["cache"], mesh)}
    return out, sh


def _abstract_inputs(cfg: ArchConfig, shape: ShapeCfg) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    ctx_len, dec_len = context_sizes(cfg, S)
    meta = torch.device("meta")

    def tok(b, s):
        return torch.empty((b, s), dtype=torch.int32, device=meta)

    def context():
        return torch.empty((B, ctx_len, cfg.d_model), dtype=BF16,
                           device=meta)

    if shape.kind == "train":
        batch = {"tokens": tok(B, dec_len), "targets": tok(B, dec_len)}
        if ctx_len:
            batch["ctx"] = context()
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": tok(B, dec_len)}
        if ctx_len:
            out["ctx"] = context()
        return out
    cap = min(DEC_LEN + 128, S) if cfg.is_encdec else S + 128
    return {"token": tok(B, 1),
            "cache": lm.init_cache(cfg, B, cap, ctx_len, device=meta)}


def _meta_params(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The parameters of ``cfg``'s LM on the ``meta`` device, by name."""
    return dict(lm.LM(cfg, device="meta").named_parameters())


def abstract_state(cfg: ArchConfig, opt_cfg: AdamWCfg) -> Dict:
    """The (params, opt) state of ``cfg`` on the ``meta`` device: shapes
    and dtypes, no memory (the reference's ``eval_shape``)."""
    params = _meta_params(cfg)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def _extend_fsdp_to_pod(sp: Spec, shape, mesh) -> Spec:
    """ZeRO-1 across pods: optimizer-state dims sharded by 'data' extend to
    ('data', 'pod') when divisible (DTensor splits such a dim pod-major:
    ``sharding`` module docstring)."""
    from ..distributed.sharding import layout
    lay = layout(mesh)
    if "pod" not in lay.axis_names:
        return sp
    total = lay.shape["data"] * lay.shape["pod"]
    parts = []
    for dim, ax in zip(shape, tuple(sp) + (None,) * len(shape)):
        if ax == "data" and dim % total == 0:
            parts.append(("data", "pod"))
        else:
            parts.append(ax)
    return spec(*parts)


def _opt_specs(cfg: ArchConfig, sc: ShardCfg, tree, mesh) -> Dict:
    """Param specs for optimizer states, FSDP extended across 'pod'."""
    specs = tree_param_specs(cfg, sc, tree, mesh)
    return {n: _extend_fsdp_to_pod(specs[n], tuple(t.shape), mesh)
            for n, t in tree.items()}


def state_specs(cfg: ArchConfig, sc: ShardCfg, state_shape, mesh) -> Dict:
    """Specs of a train state: ``{"params": ..., "opt": OptState((), mu,
    nu)}`` (the step count replicated)."""
    opt = state_shape["opt"]
    return {"params": tree_param_specs(cfg, sc, state_shape["params"], mesh),
            "opt": OptState((), _opt_specs(cfg, sc, opt.mu, mesh),
                            _opt_specs(cfg, sc, opt.nu, mesh))}


def place_params(model: lm.LM, pspecs: Dict[str, Spec], mesh) -> lm.LM:
    """Replace each parameter of ``model`` by a DTensor on ``mesh`` placed
    by its spec (keeping ``requires_grad``); a parameter already placed
    is redistributed. Returns the model."""
    for name, p in list(model.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        t = place_tree(p.detach(), pspecs[name], mesh)
        setattr(model.get_submodule(mod) if mod else model, leaf,
                nn.Parameter(t, requires_grad=p.requires_grad))
    return model


def place_inputs(state: Dict, batch: Optional[Dict], st_specs: Dict,
                 b_specs: Optional[Dict], mesh):
    """A train state (:func:`init_state`'s) and a batch placed on ``mesh``
    by ``st_specs`` and ``b_specs`` (:func:`make_train_step`'s): the
    model's parameters (:func:`place_params`) and AdamW's moments as
    DTensors, the step count as it is (a plain tensor, the same on every
    rank); the batch's tensors as DTensors. The counterpart of the
    reference's ``in_shardings``. Returns (state, batch)."""
    model = place_params(state["model"], st_specs["params"], mesh)
    opt = state["opt"]
    opt = OptState(opt.step, place_tree(opt.mu, st_specs["opt"].mu, mesh),
                   place_tree(opt.nu, st_specs["opt"].nu, mesh))
    state = {"model": model, "params": dict(model.named_parameters()),
             "opt": opt}
    if batch is not None:
        batch = place_tree(batch, b_specs, mesh)
    return state, batch


# ------------------------------------------------------------ step fns

def init_state(model: lm.LM, opt_cfg: Optional[AdamWCfg] = None) -> Dict:
    """The state a train step takes: ``model``, its live parameters (set
    to require grad) and a zero ``OptState`` of ``opt_cfg``."""
    model.requires_grad_()
    params = dict(model.named_parameters())
    return {"model": model, "params": params,
            "opt": init_opt_state(params, opt_cfg or AdamWCfg())}


def make_train_step(cfg: ArchConfig, shape: ShapeCfg, mesh=None,
                    sc: Optional[ShardCfg] = None, *,
                    grad_compress_bf16: bool = False,
                    opt_cfg: Optional[AdamWCfg] = None,
                    n_micro: Optional[int] = None, attn_block: int = 1024,
                    device=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; with a
    ``mesh``, (train_step, state specs, batch specs), as the reference.
    Both forms run one step body (:func:`_train_step`).

    ``state`` is :func:`init_state`'s dict of an ``LM`` of ``cfg``, its
    live parameters and its ``OptState``; ``batch`` holds what
    :func:`input_specs` shapes. The step splits the batch into
    ``n_micro`` leading slices (default :func:`pick_microbatches`), takes
    each one's ``loss_fn(..., remat=True)`` and gradients
    (``accumulate_microbatches`` above one slice), casts the gradients to
    bf16 under ``grad_compress_bf16`` and applies AdamW in place with the
    reference's decay rule. The metrics are ``apply_updates``' and the
    loss. The parameters are updated in place and the returned state
    holds the new ``OptState``.

    Without a mesh the step runs on ``device`` (``None``: the card;
    ``"cpu"`` only when asked), where the reference's FSDP gathers of
    ``embed`` and ``lm_head`` change no value and have no counterpart; a
    ``ShardCfg`` there is refused. With one, the state and batch are
    placed by the returned specs (:func:`place_inputs`), ``sc`` (default
    :func:`shard_cfg_for`) is the strategy, ``grad_compress_bf16=True``
    sets its field of that name, and ``device`` is refused: the mesh's
    own device runs the step."""
    opt_cfg = opt_cfg or AdamWCfg()
    if mesh is None:
        if sc is not None:
            raise ValueError("a ShardCfg is a mesh's strategy: without a "
                             "mesh pass grad_compress_bf16")
        return _train_step(opt_cfg, grad_compress_bf16,
                           n_micro or pick_microbatches(cfg, shape),
                           attn_block, dev=resolve_device(device))
    if device is not None:
        raise ValueError("a mesh's step runs on the mesh's device: pass "
                         "no device with a mesh")
    sc = sc or shard_cfg_for(cfg, shape)
    if grad_compress_bf16:
        sc = dataclasses.replace(sc, grad_compress_bf16=True)
    st_shape = abstract_state(cfg, opt_cfg)
    st_specs = state_specs(cfg, sc, st_shape, mesh)
    _, in_sh = input_specs(cfg, shape, mesh, sc)
    step = _train_step(opt_cfg, sc.grad_compress_bf16,
                       n_micro or pick_microbatches(cfg, shape, mesh),
                       attn_block, shd=ModelSharding(cfg, sc, mesh,
                                                     st_shape["params"]),
                       pspecs=st_specs["params"], mesh=mesh)
    return step, st_specs, in_sh["batch"]


def microbatches(batch: Dict[str, torch.Tensor], n_micro: int,
                 mesh=None) -> List[Dict[str, torch.Tensor]]:
    """``batch`` split into ``n_micro`` leading slices, a list of dicts.
    On a ``mesh`` each slice stays sharded over the data-parallel axes
    (the reference's ``P(None, dp)`` before the slice is taken) where its
    rows divide their size, else replicated; a sharded batch dim is
    gathered before the split, as DTensor cannot reshape it into slices
    of its shards (a dim over two mesh dims in any version of torch,
    over one in some)."""
    def split(x):
        b = x.shape[0]
        if mesh is not None and any(p.is_shard(0) for p in x.placements):
            x = to_spec(x, spec(*([None] * x.ndim)), mesh)
        x = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
        if mesh is None:
            return x
        dp = batch_spec(mesh)[0] if (b // n_micro) % dp_size(mesh) == 0 \
            else None
        return to_spec(x, spec(None, dp, *([None] * (x.ndim - 2))), mesh)

    split_batch = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split_batch.items()}
            for i in range(n_micro)]


def _train_step(opt_cfg: AdamWCfg, compress: bool, n_micro: int,
                attn_block: int, *, dev=None, shd=None,
                pspecs: Optional[Dict[str, Spec]] = None, mesh=None):
    """The one train step body of :func:`make_train_step`'s two forms.
    On one device ``dev`` is its device and ``shd``, ``pspecs`` and
    ``mesh`` are None. On a mesh (``dev`` None) the step takes ``embed``
    and ``lm_head`` to their at-use placements once (the reference hoists
    these FSDP gathers out of the microbatch loop), leaves of their own
    that the loss differentiates; keeps the slices sharded
    (:func:`microbatches`); and places the gradients, and their float32
    carry, by the parameters' specs ``pspecs``."""
    hoist = {} if shd is None else {"embed": shd.embed, "lm_head": shd.head}

    def at_spec(g, name):
        return g if mesh is None else to_spec(g, pspecs[name], mesh)

    def train_step(state, batch):
        model, params, opt = state["model"], state["params"], state["opt"]
        if dev is not None:
            if model.device != dev:
                raise ValueError(f"the model is on {model.device}, the "
                                 f"step on {dev}")
            batch = {k: v.to(dev) for k, v in batch.items()}

        def loss(p, mb):
            return lm.loss_fn(model, mb, attn_block=attn_block, remat=True,
                              shd=shd, params={k: p[k] for k in hoist})

        leaves = dict(params)
        for k, fn in hoist.items():
            leaves[k] = fn(params[k]).detach().requires_grad_()
        if n_micro > 1:
            loss_val, grads = accumulate_microbatches(
                loss, leaves, microbatches(batch, n_micro, mesh),
                grad_specs=pspecs, mesh=mesh)
        else:
            out = loss(leaves, batch)
            got = torch.autograd.grad(out, list(leaves.values()),
                                      allow_unused=True)
            grads = {n: at_spec(torch.zeros_like(leaves[n]) if g is None
                                else g, n)
                     for n, g in zip(leaves, got)}
            loss_val = out.detach()
        del leaves
        if compress:
            grads = compress_bf16(grads)
        _, new_opt, metrics = apply_updates(params, grads, opt, opt_cfg,
                                            decay=decay_names(params))
        metrics["loss"] = loss_val
        return {"model": model, "params": params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, shape: ShapeCfg, mesh,
                      sc: Optional[ShardCfg] = None, attn_block: int = 1024):
    """The reference's sharded prefill on ``mesh``: returns
    (prefill_step, param specs, input specs). ``prefill_step(model,
    tokens, ctx=None) -> (last logits (B, V), cache)`` runs
    ``LM.prefill`` under a ``ModelSharding`` with the reference's
    capacity (the tokens + 128, or the tokens alone under a sliding
    window; an encoder-decoder config's tokens are min(DEC_LEN, S)); the
    model's parameters placed by the param specs (:func:`place_params`),
    the tokens (and context) by the input specs; the cache comes out
    placed by ``tree_cache_specs``."""
    sc = sc or shard_cfg_for(cfg, shape)
    _, dec_len = context_sizes(cfg, shape.seq_len)
    cap = dec_len + 128 if not cfg.sliding_window else dec_len
    params = _meta_params(cfg)
    shd = ModelSharding(cfg, sc, mesh, params)
    pspecs = tree_param_specs(cfg, sc, params, mesh)
    _, in_sh = input_specs(cfg, shape, mesh, sc)

    def prefill_step(model, tokens, ctx=None):
        tokens = place_tree(tokens, in_sh["tokens"], mesh)
        if ctx is not None:
            ctx = place_tree(ctx, in_sh["ctx"], mesh)
        return model.prefill(tokens, ctx, seq_cap=cap, attn_block=attn_block,
                             shd=shd)

    return prefill_step, pspecs, in_sh


def make_decode_step(cfg: ArchConfig, shape: ShapeCfg, mesh,
                     sc: Optional[ShardCfg] = None):
    """The reference's sharded decode step on ``mesh``: returns
    (decode_step, param specs, input specs, stand-ins).
    ``decode_step(model, token, cache) -> (logits (B, V), cache)`` runs
    ``LM.decode_step`` under a ``ModelSharding``, the cache first placed
    by ``tree_cache_specs`` of this shape's strategy (a prefill's cache,
    placed by its own, is redistributed) and updated in place."""
    sc = sc or shard_cfg_for(cfg, shape)
    params = _meta_params(cfg)
    shd = ModelSharding(cfg, sc, mesh, params)
    pspecs = tree_param_specs(cfg, sc, params, mesh)
    abs_in, in_sh = input_specs(cfg, shape, mesh, sc)

    def decode_step(model, token, cache):
        token = place_tree(token, in_sh["token"], mesh)
        cache = place_tree(cache, tree_cache_specs(cfg, sc, cache, mesh),
                           mesh)
        return model.decode_step(token, cache, shd=shd)

    return decode_step, pspecs, in_sh, abs_in
