"""Step builders: the train step of ``repro.launch.steps`` and the shapes
of every step's inputs, on one device.

``make_train_step`` is the reference's sharded, microbatched step at world
size 1: each microbatch's ``loss_fn(..., remat=True)`` and its gradients,
accumulated in float32 by ``distributed.collectives``, optionally cast to
bf16 (the reference's ``ShardCfg.grad_compress_bf16``), then AdamW with
the reference's decay rule. It is the reference's only way to train a
config with a context (whisper's frames, llama-vision's patches):
``input_specs`` puts ``ctx`` beside the tokens. ``input_specs`` gives
every step input's shape and dtype as tensors on the ``meta`` device;
the shardings half, the mesh, the rest of ``ShardCfg``, the prefill and
decode steps, ``abstract_state`` and ``state_specs`` wait for ROADMAP
items 14 and 15.

One step of a reduced config on the CPU (without ``device`` it runs on
the card):

    cfg = get_config("whisper-medium").reduced()
    shape = ShapeCfg("t", 64, 4, "train")
    step = make_train_step(cfg, shape, device="cpu")
    state = init_state(LM(cfg, device="cpu"))
    state, metrics = step(state, batch)   # batch as input_specs shapes it
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeCfg
from ..device import resolve_device
from ..distributed.collectives import accumulate_microbatches, compress_bf16
from ..models import lm
from ..optim import AdamWCfg, apply_updates, init_opt_state
from .train import decay_names

BF16 = torch.bfloat16
#: whisper's published decoder length: an encoder-decoder config's step
#: takes min(DEC_LEN, frames) tokens
DEC_LEN = 448


# -------------------------------------------------------------- policies

def pick_microbatches(cfg: ArchConfig, shape: ShapeCfg,
                      act_budget: int = 128 << 20) -> int:
    """Accumulation factor: keep per-microbatch live activations (bf16,
    d_model-width, with remat) under ``act_budget`` on the one device,
    which holds the whole batch (the reference's at a data-parallel size
    of 1)."""
    local_b = max(1, shape.global_batch)
    width = max(cfg.d_model,
                cfg.ssm.expand * cfg.d_model if cfg.ssm else cfg.d_model)
    per_item = shape.seq_len * width * 2 * 4  # x4: residuals + mixer buffers
    n = 1
    while local_b % (2 * n) == 0 and (local_b // n) * per_item > act_budget:
        n *= 2
    return n


# ------------------------------------------------------------ input specs

def context_sizes(cfg: ArchConfig, seq_len: int) -> Tuple[int, int]:
    """(context positions, tokens) of a step of ``seq_len``: a cross
    config attends its ``cross_len`` patches; an encoder-decoder config's
    ``seq_len`` is its frames and its tokens are min(DEC_LEN, frames);
    any other config has no context."""
    if cfg.is_encdec:
        return seq_len, min(DEC_LEN, seq_len)  # frames drive the long dim
    return cfg.cross_len, seq_len


def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> Dict:
    """Stand-ins for every input of the step of ``shape.kind``, as tensors
    on the ``meta`` device (shapes and dtypes, no memory), keyed per
    argument: train ``{"batch": {tokens, targets[, ctx]}}``, prefill
    ``{tokens[, ctx]}``, decode ``{token, cache}`` (``lm.init_cache`` at
    the reference's capacity: min(DEC_LEN + 128, S) tokens for an
    encoder-decoder config, else S + 128). Tokens are int32, the context
    (B, L, d_model) bf16."""
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


# ------------------------------------------------------------ step fns

def init_state(model: lm.LM, opt_cfg: Optional[AdamWCfg] = None) -> Dict:
    """The state a train step takes: ``model``, its live parameters (set
    to require grad) and a zero ``OptState`` of ``opt_cfg``."""
    model.requires_grad_()
    params = dict(model.named_parameters())
    return {"model": model, "params": params,
            "opt": init_opt_state(params, opt_cfg or AdamWCfg())}


def make_train_step(cfg: ArchConfig, shape: ShapeCfg, *,
                    grad_compress_bf16: bool = False,
                    opt_cfg: Optional[AdamWCfg] = None,
                    n_micro: Optional[int] = None, attn_block: int = 1024,
                    device=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state`` is :func:`init_state`'s dict of an ``LM`` of ``cfg`` on
    ``device`` (``None``: the card; ``"cpu"`` only when asked), its live
    parameters and its ``OptState``; ``batch`` holds what
    :func:`input_specs` shapes (moved to ``device``). The step splits the
    batch into ``n_micro`` leading slices (default
    :func:`pick_microbatches`), takes each one's ``loss_fn(...,
    remat=True)`` and gradients (``accumulate_microbatches`` above one
    slice), casts the gradients to bf16 under ``grad_compress_bf16`` (the
    reference's ``ShardCfg`` field, its default off) and applies AdamW in
    place with the reference's decay rule. The metrics are
    ``apply_updates``' and the loss. The parameters are
    updated in place and the returned state holds the new ``OptState``.

    The step runs on one device; the sharded step (the reference's mesh
    and the rest of its ``ShardCfg``) waits for ROADMAP item 14. The
    reference's FSDP gathers of ``embed`` and ``lm_head`` change no value
    and have no counterpart here."""
    opt_cfg = opt_cfg or AdamWCfg()
    n_micro = n_micro or pick_microbatches(cfg, shape)
    dev = resolve_device(device)

    def train_step(state, batch):
        model, params, opt = state["model"], state["params"], state["opt"]
        if model.device != dev:
            raise ValueError(f"the model is on {model.device}, the step "
                             f"on {dev}")
        batch = {k: v.to(dev) for k, v in batch.items()}

        def loss(_, mb):
            return lm.loss_fn(model, mb, attn_block=attn_block, remat=True)

        if n_micro > 1:
            mbs = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                + v.shape[1:]) for k, v in batch.items()}
            loss_val, grads = accumulate_microbatches(loss, params, mbs)
        else:
            out = loss(params, batch)
            grads = dict(zip(params, torch.autograd.grad(
                out, list(params.values()), allow_unused=True)))
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in grads.items()}
            loss_val = out.detach()
        if grad_compress_bf16:
            grads = compress_bf16(grads)
        _, new_opt, metrics = apply_updates(params, grads, opt, opt_cfg,
                                            decay=decay_names(params))
        metrics["loss"] = loss_val
        return {"model": model, "params": params, "opt": new_opt}, metrics

    return train_step
