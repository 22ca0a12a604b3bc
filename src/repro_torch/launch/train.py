"""End-to-end fault-tolerant trainer of the port (the counterpart of
``repro.launch.train``).

Pulls everything together: a versioned dataset (a pinned snapshot) -> the
batch pipeline -> the model's loss and its gradients (attention's
backward is the hand-written kernel on the card) -> AdamW -> versioned
checkpoints with NaN rollback. The control flow is the reference's: pin,
train, checkpoint every k steps, and on a non-finite loss or parameter
probe roll back to the last good tag and replay from its step.

One departure: the reference would roll back forever on a fault that
its replay meets again (a deterministic NaN); here a second fault before
a new checkpoint is written raises ``RuntimeError``.

Usage (the reduced config on the CPU; without ``--device`` it wants the
card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 50 --seq-len 128 --batch 8 --device cpu
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict, Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..configs.base import ArchConfig
from ..core import Engine
from ..data import (BatchPipeline, PinnedDataset, PipelineCfg,
                    create_token_table, synth_corpus)
from ..device import resolve_device
from ..models.convert import TOP, stack_tree, stacked_ndim, unstack_tree
from ..models.lm import LM, loss_fn
from ..optim import AdamWCfg, OptState, apply_updates, init_opt_state
from ..optim.adamw import global_norm


def ckpt_state(cfg: ArchConfig, params: Dict[str, torch.Tensor],
               opt: OptState) -> Dict:
    """The training state in the reference's tree, as checkpoints store
    it: ``{"params": tree, "opt": OptState(step, mu tree, nu tree)}``
    with every layer leaf stacked over the periods (new tensors)."""
    with torch.no_grad():
        return {"params": stack_tree(cfg, params),
                "opt": OptState(opt.step, stack_tree(cfg, opt.mu),
                                stack_tree(cfg, opt.nu))}


def load_ckpt_state(cfg: ArchConfig, tree: Dict,
                    params: Dict[str, torch.Tensor], opt: OptState):
    """Copy a restored :func:`ckpt_state` tree into the live parameters
    and moments, in place; returns the restored ``OptState``."""
    with torch.no_grad():
        for dst, src in ((params, tree["params"]), (opt.mu, tree["opt"].mu),
                         (opt.nu, tree["opt"].nu)):
            for name, t in unstack_tree(cfg, src).items():
                dst[name].copy_(t)
    return OptState(tree["opt"].step.clone(), opt.mu, opt.nu)


def decay_names(params: Dict[str, torch.Tensor]):
    """The parameters AdamW decays: the reference's rule on its stacked
    tree, leaves of ndim >= 2 (every layer leaf, embed and lm_head)."""
    return [n for n, p in params.items() if stacked_ndim(n, p) >= 2]


def _first_row(cfg: ArchConfig, name: str) -> bool:
    """Whether the state-dict leaf ``name`` is in row 0 of its stacked
    axis in the reference's tree: a layer of the first period, or the
    first encoder layer (the encoder is stacked over its layers)."""
    stack, row = name.split(".")[:2]
    return int(row) < (1 if stack == "encoder" else cfg.period)


@torch.no_grad()
def probe_norm(cfg: ArchConfig, params: Dict[str, torch.Tensor]):
    """The reference's health probe: the global norm of each leaf's first
    slice along its stacked axis (the first period's layers, the first
    encoder layer, and row 0 of the top-level leaves)."""
    return global_norm(p[:1] if n in TOP else p for n, p in params.items()
                       if n in TOP or _first_row(cfg, n))


def train_step(model: LM, batch: Dict[str, torch.Tensor], opt: OptState,
               opt_cfg: AdamWCfg, decay, attn_block: int,
               remat: bool = False):
    """Loss, gradients and one AdamW step (parameters updated in place).
    Returns (opt, metrics) with the loss as a tensor. ``remat``
    recomputes each period's activations in the backward, as the
    reference's sharded step (``make_train_step``) does; ``train_loop``
    runs without it, as the reference's does."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    loss = loss_fn(model, batch, attn_block=attn_block, remat=remat)
    loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    _, opt, metrics = apply_updates(params, grads, opt, opt_cfg, decay=decay)
    metrics["loss"] = loss.detach()
    return opt, metrics


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(arch, *, steps: int = 50, reduced: bool = True,
               seq_len: int = 128, global_batch: int = 8,
               ckpt_every: int = 20, inject_fault_at: Optional[int] = None,
               attn_block: int = 32, log_every: int = 10,
               lr: float = 3e-4, engine: Optional[Engine] = None,
               device=None, params: Optional[Dict] = None,
               timings: Optional[Dict] = None):
    """Returns (state, losses, engine); ``state`` holds the ``model``, its
    live ``params`` and the optimizer state ``opt``. ``arch`` is a config
    name or an ``ArchConfig``. ``device``: ``None`` means the card (and an
    engine made here lives there too); ``"cpu"`` only when asked.
    ``inject_fault_at`` corrupts the parameters at that step to exercise
    rollback-recovery. ``params``: initial weights as the model's state
    dict (default: drawn from seed 0). ``timings``, when given, collects
    host seconds to a device sync: ``step_s`` per step (rolled-back steps
    included), ``save_s`` per checkpoint and ``restore_s`` per rollback."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    dev = resolve_device(device)
    engine = engine or Engine(device=dev)
    times = timings if timings is not None else {}
    for key in ("step_s", "save_s", "restore_s"):
        times.setdefault(key, [])

    # 1. versioned dataset: ingest + pin a snapshot (the paper's workflow)
    if "corpus" not in engine.tables:
        create_token_table(engine, "corpus")
        synth_corpus(engine, "corpus", n_samples=256,
                     sample_len=seq_len + 1, vocab=cfg.vocab)
    snap = engine.create_snapshot(f"train-pin-{engine.ts}", "corpus")
    ds = PinnedDataset(engine, snap)
    pipe = BatchPipeline(ds, PipelineCfg(seq_len=seq_len,
                                         global_batch=global_batch))

    # 2. model + optimizer
    opt_cfg = AdamWCfg(lr_peak=lr, warmup_steps=max(2, steps // 10),
                       decay_steps=steps)
    model = LM(cfg, device=dev)
    if params is not None:
        model.load_state_dict(params)
    model.requires_grad_()
    live = dict(model.named_parameters())
    opt = init_opt_state(live, opt_cfg)
    decay = decay_names(live)

    def save(step: int) -> Optional[str]:
        if step % ckpt_every:
            return None
        t0 = time.perf_counter()
        tag = cm.maybe_save(ckpt_state(cfg, live, opt), step)
        times["save_s"].append(time.perf_counter() - t0)
        return tag

    # 3. fault-tolerant loop (a tag prefix of its own per run: one engine
    # may host several runs, as examples/train_versioned does)
    cm = CheckpointManager(engine, every=ckpt_every,
                           prefix=f"run{engine.ts}-")
    save(0)
    losses = []
    recovered_from = None    # the tag of the last rollback, until a save
    step = 1
    while step <= steps:
        t0 = time.perf_counter()
        batch = pipe.tensors_at(step, dev)
        opt, metrics = train_step(model, batch, opt, opt_cfg, decay,
                                  attn_block)
        if inject_fault_at is not None and step == inject_fault_at:
            # simulated hardware fault: corrupt the parameters
            with torch.no_grad():
                for n, p in live.items():
                    if stacked_ndim(n, p) >= 2:
                        p.mul_(math.nan)
            inject_fault_at = None
        loss = float(metrics["loss"])
        probe = float(probe_norm(cfg, live))        # syncs the step's work
        times["step_s"].append(time.perf_counter() - t0)
        if not cm.healthy(loss) or not math.isfinite(probe):
            good = cm.last_tag
            if good is not None and good == recovered_from:
                raise RuntimeError(
                    f"step {step} is not finite again after the rollback "
                    f"to {good}: the fault repeats, so replaying would not "
                    f"end")
            t0 = time.perf_counter()
            tree = cm.recover(ckpt_state(cfg, live, opt))
            opt = load_ckpt_state(cfg, tree, live, opt)
            _sync(dev)
            times["restore_s"].append(time.perf_counter() - t0)
            recovered_from = good
            step = cm.step_of(good) + 1
            print(f"[train] fault detected @ {step}: rolled back to {good}",
                  flush=True)
            continue
        losses.append(loss)
        if save(step) is not None:
            recovered_from = None
        if step % log_every == 0:
            print(f"[train] step {step:4d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        step += 1
    return {"model": model, "params": live, "opt": opt}, losses, engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    _, losses, _ = train_loop(
        args.arch, steps=args.steps, reduced=args.reduced,
        seq_len=args.seq_len, global_batch=args.batch,
        inject_fault_at=args.inject_fault_at, device=args.device)
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
