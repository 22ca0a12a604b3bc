"""Gradient compression and microbatch gradient accumulation: the part
of ``repro.distributed.collectives`` that the one-device train step
(``launch.steps``) runs.

A tree here is a dict of tensors keyed like the parameters (the model's
state dict), in place of the reference's pytrees. The arithmetic is the
reference's, bit for bit. The int8 compression, error feedback and the
resharding of the accumulator to the parameters' sharding have no caller
on one device and wait for ROADMAP item 14.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

F32 = torch.float32
Tree = Dict[str, torch.Tensor]


def compress_bf16(grads: Tree) -> Tree:
    """Cast grads to bf16 — halves all-reduce/reduce-scatter bytes."""
    return {n: g.to(torch.bfloat16) for n, g in grads.items()}


def accumulate_microbatches(loss_fn: Callable[[Tree, Tree], torch.Tensor],
                            params: Tree, batches: Tree):
    """Gradient accumulation over a leading microbatch dim, the
    reference's scan unrolled: for each microbatch in order, the loss and
    the gradients of ``loss_fn(params, microbatch)`` with respect to
    ``params`` (leaves that require grad; one that the loss does not reach
    gets zeros), each gradient cast to float32 and added to a float32 sum
    that starts at zero, the loss likewise; then both times 1 / n_micro.

    ``batches``: a dict of tensors with leading dim n_micro. Returns
    (mean_loss, grads), float32. Each microbatch's gradients come from
    ``torch.autograd.grad``, not from ``.grad``, which autograd would sum
    in the parameters' dtype (bf16) and so round where the reference's
    float32 carry does not.

    The reference's ``grad_specs``, which constrains its carry to the
    parameters' FSDP sharding, has no counterpart on one device and is
    not taken."""
    names = list(params)
    leaves = [params[n] for n in names]
    n_micro = next(iter(batches.values())).shape[0]
    loss_sum = torch.zeros((), dtype=F32, device=leaves[0].device)
    gsum = {n: torch.zeros(p.shape, dtype=F32, device=p.device)
            for n, p in params.items()}
    for i in range(n_micro):
        loss = loss_fn(params, {k: v[i] for k, v in batches.items()})
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for n, g in zip(names, grads):
            if g is not None:
                gsum[n] += g.to(F32)
        loss_sum = loss_sum + loss.detach().to(F32)
        del loss, grads
    inv = 1.0 / n_micro
    return loss_sum * inv, {n: g.mul_(inv) for n, g in gsum.items()}
