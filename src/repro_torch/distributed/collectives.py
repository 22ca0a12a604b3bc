"""Gradient compression (bf16, int8 with a per-tensor scale, error
feedback) and microbatch gradient accumulation: the port of
``repro.distributed.collectives``.

A tree here is a dict of tensors keyed like the parameters (the model's
state dict), in place of the reference's pytrees. The arithmetic is the
reference's, bit for bit: both round half to even (``round``) and cast to
bf16 with round-to-nearest-even. As in the reference, no train step calls
the int8 functions or the error feedback; ``launch.steps`` takes the bf16
cast (``ShardCfg.grad_compress_bf16``) and the accumulation, whose float32
carry is placed by the parameters' specs on a mesh (``grad_specs``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .sharding import Spec, placements, to_spec

F32 = torch.float32
Tree = Dict[str, torch.Tensor]


def compress_bf16(grads: Tree) -> Tree:
    """Cast grads to bf16 — halves all-reduce/reduce-scatter bytes."""
    return {n: g.to(torch.bfloat16) for n, g in grads.items()}


def compress_int8(grads: Tree) -> Tuple[Tree, Tree]:
    """Per-tensor symmetric int8 quantization. Returns (q, scales): scale
    = max(max |g|, 1e-12) / 127 in float32, q = round(g / scale)."""
    q, scales = {}, {}
    for n, g in grads.items():
        g = g.to(F32)
        s = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
        q[n], scales[n] = torch.round(g / s).to(torch.int8), s
    return q, scales


def decompress_int8(q: Tree, scales: Tree) -> Tree:
    return {n: g.to(F32) * scales[n] for n, g in q.items()}


def error_feedback_apply(grads: Tree, residual: Optional[Tree]):
    """g' = g + residual; new_residual = g' − compress(g') (bf16), all in
    float32; ``residual`` None starts at zero. Returns (compressed,
    new_residual)."""
    if residual is None:
        residual = {n: torch.zeros_like(g, dtype=F32)
                    for n, g in grads.items()}
    corrected = {n: g.to(F32) + residual[n] for n, g in grads.items()}
    compressed = compress_bf16(corrected)
    return compressed, {n: c - compressed[n].to(F32)
                        for n, c in corrected.items()}


def accumulate_microbatches(loss_fn: Callable[[Tree, Tree], torch.Tensor],
                            params: Tree, batches, *,
                            grad_specs: Optional[Dict[str, Spec]] = None,
                            mesh=None):
    """Gradient accumulation over a leading microbatch dim, the
    reference's scan unrolled: for each microbatch in order, the loss and
    the gradients of ``loss_fn(params, microbatch)`` with respect to
    ``params`` (leaves that require grad; one that the loss does not reach
    gets zeros), each gradient cast to float32 and added to a float32 sum
    that starts at zero, the loss likewise; then both times 1 / n_micro.

    ``batches``: a dict of tensors with leading dim n_micro, or a sequence
    of n_micro microbatch dicts (the sharded step's, each placed on the
    mesh). Returns (mean_loss, grads), float32. Each microbatch's
    gradients come from ``torch.autograd.grad``, not from ``.grad``, which
    autograd would sum in the parameters' dtype (bf16) and so round where
    the reference's float32 carry does not.

    ``grad_specs`` (a spec per parameter name, on ``mesh``) places the
    float32 carry as a DTensor by the parameters' FSDP sharding: each
    microbatch's gradient is redistributed to it before the add, so a
    partial sum over the data-parallel ranks is reduce-scattered into the
    carry rather than all-reduced."""
    names = list(params)
    leaves = [params[n] for n in names]
    if isinstance(batches, dict):
        n_micro = next(iter(batches.values())).shape[0]
        micro = [{k: v[i] for k, v in batches.items()}
                 for i in range(n_micro)]
    else:
        micro, n_micro = list(batches), len(batches)
    if grad_specs is None:
        gsum = {n: torch.zeros(p.shape, dtype=F32, device=p.device)
                for n, p in params.items()}
        loss_sum = torch.zeros((), dtype=F32, device=leaves[0].device)
    else:
        from torch.distributed.tensor import zeros as dzeros
        gsum = {n: dzeros(p.shape, dtype=F32, device_mesh=mesh,
                          placements=placements(grad_specs[n], mesh))
                for n, p in params.items()}
        loss_sum = dzeros((), dtype=F32, device_mesh=mesh,
                          placements=placements((), mesh))
    for mb in micro:
        loss = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for n, g in zip(names, grads):
            if g is None:
                continue
            g = g.to(F32)
            if grad_specs is not None:
                g = to_spec(g, grad_specs[n], mesh)
            gsum[n] += g
        loss_sum = loss_sum + loss.detach().to(F32)
        del loss, grads
    inv = 1.0 / n_micro
    return loss_sum * inv, {n: g.mul_(inv) for n, g in gsum.items()}
