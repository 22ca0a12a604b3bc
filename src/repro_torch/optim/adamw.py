"""AdamW with a cosine schedule, global-norm clipping and a configurable
state dtype: the port of ``repro.optim.adamw`` on tensors.

Parameters, gradients and the moments are dicts of tensors with the same
keys. The arithmetic is the reference's, in float32: clip by the global
norm, the moments in ``state_dtype``, bias correction, decoupled weight
decay on the names in ``decay`` (by the reference's rule, leaves of two or
more dimensions), and each parameter updated in float32 and cast back to
its dtype. There is no float32 master copy (the reference has none).
Not ``torch.optim.AdamW``, whose schedule and decay differ.

Unlike the reference, which returns new trees, :func:`apply_updates`
writes the parameters and the moments in place: at full width they are
6.2 GB, and one copy of them is enough. The step count and the schedule
stay tensors on the state's device, so a step needs no host sync.

On DTensor leaves (the sharded step) the same arithmetic computes the
global step: the clip's norm sums every shard's squares, the plain scalars
(rate, bias corrections) mix in under ``implicit_replication``, and each
new moment and parameter is written back at its own placement.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterable, NamedTuple, Optional

import torch

from ..distributed.sharding import is_dtensor

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # "bfloat16" halves optimizer memory


class OptState(NamedTuple):
    step: torch.Tensor                 # () int32
    mu: Dict[str, torch.Tensor]        # like the parameters
    nu: Dict[str, torch.Tensor]


def init_opt_state(params: Dict[str, torch.Tensor],
                   cfg: AdamWCfg) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    dev = next(iter(params.values())).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                     for n, p in params.items()},
                    {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                     for n, p in params.items()})


def lr_at(cfg: AdamWCfg, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then cosine decay to ``lr_min``
    (float32, on ``step``'s device)."""
    step = step.to(F32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) \
        * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in tensors))


def _mixing(sharded: bool):
    """Plain tensors mix with DTensors as replicated (the sharded step's
    scalars), or nothing changes."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _like(t, ref):
    """``t`` at ``ref``'s placements (a DTensor), or as it is."""
    if is_dtensor(t) and tuple(t.placements) != tuple(ref.placements):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: AdamWCfg, *, decay: Optional[Iterable[str]] = None):
    """One AdamW step, in place. ``decay``: the names that take weight
    decay (default: every parameter of two or more dimensions, the
    reference's rule on the tree it is given). Returns (params, new
    state, metrics) with ``lr``, ``grad_norm`` and ``clip_scale``."""
    step = state.step + 1
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(F32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    decay = set(n for n, p in params.items() if p.dim() >= 2) \
        if decay is None else set(decay)
    sharded = any(is_dtensor(p) for p in params.values())
    with _mixing(sharded):
        for name, p in params.items():
            m, v = state.mu[name], state.nu[name]
            g = grads[name].to(F32) * scale
            m32 = b1 * m.to(F32) + (1 - b1) * g
            v32 = b2 * v.to(F32) + (1 - b2) * g * g
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if name in decay:
                delta = delta + cfg.weight_decay * p.to(F32)
            p.copy_(_like(p.to(F32) - lr * delta, p))
            m.copy_(_like(m32, m))
            v.copy_(_like(v32, v))
    metrics = {"lr": lr, "grad_norm": gnorm, "clip_scale": scale}
    return params, OptState(step, state.mu, state.nu), metrics
