"""Elastic scaling and failure handling: the port of
``repro.distributed.elastic``.

When the healthy-device set changes, the launcher (1) picks the largest
valid mesh (:func:`best_mesh_shape`), (2) rebuilds the step for that mesh,
(3) restores the last versioned checkpoint and resumes from the owed step.
State moves through the host: :func:`remap_state` gathers each tensor
whole and places it again by its spec on the new mesh, so any old → new
mesh pair works.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group that the caller has started (nothing here starts one): on
the card with NCCL unless the caller asks for ``device="cpu"`` (gloo).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from .sharding import Spec, layout, place, spec


def best_mesh_shape(n_devices: int, *, model_cap: int = 16,
                    want_pods: int = 1) -> Tuple[Tuple[int, ...],
                                                 Tuple[str, ...]]:
    """Largest (pod, data, model) layout for a (possibly degraded) device
    count: keep 'model' as large as divisible (TP efficiency), put the rest
    in 'data'. Drops stragglers to the largest power-of-two fleet."""
    usable = 1 << (int(n_devices).bit_length() - 1)
    model = 1
    for m in (model_cap, 8, 4, 2, 1):
        if usable % m == 0 and usable >= m:
            model = m
            break
    rest = usable // model
    if want_pods > 1 and rest % want_pods == 0 and rest > want_pods:
        return (want_pods, rest // want_pods, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def make_mesh_for(n_devices: int, device=None, **kw):
    """A ``DeviceMesh`` of :func:`best_mesh_shape` (``kw`` its options)
    over the first prod(shape) ranks of the started process group, on
    ``device``'s type (``None``: the card, with NCCL; ``"cpu"`` only when
    asked, with gloo). Raises without a process group, or without a card
    unless the CPU was asked for; never falls back."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh_for: no process group; start one "
                           "with torch.distributed.init_process_group")
    shape, axes = best_mesh_shape(n_devices, **kw)
    n = 1
    for s in shape:
        n *= s
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a group of "
                         f"{dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def _clean(sp: Spec, shape, new_mesh) -> Spec:
    """``sp`` on ``new_mesh``: axes the mesh lacks dropped, and a dim that
    its axes no longer divide replicated (the reference's rules)."""
    lay = layout(new_mesh)
    clean = []
    for ax in (sp if sp is not None else ()):
        if ax is None:
            clean.append(None)
        elif isinstance(ax, (tuple, list)):
            keep = tuple(a for a in ax if a in lay.axis_names)
            clean.append(keep if keep else None)
        else:
            clean.append(ax if ax in lay.axis_names else None)
    final = []
    for dim, ax in zip(shape, clean):
        n = 1
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            n *= lay.shape[a]
        final.append(ax if n > 1 and dim % n == 0 else None)
    return spec(*final)


def remap_state(state, specs, new_mesh):
    """Re-shard a state onto a new mesh, host-mediated: each tensor
    gathered whole (``full_tensor()``), then placed on ``new_mesh`` by its
    spec with :func:`_clean`'s rules. ``state`` is a tensor or a dict /
    tuple / NamedTuple of them; ``specs`` mirrors it with a spec per
    tensor. A leaf that is not a tensor (a cache's ``len``) passes as it
    is. Every rank of the old mesh takes part."""
    if isinstance(state, torch.Tensor):
        whole = state.full_tensor() if hasattr(state, "full_tensor") \
            else state
        return place(whole.detach(), _clean(specs, whole.shape, new_mesh),
                     new_mesh)
    if isinstance(state, dict):
        return {k: remap_state(v, specs[k], new_mesh)
                for k, v in state.items()}
    if isinstance(state, tuple):
        out = [remap_state(v, s, new_mesh) for v, s in zip(state, specs)]
        return type(state)(*out) if hasattr(state, "_fields") \
            else tuple(out)
    return state


@dataclasses.dataclass
class FleetState:
    """Launcher-side view of the fleet (heartbeat bookkeeping)."""
    n_devices: int
    healthy: Optional[Sequence[int]] = None
    generation: int = 0

    def fail(self, k: int = 1) -> "FleetState":
        return FleetState(self.n_devices - k, generation=self.generation + 1)

    def join(self, k: int = 1) -> "FleetState":
        return FleetState(self.n_devices + k, generation=self.generation + 1)
