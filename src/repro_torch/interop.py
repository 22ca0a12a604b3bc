"""numpy <-> torch at the format boundaries of the port.

The port keeps every fixed-width lane as a tensor on the engine's device,
with uint64 words stored as int64 tensors of the same bits. numpy appears
only at a boundary: generated input data, a digest, a test comparison.
These helpers map uint64 <-> int64 bits there and leave LOB columns (host
object arrays of bytes) as they are.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy array -> tensor on ``device``; uint64 keeps its bits as int64
    and uint32 as int32 (torch orders neither unsigned type)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def host_array(x: torch.Tensor) -> np.ndarray:
    """A tensor as numpy. A sanitized sealed lane (an inference tensor,
    ``core.objects.SANITIZE``) comes out read-only: on the CPU the array
    shares its memory, and numpy would otherwise write straight into it."""
    a = x.detach().cpu().numpy()
    if x.is_inference():
        a = a.view()
        a.setflags(write=False)
    return a


def to_numpy(x, *, u64: bool = False):
    """tensor (or dict of tensors / LOB arrays) -> numpy. ``u64=True``
    views int64 words as the uint64 values they hold."""
    if isinstance(x, dict):
        return {k: to_numpy(v, u64=u64) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x
    a = host_array(x)
    return a.view(np.uint64) if u64 and a.dtype == np.int64 else a


def from_numpy_batch(schema, batch: Dict[str, np.ndarray],
                     device="cpu") -> Dict[str, object]:
    """A numpy row batch -> the port's batch: fixed-width columns as
    tensors of the schema's dtype on ``device``, LOB columns as host
    object arrays of bytes."""
    return schema.normalize_batch(batch, device)


def host_tree(x):
    """A copy of ``x`` with every tensor inside it (nested in dicts,
    lists and tuples) as a numpy array: what a WAL record carries to a
    serialized store. Other values pass through as they are."""
    if torch.is_tensor(x):
        return host_array(x)
    if isinstance(x, dict):
        return {k: host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_tree(v) for v in x)
    return x
