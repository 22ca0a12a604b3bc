"""The reference's parameter tree as the port's state dict.

``params_from_numpy(cfg, tree)`` takes the tree of ``repro.models.lm.
init_params`` with its leaves as numpy arrays and returns the state dict
of :class:`repro_torch.models.lm.LM`: the stacked period axis P of every
block leaf is split into per-layer tensors (layer ``p * period + i`` is
period ``p``, slot ``i``). Values are carried bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ArchConfig


def _tensor(a) -> torch.Tensor:
    """numpy array -> CPU tensor with the same bits. bf16 arrays (numpy's
    ``bfloat16`` extension dtype, which ``torch.from_numpy`` rejects) are
    reinterpreted through 16-bit integers, without importing the package
    that defines the dtype."""
    a = np.array(a)     # a writable copy: the tensor owns its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(cfg: ArchConfig, tree) -> Dict[str, torch.Tensor]:
    sd = {name: _tensor(tree[name])
          for name in ("embed", "final_norm", "lm_head")}
    for i in range(cfg.period):
        for name, leaf in tree["blocks"][f"slot{i}"].items():
            stacked = np.asarray(leaf)
            for p in range(cfg.n_periods):
                sd[f"layers.{p * cfg.period + i}.{name}"] = \
                    _tensor(stacked[p])
    return sd
