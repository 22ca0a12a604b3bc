"""The reference's parameter tree as the port's state dict, and back.

``params_from_numpy(cfg, tree)`` takes the tree of ``repro.models.lm.
init_params`` with its leaves as numpy arrays and returns the state dict
of :class:`repro_torch.models.lm.LM`: the stacked period axis P of every
block leaf is split into per-layer tensors (layer ``p * period + i`` is
period ``p``, slot ``i``). Values are carried bit for bit. Every leaf a
slot holds is carried by name, so the MoE's ``router`` (P, d, E) and
``moe_w1``/``moe_w3``/``moe_w2`` (P, E, d, d_ff) / (P, E, d_ff, d) go
both ways as the dense leaves do, and so do a mamba or rwkv slot's
leaves, each in its own dtype (the float32 ones stay float32 beside
bf16 matrices), a cross slot's, and the cross sublayer's ``ln_x``,
``xq``..``xo``. An encoder-decoder config's ``encoder`` tree is split
over its own stacked axis of ``encoder_layers`` (encoder layer ``e`` is
``encoder.e.<name>``), and the learned positions ``pos``/``enc_pos`` and
``enc_norm`` are top-level leaves like ``embed``.

The way back, :func:`stack_tree` (tensors) and :func:`params_to_numpy`,
rebuilds the reference's stacked tree from any dict keyed like the state
dict (the parameters, or the optimizer's moments): what the checkpoints
store, leaf for leaf. :func:`opt_state_from_numpy` takes the reference's
``OptState(step, mu, nu)``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..optim import OptState

#: the top-level leaves a tree may hold (every other leaf is a layer's
#: or an encoder layer's, stacked in the reference's tree)
TOP = ("embed", "final_norm", "lm_head", "pos", "enc_pos", "enc_norm")


def _tensor(a) -> torch.Tensor:
    """numpy array -> CPU tensor with the same bits. bf16 arrays (numpy's
    ``bfloat16`` extension dtype, which ``torch.from_numpy`` rejects) are
    reinterpreted through 16-bit integers, without importing the package
    that defines the dtype."""
    a = np.array(a)     # a writable copy: the tensor owns its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def unstack_tree(cfg: ArchConfig, tree) -> Dict[str, torch.Tensor]:
    """The reference's nested, period-stacked tree (tensor leaves) -> a
    dict keyed like :class:`LM`'s state dict (views of the leaves)."""
    sd = {name: tree[name] for name in TOP if name in tree}
    for i in range(cfg.period):
        for name, stacked in tree["blocks"][f"slot{i}"].items():
            for p in range(cfg.n_periods):
                sd[f"layers.{p * cfg.period + i}.{name}"] = stacked[p]
    for name, stacked in tree.get("encoder", {}).items():
        for e in range(cfg.encoder_layers):
            sd[f"encoder.{e}.{name}"] = stacked[e]
    return sd


def stacked_ndim(name: str, t: torch.Tensor) -> int:
    """Dimensions of the leaf ``name`` of a state dict in the reference's
    tree, where every layer leaf carries the period axis and every
    encoder leaf the encoder's: the reference's ndim rules (weight
    decay, the injected fault) read this."""
    return t.dim() + (0 if name in TOP else 1)


def stack_tree(cfg: ArchConfig, flat: Dict[str, torch.Tensor]) -> Dict:
    """A dict keyed like :class:`LM`'s state dict -> the reference's
    nested tree: top-level leaves as they are, each layer leaf stacked
    over the periods of its slot and each encoder leaf over the encoder's
    layers (new tensors)."""
    tree: Dict = {name: flat[name] for name in TOP if name in flat}
    tree["blocks"] = {
        f"slot{i}": _stack(flat, [f"layers.{p * cfg.period + i}"
                                  for p in range(cfg.n_periods)])
        for i in range(cfg.period)}
    if cfg.is_encdec:
        tree["encoder"] = _stack(flat, [f"encoder.{e}"
                                        for e in range(cfg.encoder_layers)])
    return tree


def _stack(flat: Dict[str, torch.Tensor], rows) -> Dict:
    """Each leaf under the state-dict prefixes ``rows`` (one per row of
    the stacked axis, in order), stacked."""
    first = rows[0] + "."
    names = sorted(k[len(first):] for k in flat if k.startswith(first))
    return {name: torch.stack([flat[f"{row}.{name}"] for row in rows])
            for name in names}


def params_from_numpy(cfg: ArchConfig, tree) -> Dict[str, torch.Tensor]:
    sd = unstack_tree(cfg, {
        **{name: _tensor(tree[name]) for name in TOP if name in tree},
        "blocks": {slot: {name: _tensor(leaf) for name, leaf in sp.items()}
                   for slot, sp in tree["blocks"].items()
                   if int(slot[4:]) < cfg.period},
        "encoder": {name: _tensor(leaf)
                    for name, leaf in tree.get("encoder", {}).items()}})
    return {k: v.clone() for k, v in sd.items()}   # each owns its memory


def _numpy(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(np.uint16)
    return a.numpy()


def params_to_numpy(cfg: ArchConfig, flat: Dict[str, torch.Tensor]) -> Dict:
    """:func:`stack_tree` with numpy leaves: the reference's tree, leaf for
    leaf. numpy has no bfloat16 of its own: a bf16 leaf comes back as its
    uint16 bits (``.view(jnp.bfloat16)`` gives the reference's dtype)."""
    tree = stack_tree(cfg, flat)
    out: Dict = {name: _numpy(tree[name]) for name in TOP if name in tree}
    out["blocks"] = {slot: {name: _numpy(leaf)
                            for name, leaf in sp.items()}
                     for slot, sp in tree["blocks"].items()}
    if "encoder" in tree:
        out["encoder"] = {name: _numpy(leaf)
                          for name, leaf in tree["encoder"].items()}
    return out


def opt_state_from_numpy(cfg: ArchConfig, opt) -> OptState:
    """The reference's ``OptState(step, mu, nu)`` (numpy leaves) -> the
    port's, keyed like :class:`LM`'s state dict, on the CPU."""
    return OptState(torch.from_numpy(np.array(opt.step, np.int32)),
                    params_from_numpy(cfg, opt.mu),
                    params_from_numpy(cfg, opt.nu))
