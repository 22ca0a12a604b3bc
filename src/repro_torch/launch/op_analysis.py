"""Static cost of one step, per device, counted from torch's dispatch:
the port's counterpart of ``repro.launch.hlo_analysis``.

torch emits no HLO, so nothing is parsed: :func:`analyze_step` runs the
step under a ``TorchDispatchMode`` (on fake tensors in the dry run, so
nothing is allocated or launched) and counts, op by op,

  * flops             -- 2·K·numel(out) of every ``mm``, ``bmm``,
                         ``addmm``, ``baddbmm`` and ``convolution`` (K the
                         contracted size), and the flash ops by their
                         formula (``kernels.flash_attention.flops`` and
                         ``flash_attention_bwd.flops``);
  * dot_bytes         -- operand and output bytes of those ops, the
                         flash ops' too (the roofline's memory numerator,
                         as the reference's);
  * collective_bytes  -- operand bytes of every ``c10d_functional``
                         collective (and DTensor's ``shard_dim_alltoall``),
                         by kind under the reference's names, an all-reduce
                         at 2x (ring: a reduce-scatter and an all-gather).

Per device, on local shapes: on a DTensor op the mode steps aside
(returns ``NotImplemented``) and counts the local ops DTensor runs on
each rank's shards, and the collectives its redistributions issue.
DTensor's sharding propagation, which runs each new op once on
global-shape fake tensors to learn its output's shape, runs outside the
count (:func:`local_propagation`). Python loops (layers, microbatches,
attention blocks) unroll, so their trip counts need no bookkeeping.

On a CPU tensor the flash ops are counted as their plain versions,
traced op by op (their CPU registrations: attention in blocks of the
step's ``attn_block``, as the reference's XLA path computes it).

The reference halves a bf16 all-reduce that XLA:CPU promoted to float32
(``promoted``); torch does not promote a collective, so that rule has no
counterpart here.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: ops counted as 2·K·numel(out), with the positions of their two factors
DOTS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
        aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2),
        aten.convolution.default: (0, 1)}

#: collective op names (``namespace::name``, by substring) -> the
#: reference's kind
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"))
_COLL_NAMESPACES = ("_c10d_functional", "_dtensor")


@dataclass
class Cost:
    flops: float = 0.0
    dot_bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.dot_bytes += other.dot_bytes * mult
        for k, v in other.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v * mult

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll.values()))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _dot_flops(func, a: torch.Tensor, b: torch.Tensor,
               out: torch.Tensor) -> float:
    """2·K·numel(out): K is a's last dim for the matrix products, the
    weight's numel per output channel for a convolution."""
    if func is aten.convolution.default:
        k = b.numel() // max(b.shape[0], 1)
    else:
        k = a.shape[-1]
    return 2.0 * k * out.numel()


def collective_kind(func) -> str:
    """The reference's kind of a collective op, or '' for any other op
    (``wait_tensor`` included)."""
    ns, _, name = func._schema.name.partition("::")
    if not ns.startswith(_COLL_NAMESPACES):
        return ""
    for key, kind in _KINDS:
        if key in name:
            return kind
    return ""


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether ``func`` has a decomposition into other ops (a
    CompositeImplicitAutograd kernel); ``prim`` ops have no entry."""
    try:
        return torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    except RuntimeError:
        return False


def _flash_ops():
    """The flash ops: (formula, plain version, index of ``causal`` in the
    op's arguments; ``window`` follows it)."""
    from ..kernels import flash_attention as fwd
    from ..kernels import flash_attention_bwd as bwd
    return {torch.ops.repro_torch.flash_attention.default:
            (fwd.flops, fwd._flash_cpu, 3),
            torch.ops.repro_torch.flash_attention_bwd.default:
            (bwd.flops, bwd._bwd_cpu, 6)}


class CostMode(TorchDispatchMode):
    """Counts one device's :class:`Cost` of the ops run under it (module
    docstring); ``cost`` holds the running total."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._flash = _flash_ops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented   # count the local ops DTensor runs
        if _composite(func):
            # an op that reaches the mode whole (einsum, called below
            # autograd in a plain version): counted by its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        flash = self._flash.get(func)
        if flash is not None:
            formula, plain, at = flash
            q, k = args[0], args[1]
            if q.device.type == "cpu":
                with self:          # the plain version, op by op
                    return plain(*args, **kwargs)
            out = func(*args, **kwargs)
            self.cost.flops += formula(tuple(q.shape), tuple(k.shape),
                                       args[at], args[at + 1])
            self.cost.dot_bytes += sum(
                _nbytes(t) for t in tree_flatten((args, out))[0])
            return out
        out = func(*args, **kwargs)
        if func in DOTS:
            i, j = DOTS[func]
            a, b = args[i], args[j]
            self.cost.flops += _dot_flops(func, a, b, out)
            self.cost.dot_bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
            return out
        kind = collective_kind(func)
        if kind:
            flat, _ = tree_flatten((args, kwargs))
            tot = float(sum(_nbytes(t) for t in flat))
            if kind == "all-reduce":
                tot *= 2.0
            self.cost.coll[kind] = self.cost.coll.get(kind, 0.0) + tot
        return out


class LiveBytes(TorchDispatchMode):
    """One rank's live tensor bytes over the ops run under it, and their
    peak: each storage an op's output brings counts from then until it
    is freed (a weak reference's callback), at its own size (no allocator
    rounding); views, in-place results and ``meta`` tensors add nothing.
    On a DTensor op
    the mode steps aside and sees the local ops, as :class:`CostMode`
    does. :meth:`track` counts tensors made before (the step's state and
    inputs; a DTensor by its local shard). :meth:`largest_at_peak` names
    the storages live at the peak, largest first."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}
        # every storage seen: [bytes, the op that made it, its shape,
        # when it came, when it went (None: still live)], on a clock of
        # arrivals; the peak's time on that clock
        self._log: list = []
        self._peak_at = 0
        self._op = "track"

    def _free(self, key: int, entry: list) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= entry[0]
            entry[4] = len(self._log)

    def _add(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        if hasattr(t, "to_local"):
            t = t.to_local()
        if t.device.type == "meta":     # shapes alone, no memory
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        entry = [st.nbytes(), self._op, tuple(t.shape), len(self._log), None]
        self._log.append(entry)
        self._refs[key] = weakref.ref(
            st, lambda _, key=key, entry=entry: self._free(key, entry))
        self.live += entry[0]
        if self.live > self.peak:
            self.peak, self._peak_at = self.live, len(self._log)

    def track(self, *trees) -> None:
        for t in tree_flatten(trees)[0]:
            self._add(t)

    def largest_at_peak(self, k: Optional[int] = 10) -> list:
        """The ``k`` (None: all) largest storages live at the peak:
        (bytes, the op that made it or 'track', shape)."""
        at = self._peak_at
        live = [e for e in self._log[:at] if e[4] is None or e[4] >= at]
        live.sort(key=lambda e: -e[0])
        return [(e[0], e[1], e[2]) for e in live[:k]]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func is not torch.ops._c10d_functional.wait_tensor.default:
            # (a collective's wait returns its input on the card)
            self._op = str(func)
            for t in tree_flatten(out)[0]:
                self._add(t)
        return out


#: DTensor's host-side planning: (module, owner attribute or None,
#: function): sharding propagation (an op's strategies and its output's
#: shape) and the redistribution planner
_PLANNING = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "propagate_op_sharding_non_cached"),
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor._redistribute", None,
     "_gen_transform_infos_non_cached"),
    # a strided shard's offsets, read when it is gathered
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
)


@contextlib.contextmanager
def local_propagation():
    """Run DTensor's host-side planning with every dispatch mode set
    aside. Sharding propagation runs an op once on global-shape fake
    tensors of its own to learn its output's shape, which is no rank's
    work, so no count or memory tracker may see it; and the planners
    compute shard offsets with small index tensors, which under the dry
    run's ``FakeTensorMode`` would be fake and unreadable."""
    import importlib

    from torch.utils._python_dispatch import _disable_current_modes

    def outside_modes(fn):
        def run(*args, **kw):
            with _disable_current_modes():
                return fn(*args, **kw)
        return run

    def wrapped(raw):
        if isinstance(raw, (staticmethod, classmethod)):
            return type(raw)(outside_modes(raw.__func__))
        return outside_modes(raw)

    saved = []
    for mod, owner, name in _PLANNING:
        obj = importlib.import_module(mod)
        if owner is not None:
            obj = getattr(obj, owner)
        saved.append((obj, name, vars(obj)[name]))
    try:
        for obj, name, raw in saved:
            setattr(obj, name, wrapped(raw))
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


@contextlib.contextmanager
def counting():
    """A context that counts one device's :class:`Cost` of what runs in
    it; yields the Cost, complete on exit."""
    mode = CostMode()
    with local_propagation(), mode:
        yield mode.cost


def analyze_step(fn, *args, **kw) -> Cost:
    """``fn(*args, **kw)`` run once under :func:`counting`: one device's
    flops, dot bytes and collective bytes (module docstring)."""
    with counting() as cost:
        fn(*args, **kw)
    return cost
