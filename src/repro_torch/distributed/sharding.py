"""Sharding: the model half of ``repro.distributed.sharding`` (every
parameter, activation and cache tensor mapped to a spec on a mesh of
``pod`` x ``data`` x ``model`` axes, and DTensor placements from it), and
the 128-bit KEY-RANGE shard planner for the VCS Δ/merge pipeline.

A spec is a tuple of axis names, one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of names (the dim split over
several axes). It equals ``tuple()`` of the reference's ``PartitionSpec``
(which writes a one-name tuple as the name and an empty one as ``None``).
The spec functions take a mesh *layout*: a ``DeviceMesh``, a
:class:`MeshLayout`, or a dict of axis sizes in mesh order, so that the
production meshes (16 x 16, 2 x 16 x 16) are checked without their ranks.
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(i)`` on each mesh dim named at tensor dim i, else
``Replicate()``. DTensor splits a dim named by several axes in mesh order
(``("data", "pod")`` pod-major), where the reference splits it in the
spec's order: the values are the same, the chunk a rank holds may not be
(ROADMAP Queue 3).

The reference stacks each slot's layers over a leading period axis; the
port keeps one module per layer. :func:`leaf_spec` gives a per-layer leaf
the stacked leaf's spec minus its leading ``None``, keyed by the state
dict's names (``layers.<l>.<name>``, ``encoder.<e>.<name>``).

Key-range sharding (bottom of this module): sealed objects and Δ streams
are sorted by 128-bit key signature, so merge and diff aggregation are
embarrassingly partitionable on key ranges. ``plan_key_cuts`` picks
boundary keys by rank-sum over the presorted runs; ``kernels.ops``
executes the plan byte-identically to the unsharded path. Shard plans are
DERIVED state — a pure function of the immutable lanes and the device
count — and are never WAL-logged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels import ops as _ops

#: a spec entry: None, an axis name, or a tuple of names
Spec = Tuple


@dataclasses.dataclass(frozen=True)
class ShardCfg:
    """Knobs for the sharding strategy (the reference's fields)."""
    fsdp: bool = True            # shard params/opt-state over 'data'
    tp: bool = True              # shard heads/ffn/experts/vocab over 'model'
    seq_shard_cache: bool = False  # SP: shard decode KV cache seq over 'data'
    cache_seq_model: bool = False  # shard cache seq over 'model' when the
    #                                kv-head count doesn't divide the TP axis
    seq_parallel: bool = False   # residual activations seq-sharded over
    #                              'model' between blocks
    grad_compress_bf16: bool = False


class MeshLayout(NamedTuple):
    """A mesh's axis names and sizes, in mesh order, without its ranks."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def layout(mesh) -> MeshLayout:
    """The :class:`MeshLayout` of a ``DeviceMesh``, a ``MeshLayout`` or a
    dict of axis sizes in mesh order."""
    if isinstance(mesh, MeshLayout):
        return mesh
    if isinstance(mesh, dict):
        return MeshLayout(tuple(mesh), tuple(int(n) for n in mesh.values()))
    return MeshLayout(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _entry(ax):
    """A spec entry as the reference's ``PartitionSpec`` writes it."""
    if isinstance(ax, (tuple, list)):
        ax = tuple(ax)
        return None if not ax else (ax[0] if len(ax) == 1 else ax)
    return ax


def spec(*parts) -> Spec:
    return tuple(_entry(a) for a in parts)


def _dp_axes(mesh) -> Tuple[str, ...]:
    names = layout(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_size(mesh) -> int:
    shape = layout(mesh).shape
    return int(np.prod([shape[a] for a in _dp_axes(mesh)]))


def batch_spec(mesh) -> Spec:
    return spec(_dp_axes(mesh))


def param_spec(cfg: ArchConfig, sc: ShardCfg, path: str,
               shape: Tuple[int, ...], mesh) -> Spec:
    """Spec of one parameter of the reference's tree, identified by its
    path (the last part is read) and its stacked shape: the reference's
    rules, name by name."""
    lay = layout(mesh)
    model = "model" if sc.tp else None
    fsdp = "data" if (sc.fsdp and "data" in lay.axis_names) else None

    def div(dim, ax):
        """axis name if the dim divides evenly, else None."""
        if ax is None:
            return None
        n = lay.shape.get(ax, 1)
        return ax if dim % n == 0 and dim >= n else None

    name = path.replace(".", "/").split("/")[-1]
    if name == "embed":
        return spec(div(shape[0], model), div(shape[1], fsdp))
    if name == "lm_head":
        return spec(div(shape[0], fsdp), div(shape[1], model))
    if name in ("pos", "enc_pos"):
        return spec(None, div(shape[1], fsdp))
    # stacked per-period weights: leading dim = n_periods (never shard)
    if name in ("wq", "xq", "wk", "wv", "xk", "xv", "w1", "w3", "w_in",
                "w_bcdt", "w_r", "w_k", "w_v", "w_g", "w_dec", "w_o"):
        return spec(None, div(shape[1], fsdp), div(shape[2], model))
    if name in ("wo", "xo", "w2", "w_out"):
        return spec(None, div(shape[1], model), div(shape[2], fsdp))
    if name in ("moe_w1", "moe_w3"):    # (P, E, d, ff)
        if div(shape[1], model):        # EP: experts across the model axis
            return spec(None, model, div(shape[2], fsdp), None)
        # expert count does not divide: TP over the ffn dim instead
        return spec(None, None, div(shape[2], fsdp), div(shape[3], model))
    if name == "moe_w2":                # (P, E, ff, d)
        if div(shape[1], model):
            return spec(None, model, None, div(shape[3], fsdp))
        return spec(None, None, div(shape[2], model), div(shape[3], fsdp))
    if name == "router":                # (P, d, E)
        return spec(None, div(shape[1], fsdp), None)
    if name == "conv":                  # (P, d_conv, di)
        return spec(None, None, div(shape[2], model))
    return spec(*([None] * len(shape)))  # small vectors: replicate


#: the port's parameters that the reference does not stack over periods
UNSTACKED = ("embed", "lm_head", "pos", "enc_pos", "final_norm", "enc_norm")


def leaf_spec(cfg: ArchConfig, sc: ShardCfg, name: str,
              shape: Tuple[int, ...], mesh) -> Spec:
    """Spec of one leaf of the port's state dict: a per-layer leaf
    (``layers.<l>.<n>``, ``encoder.<e>.<n>``) takes the spec of the
    reference's stacked leaf minus its leading ``None``; the rest
    (:data:`UNSTACKED`) take theirs as they are."""
    shape = tuple(shape)
    if name.split(".")[-1] in UNSTACKED:
        return param_spec(cfg, sc, name, shape, mesh)
    return param_spec(cfg, sc, name, (1,) + shape, mesh)[1:]


def tree_param_specs(cfg: ArchConfig, sc: ShardCfg, params, mesh) -> Dict:
    """Specs of a state dict's leaves (tensors, ``meta`` ones too, or
    shapes), keyed alike (:func:`leaf_spec`)."""
    return {n: leaf_spec(cfg, sc, n, tuple(getattr(p, "shape", p)), mesh)
            for n, p in params.items()}


def cache_spec(cfg: ArchConfig, sc: ShardCfg, path: str,
               shape: Tuple[int, ...], mesh) -> Spec:
    """Spec of a decode-cache tensor (the reference's rules).

    Default: batch over (pod, data), kv-heads over model (when divisible).
    With ``seq_shard_cache`` the cache *sequence* dim is sharded over
    'data'; with ``cache_seq_model`` it goes over 'model' where the
    kv-heads do not divide it."""
    lay = layout(mesh)
    name = path.replace(".", "/").split("/")[-1]
    dp = _dp_axes(mesh)
    msize = lay.shape.get("model", 1)

    def batch(b):
        if b % int(np.prod([lay.shape[a] for a in dp])) == 0:
            return dp
        return dp[0] if b % lay.shape[dp[0]] == 0 else None

    if name == "len":
        return ()
    if len(shape) == 5:  # (Pd, B, S, KV, hd) attention / cross caches
        b, s, kv = shape[1], shape[2], shape[3]
        bspec = batch(b)
        if sc.seq_shard_cache:
            sspec = "data" if s % lay.shape.get("data", 1) == 0 else None
            bspec = "pod" if ("pod" in lay.axis_names
                              and b % lay.shape["pod"] == 0) else None
            return spec(None, bspec, sspec,
                        "model" if kv % msize == 0 else None, None)
        if kv % msize == 0:
            return spec(None, bspec, None, "model", None)
        if sc.cache_seq_model and s % msize == 0:
            return spec(None, bspec, "model", None, None)
        return spec(None, bspec, None, None, None)
    if len(shape) >= 3:  # ssm/rwkv states: (Pd, B, ...)
        bspec = batch(shape[1])
        rest = [None] * (len(shape) - 2)
        # shard the widest state dim over model when possible
        widest = int(np.argmax(shape[2:]))
        if shape[2 + widest] % msize == 0:
            rest[widest] = "model"
        return spec(None, bspec, *rest)
    return spec(*([None] * len(shape)))


def tree_cache_specs(cfg: ArchConfig, sc: ShardCfg, cache, mesh):
    """Specs of a cache (``lm.init_cache``'s layout), keyed alike: a
    state-space slot's tuple gets a tuple (paths ``slot<i>/0``, ``/1``),
    ``len`` the empty spec."""
    out = {}
    for key, val in cache.items():
        if key == "len":
            out[key] = ()
        elif isinstance(val, dict):
            out[key] = {n: cache_spec(cfg, sc, f"{key}/{n}", tuple(t.shape),
                                      mesh) for n, t in val.items()}
        else:
            out[key] = tuple(cache_spec(cfg, sc, f"{key}/{i}",
                                        tuple(t.shape), mesh)
                             for i, t in enumerate(val))
    return out


# -------------------------------------------------------- at-use constraints

def at_use_spec(sp: Spec, drop_leading: bool = True) -> Spec:
    """Compute-time spec of an FSDP-stored weight: the 'data' (FSDP) axis is
    gathered at use, TP axes stay; the leading stacked period dim is
    stripped (``drop_leading``; the port's per-layer specs have none)."""
    parts = list(sp) if sp is not None else []
    if drop_leading and parts:
        parts = parts[1:]
    return spec(*[None if a == "data" else a for a in parts])


def placements(sp: Spec, mesh):
    """DTensor placements of ``sp`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` if its axis is named at tensor dim i, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in layout(mesh).axis_names:
        dims = [i for i, e in enumerate(sp)
                if e == ax or (isinstance(e, tuple) and ax in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor's package
    (a one-device path never loads it)."""
    return type(t).__name__ == "DTensor"


def place(t: torch.Tensor, sp: Spec, mesh):
    """``t`` (a plain tensor, the same on every rank) as a DTensor on
    ``mesh`` placed by ``sp``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(sp, mesh))


def place_tree(tree, specs, mesh):
    """:func:`place` over a tree: a dict, tuple or NamedTuple of tensors
    with ``specs`` mirroring it (a spec per tensor); a DTensor is
    redistributed (:func:`to_spec`), and a leaf that is not a tensor (a
    cache's ``len``) passes as it is."""
    if isinstance(tree, torch.Tensor):
        if is_dtensor(tree):
            return to_spec(tree, specs, mesh)
        return place(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [place_tree(v, sp, mesh) for v, sp in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def zeros_tree(tree, specs, mesh, device):
    """Zeros shaped like ``tree``'s tensors (``meta`` ones will do), on
    ``device``, each a DTensor on ``mesh`` placed by its spec in
    ``specs``, leaves that are not tensors passing as they are: each rank
    allocates only its shards (:func:`place_tree` of whole zeros would
    first make the whole tree on every rank)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.Tensor):
        pls = placements(specs, mesh)
        lshape, _ = local_shape_and_offset(tree.shape, mesh, pls)
        return DTensor.from_local(
            torch.zeros(lshape, dtype=tree.dtype, device=device), mesh, pls,
            run_check=False, shape=tree.shape,
            stride=torch.empty(tree.shape, device="meta").stride())
    if isinstance(tree, dict):
        return {k: zeros_tree(v, specs[k], mesh, device)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [zeros_tree(v, sp, mesh, device) for v, sp in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def local_shape_and_offset(shape, mesh, pls):
    """This rank's shard shape and its offset in a tensor of global
    ``shape`` placed by ``pls`` on ``mesh`` (DTensor's
    ``compute_local_shape_and_global_offset``). DTensor reads the offsets
    from small index tensors; under ``FakeTensorMode`` (the dry run) those
    would be fake and unreadable, so they are made with the fake mode set
    aside."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(shape, mesh, pls)


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """``t`` (..., n * hd) as (..., n, hd). On a DTensor whose last dim
    is split over a mesh dim that ``n`` does not divide (8 KV heads over
    a 16-wide 'model' axis), that mesh dim is gathered first: DTensor
    cannot unflatten an uneven split (the reference's GSPMD reshards
    alike). The values are the same either way."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        mesh, last = t.device_mesh, t.ndim - 1
        pl = [Replicate() if p.is_shard(last) and n % mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(*t.shape[:-1], n, hd)


def write(dst: torch.Tensor, idx: tuple, src: torch.Tensor) -> None:
    """``dst[idx] = src`` in place, ``idx`` a tuple of ints and step-1
    slices over ``dst``'s leading dims. On a DTensor ``dst`` each rank
    writes the part of ``src`` (taken whole) that falls in its own shard,
    so a write along a sharded dim (a cache's sequence over 'model') lands
    where DTensor's own indexing would copy."""
    if not is_dtensor(dst):
        dst[idx] = src
        return
    whole = src.full_tensor() if is_dtensor(src) else src
    lshape, off = local_shape_and_offset(dst.shape, dst.device_mesh,
                                         dst.placements)
    lidx, sidx = [], []
    for d, ix in enumerate(idx):
        lo, n = off[d], lshape[d]
        if isinstance(ix, int):
            if not lo <= ix < lo + n:
                return              # not in this rank's shard
            lidx.append(ix - lo)
            continue
        a, b, _ = ix.indices(dst.shape[d])
        a2, b2 = max(a, lo), min(b, lo + n)
        if a2 >= b2:
            return
        lidx.append(slice(a2 - lo, b2 - lo))
        sidx.append(slice(a2 - a, b2 - a))
    rest = dst.ndim - len(idx)      # trailing dims: this rank's part
    for d in range(dst.ndim - rest, dst.ndim):
        sidx.append(slice(off[d], off[d] + lshape[d]))
    dst.to_local()[tuple(lidx)] = whole[tuple(sidx)].to(dst.dtype)


def to_spec(t, sp: Spec, mesh):
    """A DTensor redistributed to ``sp``'s placements (the counterpart of
    the reference's ``with_sharding_constraint``)."""
    want = placements(sp, mesh)
    return t if tuple(t.placements) == want else t.redistribute(mesh, want)


class ModelSharding:
    """Sharding constraints applied INSIDE the model (activations and
    gather-at-use weights), as ``redistribute``s to their at-use
    placements: each weight's 'data' (FSDP) axis gathered, its 'model'
    axis kept. Constructed by ``launch.steps`` from the parameters'
    specs; ``None`` in the model disables all constraints."""

    def __init__(self, cfg: ArchConfig, sc: ShardCfg, mesh, params):
        self.cfg = cfg
        self.mesh = mesh
        self.dp = _dp_axes(mesh)
        self.sc = sc
        specs = tree_param_specs(cfg, sc, params, mesh)
        self.block_use: Dict[str, Dict[str, Spec]] = {}
        self.enc_use: Optional[Dict[str, Spec]] = None
        for n, sp in specs.items():
            parts = n.split(".")
            if parts[0] == "layers":
                slot = f"slot{int(parts[1]) % cfg.period}"
                self.block_use.setdefault(slot, {})[parts[2]] = \
                    at_use_spec(sp, drop_leading=False)
            elif parts[0] == "encoder":
                if self.enc_use is None:
                    self.enc_use = {}
                self.enc_use[parts[2]] = at_use_spec(sp, drop_leading=False)
        self.embed_use = at_use_spec(specs["embed"], drop_leading=False)
        self.head_use = at_use_spec(specs["lm_head"], drop_leading=False)

    def _wsc(self, x, sp):
        return to_spec(x, sp, self.mesh)

    def act(self, x):
        """(B, S, d) activations: batch over DP axes; with seq_parallel the
        sequence dim additionally shards over 'model'."""
        if x.shape[0] % dp_size(self.mesh):
            return x
        sp = None
        if (self.sc.seq_parallel and x.ndim == 3
                and x.shape[1] % layout(self.mesh).shape.get("model", 1)
                == 0):
            sp = "model"
        return self._wsc(x, spec(self.dp, sp, *([None] * (x.ndim - 2))))

    def lookup(self, tokens, w):
        """``w[tokens]`` for a DTensor ``w`` (vocab, d) at its at-use
        placements, through ``local_map``: the tokens' batch over the DP
        axes; where the vocab is split (over 'model'), each rank takes
        the rows of its own vocab shard and zeros for the rest, a partial
        sum over that axis (DTensor's masked-partial rule for an
        embedding, written out). On a mesh that splits nothing, each rank
        indexes its whole table, the one-device path's op, so the
        gradient sums its rows in the same order."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        mesh = self.mesh
        dp = self.dp if tokens.shape[0] % dp_size(mesh) == 0 else ()
        w_pl = tuple(Shard(0) if p.is_shard(0) else Replicate()
                     for p in w.placements)
        split = [i for i, p in enumerate(w_pl)
                 if p.is_shard(0) and mesh.size(i) > 1]
        tok_pl = tuple(Shard(0) if a in dp else Replicate()
                       for a in mesh.mesh_dim_names)
        out_pl = tuple(Partial() if i in split else tok_pl[i]
                       for i in range(mesh.ndim))
        # each batch shard's rows give a part of the table's gradient
        grad_pl = tuple(Partial() if tok_pl[i].is_shard(0) else w_pl[i]
                        for i in range(mesh.ndim))
        lo = local_shape_and_offset(w.shape, mesh, w_pl)[1][0]

        def rows(tok, table):
            if not split:
                return table[tok]
            idx = tok - lo
            keep = (idx >= 0) & (idx < table.shape[0])
            got = table[idx.clamp(0, table.shape[0] - 1)]
            return torch.where(keep[..., None], got, got.new_zeros(()))

        run = local_map(rows, out_placements=(out_pl,),
                        in_placements=(tok_pl, w_pl),
                        in_grad_placements=(tok_pl, grad_pl),
                        device_mesh=mesh, redistribute_inputs=True)
        return run(tokens, w)

    def rows(self, x):
        """``x`` with its batch over the DP axes (where it divides) and
        every other dim whole: the loss's logits."""
        dp = self.dp if x.shape[0] % dp_size(self.mesh) == 0 else None
        return self._wsc(x, spec(dp, *([None] * (x.ndim - 1))))

    def row_sums(self, fn, logits, targets):
        """``fn(logits, targets) -> (a, b)``, two sums over the rows, run
        by each rank on its rows of :meth:`rows`' placement (every vocab
        column whole) through ``local_map``: the sums come back
        replicated. DTensor's own ``gather`` over the logits would take
        its gradient through ``new_zeros`` of the global logits' shape,
        which DTensor makes replicated: the whole batch's float32 logits
        on every rank."""
        from torch.distributed.tensor import Partial, Replicate
        from torch.distributed.tensor.experimental import local_map
        logits = self.rows(logits)
        pl = tuple(logits.placements)
        summed = tuple(Partial() if p.is_shard(0) else Replicate()
                       for p in pl)
        run = local_map(fn, out_placements=(summed, summed),
                        in_placements=(pl, pl), device_mesh=self.mesh,
                        redistribute_inputs=True)
        whole = [Replicate()] * self.mesh.ndim
        return tuple(x.redistribute(self.mesh, whole)
                     for x in run(logits, targets))

    def pslice(self, slot: str, tree):
        use = self.block_use.get(slot)
        if use is None:
            return tree
        return {k: (self._wsc(v, use[k]) if k in use else v)
                for k, v in tree.items()}

    def encslice(self, tree):
        if self.enc_use is None:
            return tree
        return {k: (self._wsc(v, self.enc_use[k]) if k in self.enc_use
                    else v) for k, v in tree.items()}

    def embed(self, w):
        return self._wsc(w, self.embed_use)

    def head(self, w):
        return self._wsc(w, self.head_use)

    def place_cache(self, cache):
        """A cache (``lm.init_cache``'s layout) placed on the mesh by
        :func:`tree_cache_specs` of this strategy."""
        return place_tree(cache, tree_cache_specs(self.cfg, self.sc, cache,
                                                  self.mesh), self.mesh)

    def zero_cache(self, cache, device):
        """A zero cache shaped like ``cache`` (``lm.init_cache``'s layout,
        ``meta`` tensors will do) on ``device``, placed as
        :meth:`place_cache` places one; each rank makes only its shards."""
        return zeros_tree(cache, tree_cache_specs(self.cfg, self.sc, cache,
                                                  self.mesh), self.mesh,
                          device)

    def replicate(self, t: torch.Tensor):
        """A plain tensor (the same on every rank) as a DTensor replicated
        over the mesh: positions, the aux loss's zero."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh,
                                  placements(spec(*[None] * t.dim()),
                                             self.mesh),
                                  run_check=False)


# --------------------------------------------------------------------------
# 128-bit key-range sharding for the VCS Δ/merge pipeline
# --------------------------------------------------------------------------

#: shard sizing: one shard per ~object-capacity of stream rows
KEY_SHARD_TARGET_ROWS = 1 << 18
#: auto-sharding floor: below this, split/concat overhead beats the win
KEY_SHARD_MIN_ROWS = 1 << 20
#: cap on auto shard counts (plan cost is runs x cuts searchsorteds)
KEY_SHARD_MAX = 16

_FORCED_KEY_SHARDS: Optional[int] = None


def set_key_shards(n: Optional[int]) -> Optional[int]:
    """Force the shard count (tests / operators); ``None`` restores the
    auto policy. Returns the previous override so callers can restore."""
    global _FORCED_KEY_SHARDS
    prev = _FORCED_KEY_SHARDS
    _FORCED_KEY_SHARDS = n
    return prev


def key_shard_count(n_rows: int) -> int:
    """How many key-range shards an ``n_rows`` merge/aggregate should use.

    1 (off) below KEY_SHARD_MIN_ROWS; above it, a host with several CUDA
    devices splits one shard per device, and otherwise the stream splits
    into object-capacity-sized partitions. Outputs are byte-identical
    either way."""
    if _FORCED_KEY_SHARDS is not None:
        return max(1, int(_FORCED_KEY_SHARDS))
    if n_rows < KEY_SHARD_MIN_ROWS:
        return 1
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        return min(n_dev, KEY_SHARD_MAX)
    return int(min(KEY_SHARD_MAX, max(2, n_rows // KEY_SHARD_TARGET_ROWS)))


def plan_key_cuts(lo: torch.Tensor, hi: torch.Tensor, runs: np.ndarray,
                  shards: int):
    """Boundary keys splitting presorted runs into ``shards`` balanced
    key ranges, by rank-sum over the run starts.

    Candidates are each run's local quantile keys; a candidate's global
    rank is the sum over runs of its exact 128-bit lower bound, and the
    candidate nearest each target rank ``i*n/shards`` wins. Returns
    ``(cut_lo, cut_hi)`` word tensors — ascending, distinct, possibly
    fewer than ``shards - 1`` — or ``None`` when no usable interior
    boundary exists."""
    n = int(lo.shape[0])
    runs = np.asarray(runs, np.int64)
    k = runs.shape[0]
    if shards <= 1 or n == 0 or k <= 1:
        return None
    bounds = np.append(runs, n)
    cand_parts = []
    for r in range(k):
        a, b = int(bounds[r]), int(bounds[r + 1])
        if b > a:
            cand_parts.append(
                a + (np.arange(1, shards, dtype=np.int64) * (b - a)) // shards)
    if not cand_parts:
        return None
    cand_idx = torch.from_numpy(np.concatenate(cand_parts)).to(lo.device)
    c_lo, c_hi = lo[cand_idx], hi[cand_idx]
    ranks = torch.zeros((cand_idx.shape[0],), dtype=torch.int64,
                        device=lo.device)
    for r in range(k):
        a, b = int(bounds[r]), int(bounds[r + 1])
        ranks += _ops.searchsorted128(lo[a:b], hi[a:b], c_lo, c_hi,
                                      side="left")
    ranks = ranks.cpu().numpy()
    # candidate keys as unsigned python ints: the plan is host metadata
    keys_lo = c_lo.cpu().numpy().view(np.uint64)
    keys_hi = c_hi.cpu().numpy().view(np.uint64)
    chosen = []
    for j in range(1, shards):
        target = (j * n) // shards
        pick = int(np.argmin(np.abs(ranks - target)))
        rank = int(ranks[pick])
        key = (int(keys_lo[pick]), int(keys_hi[pick]))
        # degenerate cuts (empty first/last shard) and non-ascending picks
        # are dropped: fewer shards, never a wrong plan
        if rank <= 0 or rank >= n or (chosen and key <= chosen[-1]):
            continue
        chosen.append(key)
    if not chosen:
        return None
    cut = np.array(chosen, np.uint64).view(np.int64)
    cut = torch.from_numpy(np.ascontiguousarray(cut)).to(lo.device)
    return cut[:, 0].contiguous(), cut[:, 1].contiguous()


def maybe_key_cuts(lo: torch.Tensor, hi: torch.Tensor, runs):
    """The one-call shard plan: ``None`` (stay unsharded) unless the
    stream is big enough AND has real multi-run structure to merge."""
    if runs is None or runs.shape[0] <= 1:
        return None
    shards = key_shard_count(int(lo.shape[0]))
    if shards <= 1:
        return None
    return plan_key_cuts(lo, hi, runs, shards)
