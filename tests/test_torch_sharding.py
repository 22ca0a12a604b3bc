"""The sharded model stack's pure functions against the reference, on the
CPU without processes: every spec of ``distributed/sharding.py`` and
``launch/steps.py``, the int8 compression and error feedback of
``distributed/collectives.py``, and ``distributed/elastic.py``'s mesh
choice and fleet bookkeeping.

Specs are compared as tuples: the port's spec against ``tuple()`` of the
reference's ``PartitionSpec``, on the same mesh description (a
``jax.sharding.AbstractMesh`` for the reference, a dict of axis sizes for
the port): the production layouts 16 x 16 (data, model) and 2 x 16 x 16
(pod, data, model), every registered config at its published widths,
and each ``ShardCfg`` flag turned from its default. The port's leaves
are per layer (``layers.<l>.<name>``): each is held against its row of
the reference's stacked leaf, the stacked spec less its leading
``None``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as r_base
from repro.configs import get_config as r_get_config
from repro.distributed import collectives as r_coll
from repro.distributed import elastic as r_elastic
from repro.distributed import sharding as r_sharding
from repro.launch import steps as r_steps
from repro.models import lm as r_lm
from repro.optim import adamw as r_adamw
from repro_torch.configs import ShapeCfg, all_arch_names, get_config
from repro_torch.distributed import collectives, elastic, sharding
from repro_torch.launch import steps
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWCfg

LAYOUTS = {"16x16": {"data": 16, "model": 16},
           "2x16x16": {"pod": 2, "data": 16, "model": 16}}
#: the default strategy and each flag turned from its default
FLAGS = [{}] + [{f.name: not f.default}
                for f in dataclasses.fields(sharding.ShardCfg)]


def _meshes(layout):
    lay = LAYOUTS[layout]
    return AbstractMesh(tuple(lay.values()), tuple(lay)), lay


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's abstract parameter tree at published widths."""
    cfg = r_get_config(arch)
    return jax.eval_shape(functools.partial(r_lm.init_params, cfg),
                          jax.random.PRNGKey(0))


def _paths(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield "/".join(str(getattr(k, "key", k)) for k in path), leaf


def _ref_leaf(cfg, name):
    """A port state-dict name -> (the reference's path, stacked or not)."""
    bits = name.split(".")
    if bits[0] == "layers":
        return f"blocks/slot{int(bits[1]) % cfg.period}/{bits[2]}", True
    if bits[0] == "encoder":
        return f"encoder/{bits[2]}", True
    return name, False


def test_shard_cfg_has_the_reference_s_fields():
    assert [(f.name, f.default) for f in
            dataclasses.fields(sharding.ShardCfg)] == \
        [(f.name, f.default) for f in dataclasses.fields(r_sharding.ShardCfg)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", all_arch_names())
def test_param_and_opt_specs_match_the_reference(arch, layout):
    """``param_spec`` on every stacked leaf of the reference's tree,
    ``leaf_spec`` / ``tree_param_specs`` on every leaf of the port's
    state dict (its row of the stacked leaf), and the optimizer state's
    specs (``_opt_specs``: FSDP extended over 'pod'), for each flag."""
    r_mesh, mesh = _meshes(layout)
    rcfg, tcfg = r_get_config(arch), get_config(arch)
    ref = _ref_params(arch)
    ref_leaves = dict(_paths(ref))
    port = dict(LM(tcfg, device="meta").named_parameters())
    # every reference leaf has its port leaves and no more
    assert {_ref_leaf(tcfg, n)[0] for n in port} == set(ref_leaves)
    for flags in FLAGS:
        rsc, tsc = r_sharding.ShardCfg(**flags), sharding.ShardCfg(**flags)
        want = {p: tuple(r_sharding.param_spec(rcfg, rsc, p, leaf.shape,
                                               r_mesh))
                for p, leaf in ref_leaves.items()}
        for p, leaf in ref_leaves.items():
            assert sharding.param_spec(tcfg, tsc, p, leaf.shape, mesh) \
                == want[p], (p, flags)
        r_opt = r_steps._opt_specs(rcfg, rsc, ref, r_mesh)
        r_opt = {p: tuple(s) for p, s in zip(
            ref_leaves, jax.tree_util.tree_leaves(
                r_opt, is_leaf=lambda s: isinstance(s, jax.sharding
                                                    .PartitionSpec)))}
        got = sharding.tree_param_specs(tcfg, tsc, port, mesh)
        got_opt = steps._opt_specs(tcfg, tsc, port, mesh)
        for n in port:
            p, stacked = _ref_leaf(tcfg, n)
            lead = 1 if stacked else 0
            assert got[n] == want[p][lead:], (n, flags)
            assert got_opt[n] == r_opt[p][lead:], (n, flags)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", all_arch_names())
def test_input_and_cache_specs_match_the_reference(arch, layout):
    """``input_specs``' shardings for every shape of the reference's
    ``LM_SHAPES`` (the batch spec where the batch divides the
    data-parallel size, the context's, every cache leaf at decode_32k
    and long_500k), under ``shard_cfg_for`` and each flag; and
    ``batch_spec``, ``dp_size`` and ``pick_microbatches`` on the mesh."""
    r_mesh, mesh = _meshes(layout)
    rcfg, tcfg = r_get_config(arch), get_config(arch)
    assert sharding.batch_spec(mesh) == tuple(r_sharding.batch_spec(r_mesh))
    assert sharding.dp_size(mesh) == r_steps.dp_size(r_mesh)
    for name, rs in r_base.LM_SHAPES.items():
        ts = ShapeCfg(*dataclasses.astuple(rs))
        assert steps.pick_microbatches(tcfg, ts, mesh) == \
            r_steps.pick_microbatches(rcfg, rs, r_mesh)
        assert steps.shard_cfg_for(tcfg, ts) == sharding.ShardCfg(
            **dataclasses.asdict(r_steps.shard_cfg_for(rcfg, rs)))
        for flags in [None] + FLAGS:
            rsc = None if flags is None else r_sharding.ShardCfg(**flags)
            tsc = None if flags is None else sharding.ShardCfg(**flags)
            _, want = r_steps.input_specs(rcfg, rs, r_mesh, rsc)
            _, got = steps.input_specs(tcfg, ts, mesh, tsc)
            if rs.kind != "decode":
                flat_w = (want["batch"] if rs.kind == "train" else want)
                flat_g = (got["batch"] if rs.kind == "train" else got)
                assert {k: tuple(v) for k, v in flat_w.items()} == flat_g
                continue
            assert got["token"] == tuple(want["token"])
            w_cache = want["cache"]
            for slot, val in got["cache"].items():
                if slot == "len":
                    assert val == tuple(w_cache["len"]) == ()
                elif isinstance(val, dict):
                    assert val == {k: tuple(v)
                                   for k, v in w_cache[slot].items()}
                else:
                    assert val == tuple(tuple(v) for v in w_cache[slot])


def test_cache_specs_at_the_long_shapes_cover_every_rule():
    """Across the configs and both layouts the cache rules all fire: kv
    heads over 'model', the sequence over 'model' (GQA decode), the
    sequence over 'data' (long_500k), a state-space state's widest dim
    over 'model' and the batch replicated where it does not divide."""
    seen = set()
    for arch in all_arch_names():
        cfg = get_config(arch)
        for layout in LAYOUTS.values():
            for name in ("decode_32k", "long_500k"):
                ts = ShapeCfg(*dataclasses.astuple(r_base.LM_SHAPES[name]))
                _, got = steps.input_specs(cfg, ts, layout)
                for slot, val in got["cache"].items():
                    for sp in (val.values() if isinstance(val, dict)
                               else val if isinstance(val, tuple) else []):
                        if len(sp) == 5:
                            seen.add(("kv", sp[2], sp[3]))
                        else:
                            seen.add(("state", sp[1], "model" in sp))
    assert ("kv", None, "model") in seen
    assert ("kv", "model", None) in seen
    assert any(s[0] == "kv" and s[1] == "data" for s in seen)
    assert ("state", None, True) in seen or ("state", None, False) in seen
    assert any(s[0] == "state" and s[2] for s in seen)


def test_at_use_spec_and_placements():
    """``at_use_spec`` drops 'data' and (by default) the leading dim, as
    the reference's; ``placements`` shards each mesh dim at the tensor
    dim that names it."""
    for sp in [(None, "data", "model"), (None, "model", ("data", "pod")),
               ("model", "data"), (None, None)]:
        for drop in (True, False):
            want = tuple(r_sharding.at_use_spec(
                jax.sharding.PartitionSpec(*sp), drop_leading=drop))
            assert sharding.at_use_spec(sp, drop_leading=drop) == want
    from torch.distributed.tensor import Replicate, Shard
    lay = {"pod": 2, "data": 2, "model": 2}
    assert sharding.placements(("model", ("data", "pod")), lay) == \
        (Shard(1), Shard(1), Shard(0))
    assert sharding.placements((None, "data"), lay) == \
        (Replicate(), Shard(1), Replicate())
    assert sharding.placements((), lay) == (Replicate(),) * 3
    assert sharding.layout(lay) == sharding.MeshLayout(
        ("pod", "data", "model"), (2, 2, 2))


def test_abstract_state_is_on_the_meta_device():
    """``abstract_state`` at published widths allocates nothing: every
    parameter and moment on ``meta``, with the reference's leaf count."""
    cfg = get_config("jamba-1.5-large-398b")
    st = steps.abstract_state(cfg, AdamWCfg())
    assert all(t.device.type == "meta" for t in st["params"].values())
    assert all(t.device.type == "meta" for t in st["opt"].mu.values())
    n = sum(t.numel() for t in st["params"].values())
    ref = _ref_params("jamba-1.5-large-398b")
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    specs = steps.state_specs(cfg, sharding.ShardCfg(), st,
                              LAYOUTS["2x16x16"])
    assert specs["opt"].step == ()
    assert set(specs["params"]) == set(specs["opt"].mu) == set(st["params"])


# ------------------------------------------------------------ collectives

def _grads(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((7, 33)) * 3.0).astype(dtype),
            "b": (rng.standard_normal((128,)) * 1e-5).astype(dtype),
            "zero": np.zeros((4, 4), dtype),
            "halves": (np.arange(-16, 17, dtype=np.float32) * 0.5)
            .astype(dtype)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_compression_matches_the_reference_bit_for_bit(seed):
    """``compress_int8`` (q and each scale) and ``decompress_int8``, on
    float32 trees with a zero leaf, a tiny one and exact halves
    (round half to even)."""
    g = _grads(seed)
    rq, rs = r_coll.compress_int8(jax.tree.map(jax.numpy.asarray, g))
    q, s = collectives.compress_int8(_t(g))
    for k in g:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(rq[k]))
        assert s[k].numpy().tobytes() == np.asarray(rs[k]).tobytes()
    rd = r_coll.decompress_int8(rq, rs)
    d = collectives.decompress_int8(q, s)
    for k in g:
        assert d[k].numpy().tobytes() == np.asarray(rd[k]).tobytes()


def test_error_feedback_matches_the_reference_for_50_steps():
    """``error_feedback_apply`` carried over 50 steps of fresh float32
    gradients: the bf16 output and the float32 residual bit for bit at
    every step (the first from a ``None`` residual)."""
    r_res = res = None
    for step in range(50):
        g = _grads(100 + step)
        r_out, r_res = r_coll.error_feedback_apply(
            jax.tree.map(jax.numpy.asarray, g), r_res)
        out, res = collectives.error_feedback_apply(_t(g), res)
        for k in g:
            assert out[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(out[k]), _jbits(r_out[k]))
            np.testing.assert_array_equal(_bits(res[k]), _jbits(r_res[k]))


# ------------------------------------------------------------- elastic

@pytest.mark.parametrize("want_pods", [1, 2, 4])
@pytest.mark.parametrize("model_cap", [16, 8, 4, 2, 1])
def test_best_mesh_shape_matches_the_reference(model_cap, want_pods):
    for n in range(1, 1101):
        assert elastic.best_mesh_shape(n, model_cap=model_cap,
                                       want_pods=want_pods) == \
            r_elastic.best_mesh_shape(n, model_cap=model_cap,
                                      want_pods=want_pods), n


def test_fleet_state_matches_the_reference():
    a, b = elastic.FleetState(256), r_elastic.FleetState(256)
    for op, k in [("fail", 1), ("fail", 3), ("join", 2), ("join", 1),
                  ("fail", 255)]:
        a, b = getattr(a, op)(k), getattr(b, op)(k)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [f.name for f in dataclasses.fields(elastic.FleetState)] == \
        [f.name for f in dataclasses.fields(r_elastic.FleetState)]


def test_clean_follows_the_reference_s_remap_rules():
    """Axes the new mesh lacks are dropped, and a dim the remaining axes
    do not divide is replicated; what divides stays."""
    new = {"data": 1, "model": 2}
    assert elastic._clean(("model", ("data", "pod")), (6, 8), new) == \
        ("model", None)
    assert elastic._clean(("model", None), (3, 8), new) == (None, None)
    assert elastic._clean((("pod", "model"), "data"), (4, 4), new) == \
        ("model", None)
    assert elastic._clean((), (4, 4), new) == ()


def test_adamw_cfg_matches_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(AdamWCfg)] == \
        [(f.name, f.default) for f in dataclasses.fields(r_adamw.AdamWCfg)]
