"""The processes behind ``test_torch_sharded_step.py``: the reference's
sharded train step on 4 forced host devices (``ref``), and one rank of the
port's 4-rank gloo group (``rank``). Run as

    python tests/_torch_mesh_jobs.py ref <job.json>
    python tests/_torch_mesh_jobs.py rank <job.json> <rank>

``job.json`` names the work directory, the configs and their inputs
(``<arch>.npz``: the reference's weights by ``/``-joined tree path under
``w/`` and the batch under ``b/``). ``ref`` imports JAX and the reference
only; ``rank`` imports torch and the port only. Each writes its results
beside the inputs.

Both kinds run under ``faulthandler``: a process that a signal kills (a
SIGSEGV) prints every thread's stack to the output that the test shows.
With ``MESH_JOBS_DETERMINISTIC=1`` in the environment the ranks run
under ``torch.use_deterministic_algorithms(True)``, which fills each
``torch.empty`` with NaN (``torch.utils.deterministic.
fill_uninitialized_memory``): a read of memory that no op wrote then
fails in every run rather than in one of many.
"""
import dataclasses
import faulthandler
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: the sharded step's mesh: data 2 x model 2
MESH = dict(model_cap=2)
#: the one-device comparisons' shapes (seq_len, global_batch); the pod
#: mesh's train step takes two microbatches, each of 4 rows over its 4
#: data-parallel ranks
TRAIN_SHAPE, POD_TRAIN_SHAPE, SERVE_SHAPE = (32, 4), (32, 8), (24, 4)
DECODE_STEPS = 2
#: configs cut to some slots of their first period for the one-device
#: checks: reduced jamba's 16 layers (gradient norm ~270 at this init)
#: turn the shards' summation order into gradient gaps past the step
#: tolerances; its mamba, MoE and attention slots, as
#: ``test_torch_train_ssm`` cuts it
CUTS = {"jamba-1.5-large-398b": (0, 1, 4)}
#: configs changed for a case of their own, by name: (arch, fields of
#: the config, fields of its MoE). Reduced mixtral with 3 experts, which
#: do not divide the 2-wide 'model' axis, so that its experts take the
#: reference's fallback (every expert's FFN dim split over 'model');
#: reduced qwen with 6 query heads on 3 KV heads, groups of 2, so that
#: each 'model' rank's 3 query heads straddle two KV groups (rank 0's
#: heads 0-2 read KV heads 0, 0 and 1)
VARIANTS = {"mixtral-8x7b/e3": ("mixtral-8x7b", {}, dict(n_experts=3)),
            "qwen1.5-0.5b/h6": ("qwen1.5-0.5b",
                                dict(n_heads=6, n_kv_heads=3), {})}


def _config(name: str):
    """The reduced float32 config of a one-device check: a registered
    config (cut as ``CUTS`` says) or one of :data:`VARIANTS`."""
    from repro_torch.configs import get_config, period_slots
    arch, fields, moe = VARIANTS.get(name, (name, {}, {}))
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **fields)
    if arch in CUTS:
        cfg = period_slots(cfg, CUTS[arch])
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _unflatten(flat, prefix):
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _inputs(work, arch):
    with np.load(work / f"{arch}.npz") as f:
        flat = dict(f)
    return _unflatten(flat, "w/"), _unflatten(flat, "b/")


# ------------------------------------------------------------ reference

def reference(job):
    """Each config's one step of ``repro.launch.steps.make_train_step`` on
    a 2 x 2 (data, model) mesh of forced host devices: the metrics, and
    for every leaf of the new params and moments the whole array and each
    device's shard index by mesh coordinate."""
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import base as r_base
    from repro.configs import get_config
    from repro.distributed.elastic import make_mesh_for
    from repro.launch import steps
    from repro.optim import adamw

    work = Path(job["work"])
    for arch in job["ref_archs"]:
        rcfg = dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32")
        tree, batch = _inputs(work, arch)
        shape = r_base.ShapeCfg("t", *job["shape"], "train")
        opt_cfg = adamw.AdamWCfg(**job["opt"])
        mesh = make_mesh_for(4, **MESH)
        with jax.set_mesh(mesh):
            step, st_specs, b_specs = steps.make_train_step(
                rcfg, shape, mesh, opt_cfg=opt_cfg, n_micro=job["n_micro"],
                attn_block=job["attn_block"])

            def put(tree, specs):
                return jax.tree.map(
                    lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                    tree, specs)
            params = put(tree, st_specs["params"])
            opt = adamw.init_opt_state(params, opt_cfg)
            opt = adamw.OptState(opt.step, put(opt.mu, st_specs["opt"].mu),
                                 put(opt.nu, st_specs["opt"].nu))
            state, m = step({"params": params, "opt": opt},
                            put(batch, b_specs["batch"]))
        arrays, index = {}, {}
        coords = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
        for part, sub in (("params", state["params"]),
                          ("mu", state["opt"].mu), ("nu", state["opt"].nu)):
            for path, leaf in jax.tree_util.tree_flatten_with_path(sub)[0]:
                key = part + "/" + "/".join(str(getattr(k, "key", k))
                                            for k in path)
                arrays[key] = np.asarray(leaf)
                index[key] = {
                    ",".join(map(str, coords[s.device.id])):
                    [list(sl.indices(n))[:2]
                     for sl, n in zip(s.index, leaf.shape)]
                    for s in leaf.addressable_shards}
        np.savez(work / f"{arch}.ref.npz", **arrays)
        (work / f"{arch}.ref.json").write_text(json.dumps({
            "metrics": {k: float(v) for k, v in m.items()},
            "index": index}))


# ------------------------------------------------------------ the port

def _full_close(got, want, rtol, scale):
    """max |got - want| over (rtol |want| + scale max |want|): <= 1 holds."""
    want = want.float()
    tol = rtol * want.abs() + scale * want.abs().max() + 1e-30
    return float(((got.float() - want).abs() / tol).max())


def _step_report(torch, got, want, lr):
    """The sharded state ``got`` (whole tensors) against the one-device
    ``want`` after one AdamW step: the first moment (0.1 x the clipped
    gradient) within the gradient tolerances (rtol 1e-4, 1e-3 of the
    leaf's largest), and each parameter within 1e-4 (and 1e-4 of its
    largest), except where the first moment is at the gradient noise
    floor: there the two may step either way, each by at most the rate."""
    worst_mu = worst_p = 0.0
    worst_leaf = None
    n_noise = n_all = 0
    for n, w in want["params"].items():
        mu_w = want["mu"][n].float()
        worst_mu = max(worst_mu, _full_close(got["mu"][n], mu_w, 1e-4, 1e-3))
        m = mu_w.abs()
        noise = (m > 0) & (m <= 1e-3 * m.max())
        g, w = got["params"][n].float(), w.float()
        tol = 1e-4 * w.abs() + 1e-4 * w.abs().max()
        err = (g - w).abs()
        over = torch.where(noise, err / (2 * lr + tol), err / (tol + 1e-30))
        if float(over.max()) > worst_p:
            worst_p, worst_leaf = float(over.max()), n
        n_noise, n_all = n_noise + int(noise.sum()), n_all + noise.numel()
    return {"mu": worst_mu, "params": worst_p, "worst_leaf": worst_leaf,
            "noise_share": n_noise / max(n_all, 1)}


def _slice_rows_held(torch, mesh, mbs, batch):
    """Whether each microbatch's local slice on this rank holds exactly
    its b / (n dp) rows of the reference's slice m (the global rows m b
    / n ..), at this rank's index over the data-parallel axes (mesh
    order), every input alike; and those rows' count."""
    dims = [i for i, a in enumerate(mesh.mesh_dim_names)
            if a in ("pod", "data")]
    coord, r, dp = mesh.get_coordinate(), 0, 1
    for i in dims:
        r, dp = r * mesh.size(i) + coord[i], dp * mesh.size(i)
    n = len(mbs)
    held = []
    for m, mb in enumerate(mbs):
        for k, t in mb.items():
            b = batch[k].shape[0] // n
            c = b // dp
            want = batch[k][m * b + r * c:m * b + (r + 1) * c]
            held.append(torch.equal(t.to_local(), want.to(t.dtype)))
    return {"equal": all(held),
            "count": {k: int(t.to_local().shape[0])
                      for k, t in mbs[0].items()}}


#: decode attention over a cache whose sequence a mesh dim splits, on the
#: 2 x 2 mesh: (name, H, KV, the cache's spec after its period dim, cache
#: capacity, window, cache_len). Sequence over 'model' (the batch over
#: 'data'): a cache_len inside the first shard's slots, one across both,
#: a ring of capacity W that wrapped and one that did not; sequence over
#: 'data' (``seq_shard_cache``, the batch whole), the query heads over
#: 'model' from one KV head, and with 6 query heads on 3 KV heads, each
#: rank's 3 heads straddling two groups
DECODE_CASES = (("model/len3", 4, 1, ("data", "model", None, None), 8,
                 None, 3),
                ("model/len6", 4, 1, ("data", "model", None, None), 8,
                 None, 6),
                ("model/ring", 4, 1, ("data", "model", None, None), 8, 8,
                 13),
                ("model/ring_short", 4, 1, ("data", "model", None, None), 8,
                 8, 5),
                ("data/heads", 4, 1, (None, "data", None, None), 8, None,
                 6),
                ("data/straddle", 6, 3, (None, "data", None, None), 8, 16,
                 7))


def _decode_checks(torch, mesh):
    """``layers.decode_attention`` on DTensors (q as a decode step makes
    it: rows over 'data', heads over 'model'; the cache placed by the
    case's spec) against one device's, for each of :data:`DECODE_CASES`,
    float32: max |got - want| over max |want|, and the placements that
    the output comes back with."""
    from repro_torch.distributed.sharding import place, spec
    from repro_torch.models import layers
    out = {}
    for name, H, KV, sp, Sc, window, n in DECODE_CASES:
        g = torch.Generator().manual_seed(len(out))
        B, hd = 4, 16
        q = torch.randn((B, 1, H, hd), generator=g)
        k, v = (torch.randn((B, Sc, KV, hd), generator=g) for _ in "kv")
        want = layers.decode_attention(q, k, v, n, window=window)
        qd = place(q, spec("data", None, "model", None), mesh)
        kd, vd = place(k, spec(*sp), mesh), place(v, spec(*sp), mesh)
        got = layers.decode_attention(qd, kd, vd, n, window=window)
        out[name] = {"err": float((got.full_tensor() - want).abs().max()
                                  / want.abs().max()),
                     "placed": str(tuple(got.placements))}
    return out


def _leaves(cache):
    """A cache's tensors in a fixed order (``len`` left out)."""
    out = []
    for k in sorted(cache):
        v = cache[k]
        if k != "len":
            out += [v[n] for n in sorted(v)] if isinstance(v, dict) \
                else list(v)
    return out


def _unit_scores(model, cfg):
    """Every query matrix (``wq``, the cross sublayer's ``xq``) scaled by
    P / d, P the axis the reference draws it over (the periods, or the
    encoder's layers), as ``test_torch_train_encdec._weights`` does: at
    the reduced widths the scores' deviation is d / P = 32 and softmax
    rows are nearly one-hot, where two correct float32 sums of another
    order part by more than the step tolerances (whisper's gradient norm
    by 1.1e-4)."""
    for name, p in model.named_parameters():
        if name.split(".")[-1] in ("wq", "xq"):
            n = cfg.encoder_layers if name.startswith("encoder.") \
                else cfg.n_periods
            p.data.mul_(n / cfg.d_model)
    return model


def _model(cfg):
    from repro_torch.models.lm import LM
    return _unit_scores(LM(cfg, device="cpu"), cfg)


def _one_device_checks(torch, arch, mesh, pod=False):
    """The sharded train step (one microbatch, as the reference
    comparison takes two; on the pod mesh two, whose slices' placements
    are recorded) and, except on the pod mesh, the prefill and decode
    steps of a reduced float32 config (``_config``), its queries scaled
    (``_unit_scores``), against the port's one-device path on the same
    weights."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import steps
    from repro_torch.optim import AdamWCfg

    cfg = _config(arch)
    out = {"arch": arch, "pod": pod}
    t0 = time.perf_counter()
    opt = AdamWCfg(warmup_steps=2, decay_steps=10)
    shape = ShapeCfg("t", *(POD_TRAIN_SHAPE if pod else TRAIN_SHAPE),
                     "train")
    n_micro = 2 if pod else 1
    g = torch.Generator().manual_seed(3)
    specs = steps.input_specs(cfg, shape)["batch"]
    batch = {k: (torch.randn(tuple(v.shape), generator=g) if k == "ctx"
                 else torch.randint(0, cfg.vocab, tuple(v.shape),
                                    generator=g))
             for k, v in specs.items()}
    batch["targets"][0, -3:] = -1
    step, st_specs, b_specs = steps.make_train_step(
        cfg, shape, mesh, n_micro=n_micro, opt_cfg=opt, attn_block=16)
    state, placed = steps.place_inputs(
        steps.init_state(_model(cfg), opt), batch, st_specs,
        b_specs, mesh)
    from repro_torch.launch.op_analysis import counting
    with counting() as moved:
        mbs = steps.microbatches(placed, n_micro, mesh)
    out["slices"] = sorted({str(tuple(v.placements)) for mb in mbs
                            for v in mb.values()})
    out["split"] = {"collectives": dict(moved.coll),
                    "rows": _slice_rows_held(torch, mesh, mbs, batch)}
    state, m = step(state, placed)
    one = steps.make_train_step(cfg, shape, n_micro=n_micro, opt_cfg=opt,
                                attn_block=16, device="cpu")
    rs, rm = one(steps.init_state(_model(cfg), opt), batch)
    got = {"params": {n: p.full_tensor() for n, p in
                      state["params"].items()},
           "mu": {n: t.full_tensor() for n, t in state["opt"].mu.items()}}
    want = {"params": rs["params"], "mu": rs["opt"].mu}
    out["train"] = {
        "loss": [float(m["loss"].full_tensor()), float(rm["loss"])],
        "grad_norm": [float(m["grad_norm"].full_tensor()),
                      float(rm["grad_norm"])],
        **_step_report(torch, got, want, float(rm["lr"])),
        "placed": sorted({str(tuple(p.placements))
                          for p in state["params"].values()})}
    out["seconds"] = out["train_s"] = time.perf_counter() - t0
    if pod:
        return out
    # prefill, then DECODE_STEPS greedy tokens, against LM's own
    ps, ds = (ShapeCfg("p", *SERVE_SHAPE, "prefill"),
              ShapeCfg("d", *SERVE_SHAPE, "decode"))
    abs_in = steps.input_specs(cfg, ps)
    toks = torch.randint(0, cfg.vocab, tuple(abs_in["tokens"].shape),
                         generator=g)
    ctx = (torch.randn(tuple(abs_in["ctx"].shape), generator=g)
           if "ctx" in abs_in else None)
    pre, pspecs, _ = steps.make_prefill_step(cfg, ps, mesh, attn_block=16)
    dec, _, _, _ = steps.make_decode_step(cfg, ds, mesh)
    model = steps.place_params(_model(cfg), pspecs, mesh)
    ref = _model(cfg)
    cap = toks.shape[1] + 128 if not cfg.sliding_window else toks.shape[1]
    logits, cache = pre(model, toks, ctx)
    rl, rc = ref.prefill(toks, ctx, seq_cap=cap, attn_block=16)
    errs = [_full_close(logits.full_tensor(), rl, 1e-4, 1e-4)]
    cache_err = max(_full_close(a.full_tensor(), b, 1e-4, 1e-4)
                    for a, b in zip(_leaves(cache), _leaves(rc)))
    tok = rl.argmax(-1)[:, None]
    for _ in range(DECODE_STEPS):
        logits, cache = dec(model, tok, cache)
        rl, rc = ref.decode_step(tok, rc)
        errs.append(_full_close(logits.full_tensor(), rl, 1e-4, 1e-4))
        tok = rl.argmax(-1)[:, None]
    out["serve"] = {"logits": errs, "cache": cache_err,
                    "len": [cache["len"], rc["len"]]}
    out["seconds"] = time.perf_counter() - t0
    return out


#: the aux check's batch: 4 rows of 32 tokens in chunks of 16 (two
#: chunks, each with its own capacity and aux)
AUX_SHAPE, AUX_CHUNK = (4, 32), 16


def _aux_checks(torch, mesh):
    """``layers.moe_ffn`` on DTensors (the first layer's weights at their
    at-use placements, the rows over 'data') against one device, for an
    expert-parallel config and the FFN-dim fallback (:data:`VARIANTS`), on
    a batch whose two data shards route differently: the second shard's
    rows are pushed towards expert 0 along its router column. Reports
    the aux loss both ways, the mean of the two shards' own aux values
    (what a mean of per-shard aux would give), the output's closeness and
    the experts' at-use placements."""
    from repro_torch.distributed.sharding import (ModelSharding, ShardCfg,
                                                  place, spec,
                                                  tree_param_specs)
    from repro_torch.launch import steps
    from repro_torch.models import layers

    out = {}
    for name in ("phi3.5-moe-42b-a6.6b", "mixtral-8x7b/e3"):
        cfg = _config(name)
        model = _model(cfg)
        first = model.layers[0]
        one = {"router": first.router, "w1": first.moe_w1,
               "w3": first.moe_w3, "w2": first.moe_w2}
        g = torch.Generator().manual_seed(11)
        B, S = AUX_SHAPE
        x = torch.randn((B, S, cfg.d_model), generator=g)
        lean = one["router"][:, 0] / one["router"][:, 0].norm()
        x[B // 2:] += 8.0 * lean
        kw = dict(n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                  capacity_factor=cfg.moe.capacity_factor,
                  seq_chunk=AUX_CHUNK)
        want, want_aux = layers.moe_ffn(one, x, **kw)
        halves = [float(layers.moe_ffn(one, h, **kw)[1])
                  for h in (x[:B // 2], x[B // 2:])]
        sc = ShardCfg()
        placed = steps.place_params(model, tree_param_specs(
            cfg, sc, dict(model.named_parameters()), mesh), mesh)
        shd = ModelSharding(cfg, sc, mesh, dict(placed.named_parameters()))
        w = shd.pslice("slot0", placed.layers[0].weights())
        xd = shd.act(place(x, spec(None, None, None), mesh))
        got, aux = layers.moe_ffn(
            {"router": w["router"], "w1": w["moe_w1"], "w3": w["moe_w3"],
             "w2": w["moe_w2"]}, xd, **kw)
        out[name] = {"aux": [float(aux.full_tensor()), float(want_aux)],
                     "shard_mean": sum(halves) / 2,
                     "out": _full_close(got.full_tensor(), want, 1e-5, 1e-5),
                     "w1": str(tuple(w["moe_w1"].placements)),
                     "w2": str(tuple(w["moe_w2"].placements))}
    return out


def _remap_checks(torch, mesh, pod_mesh):
    """``remap_state`` onto the 1 x 2 mesh: a reduced state placed on the
    2 x 2 mesh by its specs, AdamW moments placed on the pod mesh by
    specs that extend over 'pod' (an axis the new mesh lacks), and a
    tensor whose spec's axis no longer divides its dim."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.elastic import (_clean, make_mesh_for,
                                                 remap_state)
    from repro_torch.distributed.sharding import (ShardCfg, placements,
                                                  place, tree_param_specs)
    from repro_torch.launch.steps import _opt_specs
    from repro_torch.models.lm import LM
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_part

    cfg = get_config("qwen1.5-0.5b").reduced()
    sc = ShardCfg()
    small = make_mesh_for(2, device="cpu", **MESH)
    params = dict(LM(cfg, device="cpu").named_parameters())
    specs = tree_param_specs(cfg, sc, params, mesh)
    pod_specs = _opt_specs(cfg, sc, params, pod_mesh)
    odd = torch.arange(12.0).reshape(3, 4)
    state = {"params": {n: place(p.detach(), specs[n], mesh)
                        for n, p in params.items()},
             "mu": {n: place(p.detach(), pod_specs[n], pod_mesh)
                    for n, p in params.items()},
             "odd": place(odd, (None, "model"), mesh)}
    new = remap_state(state, {"params": specs, "mu": pod_specs,
                              "odd": ("model", None)}, small)
    out = {"equal": []}
    # a ('data', 'pod') dim's chunk on each rank of the pod mesh
    n = out["pod_extended"] = [n for n, sp in pod_specs.items()
                               if ("data", "pod") in sp]
    t = state["mu"][n[0]]
    dim = pod_specs[n[0]].index(("data", "pod"))
    shape_l, off = local_part(t.shape, pod_mesh, t.placements)
    out["chunks"] = {"coord": pod_mesh.get_coordinate(),
                     "chunk": off[dim] // shape_l[dim],
                     "layout": dict(zip(pod_mesh.mesh_dim_names,
                                        pod_mesh.shape))}
    if small.get_coordinate() is None:      # not a rank of the new mesh
        return out
    for part in ("params", "mu"):
        for n, p in params.items():
            t = new[part][n]
            out["equal"].append(bool(torch.equal(t.full_tensor(),
                                                  p.detach())))
    out["equal"].append(bool(torch.equal(new["odd"].full_tensor(), odd)))
    out["placed_by_clean_specs"] = all(
        tuple(new[part][n].placements)
        == placements(_clean(sp[n], p.shape, small), small)
        for part, sp in (("params", specs), ("mu", pod_specs))
        for n, p in params.items())
    out["odd"] = str(tuple(new["odd"].placements))
    out["mu_embed"] = str(tuple(new["mu"]["embed"].placements))
    return out


def rank(job, r):
    """One rank of the port's group: the sharded step on the reference's
    inputs (each parameter's and moment's local shard, its offset and the
    rank's mesh coordinate), the one-device checks of every config (and
    of :data:`VARIANTS`), the MoE aux checks, the decode checks over
    sequence-sharded caches, the pod mesh's, and ``remap_state``'s."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.distributed.elastic import make_mesh_for
    from repro_torch.launch import steps
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWCfg
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_part

    torch.set_num_threads(1)
    if os.environ.get("MESH_JOBS_DETERMINISTIC") == "1":
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = True
    work = Path(job["work"])
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=r, world_size=4)
    mesh = make_mesh_for(4, device="cpu", **MESH)
    report = {"coord": mesh.get_coordinate(), "shards": {}, "ref": {},
              "deterministic": torch.are_deterministic_algorithms_enabled()}
    arrays = {}
    t0 = time.perf_counter()
    for arch in job["ref_archs"]:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tree, batch = _inputs(work, arch)
        model = LM(cfg, device="cpu")
        model.load_state_dict(params_from_numpy(cfg, tree))
        opt = AdamWCfg(**job["opt"])
        shape = ShapeCfg("t", *job["shape"], "train")
        step, st_specs, b_specs = steps.make_train_step(
            cfg, shape, mesh, n_micro=job["n_micro"], opt_cfg=opt,
            attn_block=job["attn_block"])
        batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
                 else torch.from_numpy(v) for k, v in batch.items()}
        state, batch = steps.place_inputs(steps.init_state(model, opt),
                                          batch, st_specs, b_specs, mesh)
        state, m = step(state, batch)
        report["ref"][arch] = {k: float(v.full_tensor()) if hasattr(
            v, "full_tensor") else float(v) for k, v in m.items()}
        for part, sub in (("params", state["params"]),
                          ("mu", state["opt"].mu), ("nu", state["opt"].nu)):
            for n, t in sub.items():
                shape_l, off = local_part(t.shape, t.device_mesh,
                                          t.placements)
                key = f"{arch}:{part}/{n}"
                arrays[key] = t.to_local().detach().numpy()
                report["shards"][key] = [[o, o + s] for o, s in
                                         zip(off, shape_l)]
    report["ref_seconds"] = time.perf_counter() - t0
    report["one_device"] = [_one_device_checks(torch, a, mesh)
                            for a in job["archs"]]
    report["aux"] = _aux_checks(torch, mesh)
    report["decode"] = _decode_checks(torch, mesh)
    pod_mesh = make_mesh_for(4, device="cpu", model_cap=1, want_pods=2)
    report["one_device"].append(_one_device_checks(torch, job["pod_arch"],
                                                   pod_mesh, pod=True))
    report["remap"] = _remap_checks(torch, mesh, pod_mesh)
    report["seconds"] = time.perf_counter() - t0
    np.savez(work / f"rank{r}.npz", **arrays)
    (work / f"rank{r}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    faulthandler.enable(all_threads=True)
    job = json.loads(Path(sys.argv[2]).read_text())
    try:
        if sys.argv[1] == "ref":
            reference(job)
        else:
            rank(job, int(sys.argv[3]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
