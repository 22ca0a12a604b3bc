"""The dry run: trace every (architecture x input shape) cell's step on
the production meshes and read memory, cost and collective figures from
the trace, without a card: the port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell under XLA with 512 host
devices. Here one process plays rank 0 of a ``fake`` process group of
256 or 512 ranks (``torch.testing``'s ``FakeStore``: every collective
returns at once and moves nothing), and the cell's step
(``launch.steps.make_train_step``, ``make_prefill_step`` or
``make_decode_step``) runs once on the production mesh under
``FakeTensorMode``: its tensors carry shapes, dtypes and devices, and no
memory, so nothing is allocated on a device and no kernel is launched.
DTensor runs every op on rank 0's shards, so the counts are one
device's:

  * ``launch.op_analysis`` counts the FLOPs, the dot bytes and the
    collectives' bytes (``hlo_flops``, ``hlo_bytes``, ``collectives``:
    the reference's key names, so that a reader of its results finds
    them);
  * ``op_analysis.LiveBytes`` tracks rank 0's live tensor bytes:
    ``arg_bytes`` the state and inputs, ``temp_bytes`` the peak above
    them, ``per_device_bytes`` the peak (the reference's is XLA's
    argument + output + temp sizes);
  * ``FlopCounterMode`` counts the same trace on global shapes;
    ``hlo_flops_raw_costanalysis`` is its count over the chip count.

``lower_s`` is the trace's seconds. ``compile_s`` is 0.0: the port runs
eagerly and compiles nothing, so it has no counterpart. The roofline
terms use ``launch.mesh``'s H100 constants.

``--device`` chooses the fake tensors' device: the card (default; the
flash ops counted by their formula) or ``cpu`` (the flash ops' plain
versions traced op by op, in blocks of ``attn_block``, as the reference's
XLA path computes attention).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k [--multi-pod] [--all] [--device cpu] [--out r.json]

Cells run one after another. To trace them in parallel, start one
process a cell, each with its own ``--out`` (``xargs -P``: README).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch

from ..configs import LM_SHAPES, all_arch_names, cells_for, get_config
from ..configs.base import ArchConfig, ShapeCfg
from . import steps as S
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, make_production_mesh


@contextlib.contextmanager
def fake_group(world_size: int):
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks, destroyed on the way out; a started fake group
    of that size is used as it is. Refuses to run inside any other
    started group (a real one would run the trace's collectives)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" \
                or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"dryrun: a {dist.get_backend()} group of "
                f"{dist.get_world_size()} ranks is started; the dry run "
                f"needs a fake one of {world_size}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def model_flops_per_chip(cfg: ArchConfig, shape: ShapeCfg,
                         n_chips: int) -> float:
    """The reference's MODEL_FLOPS over the chips: 6·N_active·D for a
    train step, 2·N_active·D for prefill and decode; an encoder-decoder
    config's encoder parameters see the frames, its decoder's the tokens
    (min(448, frames)); a decode step sees one token per row."""
    n_active = cfg.n_params_active()
    n_enc = cfg.n_params_encoder()
    B, sl = shape.global_batch, shape.seq_len
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    if shape.kind == "decode":
        model_flops = mult * (n_active - n_enc) * B
    elif cfg.is_encdec:
        model_flops = mult * ((n_active - n_enc) * B * min(S.DEC_LEN, sl)
                              + n_enc * B * sl)
    else:
        model_flops = mult * n_active * B * sl
    return model_flops / n_chips


def _fake_like(tree, dev):
    """Zero tensors on ``dev`` shaped like ``tree``'s (meta) tensors."""
    from torch.utils._pytree import tree_map_only
    return tree_map_only(torch.Tensor, lambda t: torch.zeros(
        t.shape, dtype=t.dtype, device=dev), tree)


def _fake_model(cfg: ArchConfig, dev) -> "S.lm.LM":
    """``cfg``'s LM with its parameters as (fake) tensors on ``dev``,
    nothing drawn: the ``meta`` model's leaves remade on ``dev``."""
    model = S.lm.LM(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod) if mod else model, leaf,
                torch.nn.Parameter(torch.empty(p.shape, dtype=p.dtype,
                                               device=dev),
                                   requires_grad=p.requires_grad))
    return model


def _cell_step(cfg, shape, mesh, dev, *, sc, n_micro, attn_block, opt_cfg):
    """The cell's step, placed on ``mesh``: (run, the tensors it holds
    before it runs)."""
    model = _fake_model(cfg, dev)
    if shape.kind == "train":
        step, st_specs, b_specs = S.make_train_step(
            cfg, shape, mesh, sc=sc, n_micro=n_micro, attn_block=attn_block,
            opt_cfg=opt_cfg)
        batch = _fake_like(S.input_specs(cfg, shape)["batch"], dev)
        state, batch = S.place_inputs(S.init_state(model, opt_cfg), batch,
                                      st_specs, b_specs, mesh)
        held = [state["params"], state["opt"], batch]
        return (lambda: step(state, batch)), held
    if shape.kind == "prefill":
        step, pspecs, _ = S.make_prefill_step(cfg, shape, mesh, sc=sc,
                                              attn_block=attn_block)
        model = S.place_params(model, pspecs, mesh)
        abs_in, in_sh = S.input_specs(cfg, shape, mesh, sc)
        ins = S.place_tree(_fake_like(abs_in, dev), in_sh, mesh)
        args = [ins["tokens"]] + ([ins["ctx"]] if "ctx" in ins else [])

        def run():
            with torch.no_grad():
                return step(model, *args)
        return run, [dict(model.named_parameters()), args]
    step, pspecs, in_sh, abs_in = S.make_decode_step(cfg, shape, mesh, sc=sc)
    model = S.place_params(model, pspecs, mesh)
    # the cache of input_specs (len 0: a decode step reads every slot of
    # its cache whatever the length, so its cost does not depend on it)
    ins = S.place_tree(_fake_like(abs_in, dev), in_sh, mesh)
    token, cache = ins["token"], ins["cache"]

    def run():
        with torch.no_grad():
            return step(model, token, cache)
    return run, [dict(model.named_parameters()), token, cache]


def _trace(cfg, shape, mesh, dev, *, sc, n_micro, attn_block,
           opt_cfg) -> Dict:
    """One trace of ``cfg``'s step of ``shape`` on ``mesh`` under
    ``FakeTensorMode``: one device's counts (``op_analysis``), its live
    bytes before the step and their peak, the storages live at the peak
    (``at_peak``: :meth:`LiveBytes.largest_at_peak`), FlopCounterMode's
    global count and the trace's seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from .op_analysis import LiveBytes, counting
    with FakeTensorMode():
        run, held = _cell_step(cfg, shape, mesh, dev, sc=sc, n_micro=n_micro,
                               attn_block=attn_block, opt_cfg=opt_cfg)
        mem = LiveBytes()
        mem.track(held)
        arg_bytes = mem.live
        t0 = time.perf_counter()  # monotonic: a wall-clock step breaks timings
        with counting() as hc, mem, FlopCounterMode(display=False) as fc:
            run()
        seconds = time.perf_counter() - t0
        peak = mem.peak
    del run, held
    return {"flops": float(hc.flops), "dot_bytes": float(hc.dot_bytes),
            "coll": dict(hc.coll), "raw": float(fc.get_total_flops()),
            "arg_bytes": arg_bytes, "peak": peak, "seconds": seconds,
            "at_peak": mem.largest_at_peak(None)}


def _cut(cfg: ArchConfig, p: int) -> ArchConfig:
    """``cfg`` at ``p`` of its periods, its encoder cut alike where its
    layers divide among the periods (whisper's 24 over 24), else whole."""
    kw = {"n_layers": p * cfg.period}
    if cfg.is_encdec and cfg.encoder_layers % cfg.n_periods == 0:
        kw["encoder_layers"] = p * cfg.encoder_layers // cfg.n_periods
    return dataclasses.replace(cfg, **kw)


def _line(x1: float, y1: float, x2: float, y2: float, x: float) -> float:
    return y1 + (x - x1) * (y2 - y1) / (x2 - x1) if x2 != x1 else y1


def _extrapolated(traces: Dict, P: int, N: int) -> Dict:
    """The counts at ``P`` periods and ``N`` microbatches from traces at
    (p, n) points (``traces``: {(p, n): _trace's}): every count is linear
    in the periods and, at a microbatch's fixed size, in the microbatches
    (each period and each microbatch repeats the same work), the bytes
    held and their peak too (the batch grows with the microbatches; their
    activations, one microbatch after another, do not)."""
    ps = sorted({p for p, _ in traces})
    ns = sorted({n for _, n in traces})

    def at(get):
        by_p = [_line(ns[0], get(traces[p, ns[0]]), ns[-1],
                      get(traces[p, ns[-1]]), N) for p in ps]
        return _line(ps[0], by_p[0], ps[-1], by_p[-1], P)

    kinds = sorted({k for t in traces.values() for k in t["coll"]})
    out = {k: at(lambda t, k=k: t[k])
           for k in ("flops", "dot_bytes", "raw")}
    out["coll"] = {k: at(lambda t, k=k: t["coll"].get(k, 0.0))
                   for k in kinds}
    for k in ("arg_bytes", "peak"):
        out[k] = int(round(at(lambda t, k=k: t[k])))
    out["seconds"] = sum(t["seconds"] for t in traces.values())
    return out


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool,
                 sc=None, n_micro: Optional[int] = None,
                 attn_block: int = 1024, mesh=None, cfg=None,
                 opt_cfg=None, device=None) -> Dict:
    """One cell traced on ``mesh`` (default: the production mesh of
    ``multi_pod``, on ``device``; the caller's process group must be a
    started ``fake`` one of its size) under ``FakeTensorMode``: the
    reference's result keys (module docstring). ``shape_name`` names a
    shape of ``LM_SHAPES``, or is a ``ShapeCfg`` (a cell of other sizes,
    as the tests trace). ``cfg`` overrides the arch's config (a reduced
    one in the tests), ``sc``, ``n_micro``, ``attn_block`` and
    ``opt_cfg`` go to the step builder.

    A step of more than 3 periods is traced at 2 and 3 of them, and a
    train step of more than 3 microbatches at 2 and 3 of them (at their
    size), and every count is extrapolated to the whole step
    (:func:`_extrapolated`; equal to the whole trace's counts,
    ``tests/test_torch_dryrun_extrapolate.py``): a whole trace runs every chunk
    of every state-space mixer in every layer and microbatch, one fake op
    at a time, hours for jamba's train step. ``lower_s`` is the cut
    traces' seconds."""
    cfg = cfg or get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeCfg) \
        else LM_SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device=device)
    n_chips = mesh.size()
    dev = torch.device(mesh.device_type)
    opt_cfg = opt_cfg or S.AdamWCfg()
    P = cfg.n_periods
    N = 1
    if shape.kind == "train":
        N = n_micro or S.pick_microbatches(cfg, shape, mesh)
    # from 2 on: at one period a cache stack's leading dim is 1, and an
    # SSM config's first period costs less than the next
    ps = [2, 3] if P > 3 else [P]
    # a microbatch keeps its size (and its rows' split over the data
    # axes) at 2 and 3 of them
    ns = [2, 3] if N > 3 \
        and (shape.global_batch // N) % S.dp_size(mesh) == 0 else [N]
    points = [(p, n) for p in ps for n in ns]
    traces = {}
    for p, n in points:
        sub = dataclasses.replace(shape,
                                  global_batch=shape.global_batch * n // N)
        traces[p, n] = _trace(_cut(cfg, p), sub, mesh, dev, sc=sc,
                              n_micro=n if shape.kind == "train" else None,
                              attn_block=attn_block, opt_cfg=opt_cfg)
    got = _extrapolated(traces, P, N)

    flops = float(got["flops"])
    bytes_accessed = float(got["dot_bytes"])
    coll = got["coll"]
    coll_total = float(sum(coll.values()))
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_accessed / HBM_BW
    t_collective = coll_total / LINK_BW
    model_flops = model_flops_per_chip(cfg, shape, n_chips)
    t_max = max(t_compute, t_memory, t_collective)
    per_device, arg_bytes = got["peak"], got["arg_bytes"]
    return {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "chips": n_chips,
        "lower_s": round(got["seconds"], 1), "compile_s": 0.0,
        "per_device_bytes": per_device,
        "arg_bytes": arg_bytes,
        "temp_bytes": per_device - arg_bytes,
        "hlo_flops": flops,
        "hlo_flops_raw_costanalysis": got["raw"] / n_chips,
        "hlo_bytes": bytes_accessed,
        "collective_bytes": coll_total,
        "collectives": coll,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": max(
            [("compute", t_compute), ("memory", t_memory),
             ("collective", t_collective)], key=lambda kv: kv[1])[0],
        "model_flops_per_chip": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else 0.0,
        "roofline_fraction": (model_flops / PEAK_FLOPS_BF16) / t_max
        if t_max > 0 else 0.0,
    }


def _one_cell(arch: str, shape: str, multi_pod: bool,
              device: str) -> Dict:
    """One cell's result, or its error beside it, traced in this process
    under a fake group of its mesh's size."""
    meshname = "2x16x16" if multi_pod else "16x16"
    print(f"=== {arch} × {shape} × {meshname}", flush=True)
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            r = analyze_cell(arch, shape, multi_pod=multi_pod, mesh=mesh)
        print(json.dumps({k: r[k] for k in (
            "arch", "shape", "mesh", "per_device_bytes", "hlo_flops",
            "collective_bytes", "bottleneck", "lower_s")}), flush=True)
        return r
    except Exception as e:  # a failure here is a bug in the system
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": meshname,
                "error": str(e)[:500]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (default, the "
                         "flash ops by their formula) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() != "fake":
        # a real group would run the traces' collectives
        raise RuntimeError(f"dryrun: a {dist.get_backend()} group is "
                           f"started; the dry run needs a fake one")

    cells = []
    if args.all:
        for name in all_arch_names():
            for sh in cells_for(get_config(name)):
                cells.append((name, sh.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape))
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    tasks = [(a, s, mp) for mp in meshes for a, s in cells
             if (a, s, "2x16x16" if mp else "16x16") not in done]
    for t in tasks:
        results.append(_one_cell(*t, args.device))
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_err = sum(1 for r in results if "error" in r)
    print(f"done: {len(results)} cells, {n_err} errors", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
