"""The dry run's extrapolation (``analyze_cell`` on a step of more than 3
periods or microbatches): traces at 2 and 3 periods and at 2 and 3
microbatches give, extrapolated, the whole trace's counts, bytes held
and peak, to the byte. Reduced configs at 4 periods, train steps of 4
microbatches, on a fake 2 x 2 (data, model) mesh of the ``"cpu"`` type;
the whole step traced once by ``dryrun._trace``.

The peak is the largest of the step's phase peaks (``dryrun._Phases``),
each extrapolated on its own: every phase's against the same phase of
the whole trace, and a cell whose winning phase changes between 3
periods and the whole step, where one line through the step's peaks at
2 and 3 periods reads low.
"""
import dataclasses

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import ShapeCfg, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import AdamWCfg

#: analyze_cell's keys -> the whole trace's (``_trace``'s) keys
COUNTS = {"hlo_flops": "flops", "hlo_bytes": "dot_bytes",
          "collectives": "coll", "arg_bytes": "arg_bytes",
          "per_device_bytes": "peak"}
#: over a minute of CPU alone, so outside tier-1: run with -m ""
SLOW = pytest.mark.slow
# state-space (its first period costs less than the next): every step
# kind, the train step in periods and microbatches; an encoder cut with
# the periods outside tier-1
CASES = [("rwkv6-7b", "train"), ("rwkv6-7b", "prefill"),
         ("rwkv6-7b", "decode"),
         pytest.param("whisper-medium", "train", marks=SLOW)]


@pytest.fixture(scope="module")
def mesh():
    with dryrun.fake_group(4):
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))


@pytest.fixture(scope="module")
def traced(mesh):
    """(arch, kind) -> (the whole trace, analyze_cell's result), each
    traced once for this module."""
    done = {}

    def get(arch, kind):
        if (arch, kind) not in done:
            cfg = get_config(arch).reduced()
            cfg = dataclasses.replace(
                cfg, n_layers=4 * cfg.period,
                encoder_layers=4 if cfg.is_encdec else 0)
            shape = ShapeCfg(kind, 32, 8, kind)
            n_micro = 4 if kind == "train" else None
            whole = dryrun._trace(cfg, shape, mesh, torch.device("cpu"),
                                  sc=None, n_micro=n_micro, attn_block=1024,
                                  opt_cfg=AdamWCfg())
            at = {}
            cut = dryrun.analyze_cell(arch, shape, multi_pod=False,
                                      mesh=mesh, cfg=cfg, n_micro=n_micro,
                                      at_peak=at)
            done[arch, kind] = whole, dict(cut, at_peak=at)
        return done[arch, kind]
    return get


@pytest.mark.parametrize("arch,kind", CASES)
def test_extrapolated_counts_equal_the_whole_trace(traced, arch, kind):
    whole, cut = traced(arch, kind)
    for key, wkey in COUNTS.items():
        assert cut[key] == pytest.approx(whole[wkey], rel=1e-12), \
            (key, cut[key], whole[wkey])
    assert cut["hlo_flops_raw_costanalysis"] * 4 == pytest.approx(
        whole["raw"], rel=1e-12)
    assert cut["temp_bytes"] == whole["peak"] - whole["arg_bytes"]


@pytest.mark.parametrize("arch,kind", CASES)
def test_each_phase_s_extrapolated_peak_equals_the_whole_trace_s(
        traced, arch, kind):
    """Every phase fitted from 2 and 3 periods (and microbatches) equals
    the same phase of the whole trace, to the byte; the whole trace's
    middle periods (``.mid``, not fitted) stay within the largest phase
    of their stage; the phases cover the step (the largest is its peak)
    and the winning one is named."""
    whole, cut = traced(arch, kind)
    got, want = cut["at_peak"]["phases"], whole["phases"]
    assert set(got) == {r for r in want if not r.endswith(".mid")}
    for role, peak in got.items():
        assert peak == want[role], (role, peak, want[role])
    for role, peak in want.items():
        if role.endswith(".mid"):
            stage = role[:-len("mid")]
            assert peak <= max(v for r, v in want.items()
                               if r.startswith(stage)
                               and not r.endswith(".mid")), role
    assert max(want.values()) == whole["peak"]
    assert got[cut["at_peak"]["phase"]] == cut["per_device_bytes"]
    want_stages = {"train": {"step", "fwd.in", "fwd.p", "loss", "bwd.out",
                             "bwd.p", "bwd.in", "acc", "opt"},
                   "prefill": {"step", "fwd.in", "fwd.p", "cache", "head"},
                   "decode": {"step", "head"}}[kind]
    stages = {r.split("/")[-1].replace(".first", "").replace(".last", "")
              for r in got}
    assert stages == want_stages, stages


def test_a_peak_whose_phase_changes_past_3_periods(mesh):
    """Reduced qwen1.5-0.5b at 8 periods, its vocab at 1,536 and its FFN
    at 1,024: at 2 and 3 periods the backward over the logits
    (``bwd.out``) holds the most, at 8 the backward through the first
    period (``bwd.p.first``), which holds every later period's
    gradients. One line through the step's peaks at 2 and 3 periods
    reads 6,677,264 bytes, below the whole trace's 7,087,888 (the
    parent's fit; its own trace, which lost every gradient once
    reduce-scattered, read 6,677,264 whole too); each phase fitted on
    its own gives the whole trace's peak."""
    base = get_config("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(base, n_layers=8, vocab=1536, d_ff=1024)
    shape = ShapeCfg("train", 32, 8, "train")
    kw = dict(sc=None, n_micro=1, attn_block=1024, opt_cfg=AdamWCfg())
    dev = torch.device("cpu")
    t2, t3, whole = (dryrun._trace(dryrun._cut(cfg, p), shape, mesh, dev,
                                   **kw) for p in (2, 3, 8))
    line = t2["peak"] + (8 - 2) * (t3["peak"] - t2["peak"])
    at = {}
    cut = dryrun.analyze_cell("qwen1.5-0.5b", shape, multi_pod=False,
                              mesh=mesh, cfg=cfg, n_micro=1, at_peak=at)
    won = {t["phases"][r] == t["peak"] and r
           for t in (t2, t3) for r in t["phases"]} - {False}
    assert won == {"mb0/bwd.out"}, won
    assert line == 6_677_264 < whole["peak"], (line, whole["peak"])
    assert cut["per_device_bytes"] == whole["peak"] == 7_087_888
    assert at["phase"] == "mb0/bwd.p.first"
    assert cut["temp_bytes"] == whole["peak"] - whole["arg_bytes"]
