"""Every architecture, reduced, traces every step kind through the dry
run on a fake 2 x 2 x 2 (pod, data, model) mesh of the ``"cpu"`` type:
``launch.dryrun.analyze_cell`` on ``launch.steps``' train, prefill and
decode steps at a small shape (64 tokens, 8 rows), with the reference's
result keys, counts that are positive and a peak that holds the state.
The production sizes are traced on the card host (``dryrun --all``).
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import ShapeCfg, all_arch_names, get_config
from repro_torch.launch import dryrun

KINDS = ("train", "prefill", "decode")
#: the reference's result keys (repro/launch/dryrun.py's ``res``)
KEYS = {"arch", "shape", "mesh", "chips", "lower_s", "compile_s",
        "per_device_bytes", "arg_bytes", "temp_bytes", "hlo_flops",
        "hlo_flops_raw_costanalysis", "hlo_bytes", "collective_bytes",
        "collectives", "t_compute_s", "t_memory_s", "t_collective_s",
        "bottleneck", "model_flops_per_chip", "useful_flops_ratio",
        "roofline_fraction"}


@pytest.fixture(scope="module")
def mesh():
    with dryrun.fake_group(8):
        yield DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                         mesh_dim_names=("pod", "data", "model"))
    assert not dist.is_initialized()


def _one_period(cfg):
    """``cfg`` (reduced) cut to one period: the slots' every op, once."""
    return dataclasses.replace(cfg, n_layers=cfg.period,
                               encoder_layers=min(cfg.encoder_layers, 1))


@pytest.mark.parametrize("arch", all_arch_names())
def test_every_arch_traces_every_step_kind(mesh, arch):
    cfg = _one_period(get_config(arch).reduced())
    for kind in KINDS:
        r = dryrun.analyze_cell(arch, ShapeCfg(kind, 64, 8, kind),
                                multi_pod=True, mesh=mesh, cfg=cfg)
        assert set(r) == KEYS, (kind, set(r) ^ KEYS)
        assert r["mesh"] == "2x2x2" and r["chips"] == 8
        assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0, (kind, r)
        assert r["model_flops_per_chip"] > 0
        assert 0 < r["arg_bytes"] <= r["per_device_bytes"], (kind, r)
        assert r["temp_bytes"] == r["per_device_bytes"] - r["arg_bytes"]
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert r["compile_s"] == 0.0
        # the state is sharded: a step moves some of it between ranks
        assert r["collective_bytes"] > 0, (kind, r)

