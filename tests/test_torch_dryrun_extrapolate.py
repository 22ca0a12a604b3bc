"""The dry run's extrapolation (``analyze_cell`` on a step of more than 3
periods or microbatches): traces at 2 and 3 periods and at 2 and 3
microbatches give, extrapolated, the whole trace's counts, bytes held
and peak, to the byte. Reduced configs at 4 periods, train steps of 4
microbatches, on a fake 2 x 2 (data, model) mesh of the ``"cpu"`` type;
the whole step traced once by ``dryrun._trace``.
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


@pytest.fixture(scope="module")
def mesh():
    with dryrun.fake_group(4):
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))


# state-space (its first period costs less than the next): every step
# kind, the train step in periods and microbatches; an encoder cut with
# the periods outside tier-1
@pytest.mark.parametrize("arch,kind", [
    ("rwkv6-7b", "train"), ("rwkv6-7b", "prefill"), ("rwkv6-7b", "decode"),
    pytest.param("whisper-medium", "train", marks=SLOW)])
def test_extrapolated_counts_equal_the_whole_trace(mesh, arch, kind):
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=4 * cfg.period,
                              encoder_layers=4 if cfg.is_encdec else 0)
    shape = ShapeCfg(kind, 32, 8, kind)
    n_micro = 4 if kind == "train" else None
    whole = dryrun._trace(cfg, shape, mesh, torch.device("cpu"), sc=None,
                          n_micro=n_micro, attn_block=1024,
                          opt_cfg=AdamWCfg())
    cut = dryrun.analyze_cell(arch, shape, multi_pod=False, mesh=mesh,
                              cfg=cfg, n_micro=n_micro)
    for key, wkey in COUNTS.items():
        assert cut[key] == pytest.approx(whole[wkey], rel=1e-12), \
            (key, cut[key], whole[wkey])
    assert cut["hlo_flops_raw_costanalysis"] * 4 == pytest.approx(
        whole["raw"], rel=1e-12)
    assert cut["temp_bytes"] == whole["peak"] - whole["arg_bytes"]
