"""What one rank computes of attention on a fake (pod, data, model) mesh
of the ``"cpu"`` type, traced by the dry run (``dryrun._trace``):

- the prefill step's attention, where H divides 'model' and KV does not
  (reduced granite-20b: 4 query heads on one KV head; reduced qwen with
  6 query heads on 3 KV heads, whose 3 query heads a rank straddle two
  groups): each rank attends with its H / m query heads, so its traced
  attention FLOPs fall by about the 'model' width;
- the decode step over a cache whose sequence is split (over 'model'
  under ``cache_seq_model``, reduced granite; over 'data' under
  ``seq_shard_cache``, reduced jamba's mamba, MoE and attention slots):
  each rank scores its own slots and no rank gathers the cache, so the
  step's all-gather bytes stay below one layer's cache gathered whole.
  Before, every decode step gathered every layer's cache on every rank.
"""
import dataclasses

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import ShapeCfg, get_config, period_slots
from repro_torch.distributed.sharding import ShardCfg
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import CostMode
from repro_torch.launch.steps import AdamWCfg

NAMES = ("pod", "data", "model")


def _config(arch):
    if arch == "qwen1.5-0.5b/h6":
        return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                                   n_heads=6, n_kv_heads=3)
    cfg = get_config(arch).reduced()
    return period_slots(cfg, (0, 1, 4)) if arch.startswith("jamba") else cfg


def _trace(cfg, shape, data, model, sc=None):
    n = data * model
    with dryrun.fake_group(n):
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(1, data, model),
                          mesh_dim_names=NAMES)
        return dryrun._trace(cfg, shape, mesh, torch.device("cpu"), sc=sc,
                             n_micro=None, attn_block=1024,
                             opt_cfg=AdamWCfg())


@pytest.mark.parametrize("arch", ["granite-20b", "qwen1.5-0.5b/h6"])
def test_a_ranks_attention_flops_fall_with_the_model_axis(monkeypatch,
                                                          arch):
    """One rank's FLOPs inside ``ops.attention`` (the flash op's plain
    version, traced) in the prefill step of 64 tokens x 8 rows on 1 x 2 x
    m: at least 1.9x fewer at m = 2 than at m = 1."""
    counted = []
    attention = ops.attention

    def counting_attention(*args, **kw):
        mode = CostMode()
        with mode:
            out = attention(*args, **kw)
        counted[-1] += mode.cost.flops
        return out
    monkeypatch.setattr(ops, "attention", counting_attention)
    flops = {}
    for model in (1, 2):
        counted.append(0.0)
        _trace(_config(arch), ShapeCfg("prefill", 64, 8, "prefill"), 2,
               model)
        flops[model] = counted[-1]
    assert flops[2] > 0
    assert flops[1] / flops[2] >= 1.9, flops


#: (arch, strategy, the mesh dim the cache's sequence is split over)
DECODE = [("granite-20b", None, "model"),
          ("jamba-1.5-large-398b", ShardCfg(seq_shard_cache=True), "data")]


@pytest.mark.parametrize("arch,sc,over", DECODE, ids=[d[0] for d in DECODE])
def test_decode_gathers_no_cache_over_its_sequence_shards(arch, sc, over):
    """The decode step at 1,024 tokens x 8 rows on 1 x 2 x 2: its
    all-gather bytes (each all-gather's operand, one rank's) stay below
    one layer's K shard times the 2 ranks that split the sequence, which
    is what gathering a single layer's K would take; before, the step
    gathered K and V of every attention layer."""
    cfg = _config(arch)
    t = _trace(cfg, ShapeCfg("decode", 1024, 8, "decode"), 2, 2, sc=sc)
    cap = 1024 + 128
    rows = 8 if over == "data" else 8 // 2          # the cache's own rows
    kv = cfg.n_kv_heads // 2 if cfg.n_kv_heads % 2 == 0 else cfg.n_kv_heads
    shard = rows * cap // 2 * kv * cfg.hd * 2       # bf16
    assert t["coll"].get("all-gather", 0.0) < shard * 2, (t["coll"], shard)
