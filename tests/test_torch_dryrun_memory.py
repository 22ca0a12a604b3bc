"""The dry run's memory figures: ``op_analysis.LiveBytes`` counts each
storage from its op until it is freed, and one rank's peak and FLOPs of
the sharded steps fall when the data axis doubles. Reduced qwen1.5-0.5b,
and beside it a MoE config (mixtral-8x7b, its 4 experts over 'model')
and the state-space mixers (rwkv6-7b; jamba's mamba, MoE and attention
slots), 32 tokens, 16 rows, on fake (pod, data, model) meshes of the
``"cpu"`` type: 1 x 2 x 2 against 2 x 2 x 2.

Reduced llama-3.2-vision-90b (its cross and first attention slots), its
context widened to 300 patches, takes
its train step in two microbatches on the same meshes: the microbatch
split moves each rank's rows by all-to-all, so nothing the step makes
holds more context rows than the rank's share of one microbatch, and
its peak does not grow with the pods.

Faults that held global tensors on every rank: the train step's loss
took its gradient through ``new_zeros`` of the whole batch's float32
logits (DTensor's ``gather`` backward, a replicated tensor); a prefill
made its whole cache on every rank before placing it; the MoE FFN and
the mixers ran whole on every rank (all rows, all experts, all heads);
the loss gathered the logits whole over the vocab; and the microbatch
split gathered a batch sharded over two data-parallel axes whole before
it took its slices (llama-vision's context at 2 x 16 x 16).
"""
import dataclasses

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import ShapeCfg, get_config, period_slots
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import LiveBytes
from repro_torch.launch.steps import AdamWCfg

ARCH = "qwen1.5-0.5b"
#: a MoE config, and the state-space ones (jamba at its mamba, MoE and
#: attention slots, as ``test_torch_train_ssm`` cuts it)
OTHERS = ("mixtral-8x7b", "rwkv6-7b", "jamba-1.5-large-398b")
TOKENS, ROWS, N_MICRO = 32, 16, 1
NAMES = ("pod", "data", "model")
MODEL = 2


def _cfg(arch):
    cfg = get_config(arch).reduced()
    return period_slots(cfg, (0, 1, 4)) if arch.startswith("jamba") else cfg


def test_live_bytes_counts_a_storage_until_it_is_freed():
    mem = LiveBytes()
    with mem:
        a = torch.ones(256)                   # 1,024 bytes
        _ = a.view(16, 16)                    # a view: nothing new
        _ = torch.empty(1 << 20, device="meta")   # shapes alone
        c = a * 2                             # 1,024
        del c
        d = torch.ones(128)                   # 512
    assert (mem.peak, mem.live) == (2048, 1536)
    at = mem.largest_at_peak(None)
    assert [(n, shape) for n, _, shape in at] == [(1024, (256,)),
                                                 (1024, (256,))]
    assert at[1][1] == "aten.mul.Tensor"
    del a, d


def test_live_bytes_counts_a_waited_collective_until_it_is_freed():
    """On the card a collective's wait returns its input; a fake one
    makes a new storage. The result's bytes count once, while either
    storage lives. Before, they went with the unwaited tensor, so a
    reduce-scattered gradient or an all-gathered weight left the count
    once waited on; and a view of the waited one counted them a second
    time while the unwaited one lived (36,864 bytes here, not 20,480)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    c10d = torch.ops._c10d_functional
    with dryrun.fake_group(4), FakeTensorMode():
        group = dist.distributed_c10d._get_default_group().group_name
        x = torch.ones(64, 16)                              # 4,096 bytes
        mem = LiveBytes()
        mem.track(x)
        with mem:
            y = c10d.all_gather_into_tensor(x, 4, group)    # 16,384
            z = c10d.wait_tensor(y)
            assert z.untyped_storage()._cdata != \
                y.untyped_storage()._cdata
            v = z.view(16, 256)
            assert mem.live == 4096 + 16384
            del y, v
            assert mem.live == 4096 + 16384
            w = z * 2                                       # 16,384
            del z
            assert (mem.live, mem.peak) == (4096 + 16384, 4096 + 32768)
            del w
        assert mem.live == 4096


def _trace(arch: str, kind: str, pods: int):
    """``kind``'s step of the reduced config on a fake pods x 2 x 2
    mesh: ``dryrun._trace``'s counts."""
    n = 2 * MODEL * pods
    with dryrun.fake_group(n):
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(pods, 2, MODEL),
                          mesh_dim_names=NAMES)
        return dryrun._trace(_cfg(arch),
                             ShapeCfg(kind, TOKENS, ROWS, kind), mesh,
                             torch.device("cpu"), sc=None,
                             n_micro=N_MICRO if kind == "train" else None,
                             attn_block=1024, opt_cfg=AdamWCfg())


@pytest.fixture(scope="module")
def traces():
    return {(arch, kind, pods): _trace(arch, kind, pods)
            for arch in (ARCH,) + OTHERS for kind in ("train", "prefill")
            for pods in (1, 2)}


#: qwen's cases keep their first ids ("train", "prefill")
PEAK_CASES = [pytest.param(ARCH, kind, id=kind)
              for kind in ("train", "prefill")] + \
    [(arch, kind) for arch in OTHERS for kind in ("train", "prefill")]


@pytest.mark.parametrize("arch,kind", PEAK_CASES)
def test_one_ranks_peak_falls_as_the_data_axis_doubles(traces, arch, kind):
    """The state, and the activations and the cache with the rows."""
    one, two = traces[arch, kind, 1], traces[arch, kind, 2]
    assert two["arg_bytes"] < one["arg_bytes"], (one, two)
    assert two["peak"] < 0.75 * one["peak"], (one["peak"], two["peak"])


@pytest.mark.parametrize("arch", OTHERS)
def test_a_ranks_train_flops_fall_as_the_data_axis_doubles(traces, arch):
    """The MoE FFN and the mixers run on this rank's rows (and its
    experts or heads), not the whole batch: one rank's traced FLOPs of
    the train step fall by at least qwen's own factor less 5% as the
    data axis doubles."""
    def factor(a):
        return traces[a, "train", 1]["flops"] / traces[a, "train", 2]["flops"]
    assert factor(arch) >= 0.95 * factor(ARCH), (factor(arch), factor(ARCH))


@pytest.mark.parametrize("pods", [1, 2])
def test_the_train_peak_holds_only_this_ranks_rows(traces, pods):
    """The storages live at the peak add up to it, and none is larger
    than this rank's rows of one microbatch's float32 logits, whole over
    the vocab: the loss's largest tensor."""
    t = traces[ARCH, "train", pods]
    at = t["at_peak"]
    assert sum(n for n, _, _ in at) == t["peak"]
    rows = ROWS // N_MICRO // (2 * pods)
    logits = rows * TOKENS * get_config(ARCH).reduced().vocab * 4
    assert max(n for n, _, _ in at) <= logits, at[:4]


@pytest.mark.parametrize("arch", (ARCH,) + OTHERS)
@pytest.mark.parametrize("pods", [1, 2])
def test_the_train_peak_holds_no_more_than_a_vocab_shard_of_logits(
        traces, arch, pods):
    """No storage live at the train step's peak is larger than this
    rank's rows of one microbatch's float32 logits over its own vocab
    shard (``ModelSharding.nll_sums``: the logits stay split over
    'model')."""
    at = traces[arch, "train", pods]["at_peak"]
    rows = ROWS // N_MICRO // (2 * pods)
    shard = rows * TOKENS * _cfg(arch).vocab // MODEL * 4
    assert max(n for n, _, _ in at) <= shard, at[:4]


#: llama-vision's patches, widened from the reduced 8 so that the context
#: is the largest input (a size no other dim of the config has)
PATCHES = 300


@pytest.fixture(scope="module")
def context_traces():
    """Reduced llama-3.2-vision-90b at its cross and first attention
    slots, with PATCHES patches, its train step in 2 microbatches on pods
    x 2 x 2, for 1 and 2 pods."""
    cfg = dataclasses.replace(
        period_slots(get_config("llama-3.2-vision-90b").reduced(), (0, 1)),
        cross_len=PATCHES)
    out = {}
    for pods in (1, 2):
        n = 2 * MODEL * pods
        with dryrun.fake_group(n):
            mesh = DeviceMesh("cpu",
                              torch.arange(n).reshape(pods, 2, MODEL),
                              mesh_dim_names=NAMES)
            out[pods] = dryrun._trace(
                cfg, ShapeCfg("train", TOKENS, ROWS, "train"), mesh,
                torch.device("cpu"), sc=None, n_micro=2, attn_block=1024,
                opt_cfg=AdamWCfg())
    return out


@pytest.mark.parametrize("pods", [1, 2])
def test_no_tensor_of_the_step_holds_more_context_rows_than_a_microbatchs(
        context_traces, pods):
    """Every storage live at the train peak that the step made and that
    spans the context's patches holds at most this rank's rows of one
    microbatch (ROWS / 2 / (2 pods)); the rank's input shard (twice that,
    both microbatches) is the only one with more. Before, the split
    gathered the batch over both data-parallel axes: a clone of every
    rank's rows of a slice, (2, 2, PATCHES, 64) on 2 pods."""
    share = ROWS // 2 // (2 * pods)
    spans = [(op, shape) for _, op, shape in context_traces[pods]["at_peak"]
             if PATCHES in shape]
    made = [(op, shape) for op, shape in spans if op != "track"]
    assert made, spans
    for op, shape in made:
        rows = 1
        for d in shape[:shape.index(PATCHES)]:
            rows *= d
        assert rows <= share, (op, shape, share)
    assert [shape[0] for op, shape in spans if op == "track"] == \
        [2 * share]


def test_the_context_configs_train_peak_does_not_grow_with_the_pods(
        context_traces):
    """At 2 x 2 x 2 the train peak is at or below its 1 x 2 x 2 peak (the
    reference's ``P(None, dp)`` slices over both data-parallel axes), and
    the split moved its rows by all-to-all alone."""
    one, two = context_traces[1], context_traces[2]
    assert two["peak"] <= one["peak"], (one["peak"], two["peak"])
    for t in (one, two):
        assert t["coll"]["all-to-all"] > 0, t["coll"]
