"""The dry run's memory figures: ``op_analysis.LiveBytes`` counts each
storage from its op until it is freed, and one rank's peak of the
sharded steps falls when the data axis doubles. Reduced qwen1.5-0.5b,
64 tokens, 16 rows, on fake (pod, data, model) meshes of the ``"cpu"``
type: 1 x 2 x 2 against 2 x 2 x 2.

Two faults held global tensors on every rank: the train step's loss took
its gradient through ``new_zeros`` of the whole batch's float32 logits
(DTensor's ``gather`` backward, a replicated tensor), and a prefill made
its whole cache on every rank before placing it.
"""
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import ShapeCfg, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import LiveBytes
from repro_torch.launch.steps import AdamWCfg

ARCH = "qwen1.5-0.5b"
TOKENS, ROWS, N_MICRO = 32, 16, 1
NAMES = ("pod", "data", "model")


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


def _trace(kind: str, pods: int):
    """``kind``'s step of the reduced config on a fake pods x 2 x 2
    mesh: ``dryrun._trace``'s counts."""
    n = 4 * pods
    with dryrun.fake_group(n):
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(pods, 2, 2),
                          mesh_dim_names=NAMES)
        return dryrun._trace(get_config(ARCH).reduced(),
                             ShapeCfg(kind, TOKENS, ROWS, kind), mesh,
                             torch.device("cpu"), sc=None,
                             n_micro=N_MICRO if kind == "train" else None,
                             attn_block=1024, opt_cfg=AdamWCfg())


@pytest.fixture(scope="module")
def traces():
    return {(kind, pods): _trace(kind, pods)
            for kind in ("train", "prefill") for pods in (1, 2)}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_one_ranks_peak_falls_as_the_data_axis_doubles(traces, kind):
    """The state, and the activations and the cache with the rows."""
    one, two = traces[kind, 1], traces[kind, 2]
    assert two["arg_bytes"] < one["arg_bytes"], (one, two)
    assert two["peak"] < 0.75 * one["peak"], (one["peak"], two["peak"])


@pytest.mark.parametrize("pods", [1, 2])
def test_the_train_peak_holds_only_this_ranks_rows(traces, pods):
    """The storages live at the peak add up to it, and none is larger
    than this rank's rows of one microbatch's float32 logits, whole over
    the vocab (``ModelSharding.row_sums``): the loss's largest tensor."""
    t = traces["train", pods]
    at = t["at_peak"]
    assert sum(n for n, _, _ in at) == t["peak"]
    rows = ROWS // N_MICRO // (2 * pods)
    logits = rows * TOKENS * get_config(ARCH).reduced().vocab * 4
    assert max(n for n, _, _ in at) <= logits, at[:4]
