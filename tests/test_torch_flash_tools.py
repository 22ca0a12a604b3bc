"""What surrounds the Hopper flash kernel, on the CPU.

The kernel itself builds and runs only on the card (``test_torch_card``).
Here: the wrapper and its config query refuse what the kernel does not
take before they build anything, ``chip_smoke.py``'s lost-mask check
pads to the kernel's own key tile, its searchsorted shape count counts
launches only and leaves the package as it found it, and its split of
those launches picks the shapes it checks the kernel at.
"""
import collections
import re

import pytest
import torch

import chip_smoke
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import config, flash_attention


def test_each_source_builds_into_a_library_named_by_its_hash():
    paths = [build._lib_path(name) for name in build.SOURCES]
    assert len(set(paths)) == len(build.SOURCES)
    assert paths == [build._lib_path(name) for name in build.SOURCES]
    assert all(p.parent == build.BUILD_DIR for p in paths)


@pytest.mark.parametrize("block_m", [0, 32, 96, 256])
def test_flash_refuses_a_tile_it_has_no_instance_for(block_m):
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, block_m=block_m)


def test_flash_forced_tile_on_the_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, 4, 64, generator=g) for _ in range(3))
    want = ref.attention(q, k, v, causal=True, block=16)
    for block_m in (None, 64, 128):
        got = flash_attention(q, k, v, causal=True, block=16,
                              block_m=block_m)
        assert torch.equal(got, want)


@pytest.mark.parametrize("hd", [16, 96, 256])
def test_flash_config_refuses_other_head_dims(hd):
    with pytest.raises(ValueError):
        config(1, 512, 16, hd, "cpu")


def test_lost_mask_check_pads_to_the_kernel_key_tile():
    src = (build.CSRC / "flash_attention.cu").read_text()
    tile = int(re.search(r"constexpr int kBN = (\d+);", src).group(1))
    assert tile == chip_smoke.FLASH_BLOCK_N
    # shape (c) has a ragged key tile, so the check runs there
    assert any(sk % tile for _, _, sk, *_ in chip_smoke.FLASH_SHAPES)


def test_serve_shapes_cover_every_serve_prompt_length():
    lengths = {s[1] for s in chip_smoke.FLASH_SERVE_SHAPES}
    assert lengths == set(chip_smoke.SERVE_PROMPTS)
    assert all(s[1] == s[2] and s[6] for s in chip_smoke.FLASH_SERVE_SHAPES)


def test_searchsorted_shapes_count_launches_only_and_restore_ops():
    kernel = ops._searchsorted_kernel
    tab = ref.flip(torch.sort(torch.randint(-2**63, 2**63 - 1, (64,),
                                            dtype=torch.int64)).values)
    q = tab[::3].contiguous()
    with chip_smoke.searchsorted_shapes(ops) as hist:
        got = ops.lower_bound(tab, q)
        ops.upper_bound(tab, q[:1])
    # CPU tensors run the plain version: nothing launched, nothing counted
    assert not hist
    assert ops._searchsorted_kernel is kernel
    assert torch.equal(got, ref.lower_bound(tab, q, "left"))


def test_searchsorted_groups_partition_the_query_counts():
    groups = chip_smoke.SEARCH_GROUPS
    assert groups[0][1] == 1 and groups[-1][2] is None
    for (_, _, hi), (_, lo, _) in zip(groups, groups[1:]):
        assert lo == hi + 1


def test_searchsorted_split_checks_the_commonest_shapes_and_largest_table():
    hist = collections.Counter({(100_000, 1): 184, (262_144, 15): 44,
                                (262_144, 705): 44, (12_002_430, 15): 4,
                                (100_000, 15): 2, (5_000, 2_000): 3})
    groups, checks = chip_smoke.split_by_queries(hist)
    assert [g["launches"] for g in groups] == [184, 94, 3, 0]
    assert sum(g["launches"] for g in groups) == sum(hist.values())
    # the commonest of all first (the kernels line reads it); a tie in
    # launches goes to the larger shape
    assert checks == [(100_000, 1), (262_144, 705), (5_000, 2_000),
                      (12_002_430, 15)]
    assert [g["timed_shape"] for g in groups] == [
        [100_000, 1], [262_144, 705], [5_000, 2_000], None]
    assert groups[1]["top_shapes"][0] == [262_144, 705, 44]


def test_searchsorted_split_of_no_launches_checks_nothing():
    groups, checks = chip_smoke.split_by_queries(collections.Counter())
    assert checks == [] and all(g["launches"] == 0 for g in groups)


def test_bwd_draws_holds_both_paths_to_the_card_tests_allowance():
    """The dO-draw study (``benchmarks/bwd_draws.py``) uses the card
    test's tolerances and shape; on the CPU both of its paths are the
    plain one, so one draw rehearses its control flow."""
    from repro_torch.benchmarks import bwd_draws
    assert bwd_draws.REL_TOL == chip_smoke.BWD_REL_TOL
    rec = bwd_draws.run(1, 7, device="cpu")
    assert rec["do_seeds"] == [7, 7] and rec["device"] == "cpu"
    assert rec["kernel_not_close_to_plain"] == []
    assert 0 < rec["kernel_err"] and 0 < rec["plain_err"] < 0.05
