"""The production mesh and the H100's constants for the dry run's
roofline: the port of ``repro.launch.mesh``.

A FUNCTION, not a module constant: importing this module touches no
device state and starts nothing. The mesh is a ``DeviceMesh`` over the
ranks of the process group the caller has started (the dry run starts a
``fake`` one of 256 or 512 ranks: ``launch.dryrun``).
"""
from __future__ import annotations

#: the reference's two layouts: 256 GPUs as (data 16, model 16), and two
#: pods of them, 'pod' pure data parallelism (only the gradients'
#: reduce-scatter crosses pods)
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """A ``DeviceMesh`` of the single-pod layout (16, 16) or, with
    ``multi_pod``, (2, 16, 16), over every rank of the started process
    group, on ``device``'s type (``None``: the card's, ``cuda``). Raises
    without a process group, or when its world size is not the layout's
    256 or 512 ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = 1
    for s in shape:
        n *= s
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_production_mesh: no process group; start "
                           "one of 256 or 512 ranks")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"make_production_mesh: the {'x'.join(map(str, shape))}"
                         f" mesh needs a group of {n} ranks, not {world}")
    kind = torch.device(device).type if device is not None else "cuda"
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


# H100 SXM5 constants for the roofline (per GPU), from NVIDIA's H100 data
# sheet: dense bf16 tensor-core peak (the 1,979 TFLOP/s of the sheet is
# with 2:4 sparsity) and HBM3 bandwidth.
PEAK_FLOPS_BF16 = 989.4e12    # FLOP/s
HBM_BW = 3.35e12              # B/s
# The collective term's link. Both meshes' 16-wide axes span two 8-GPU
# NVLink nodes (as in a DGX H100), so a ring over such an axis crosses the
# nodes' network, not only NVLink 4 (450 GB/s each way inside a node): one
# 400 Gb/s NDR InfiniBand port per GPU (ConnectX-7, the DGX H100 data
# sheet's 8 x 400 Gb/s compute fabric), 50 GB/s each way. The term is an
# upper bound on time for the 'data' and 'model' axes alike.
LINK_BW = 50e9                # B/s per GPU
