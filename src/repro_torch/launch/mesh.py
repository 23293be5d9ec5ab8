"""Device meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, with the JAX package's axis names. Production
shapes for the H100:

    one pod:   (32, 8)    = (data, model)        -- 256 GPUs
    two pods:  (2, 32, 8) = (pod, data, model)   -- 512 GPUs

the JAX package's 256 / 512 TPU v5e chips ((16, 16) / (2, 16, 16)) as
H100s, with `model` (tensor and expert parallelism, sequence-parallel
decode) kept inside one 8-GPU NVLink node and `data` across nodes. The
sharding rules (``distributed.sharding``) are one function of any shape.

Functions, not module constants: importing this module touches no device
and starts no process group.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from repro_torch.models.transformer import resolve_device

# H100 SXM5 peaks (NVIDIA H100 Tensor Core GPU data sheet), per GPU
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense BF16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, FP32 on the CUDA cores (TF32 is off)
HBM_BW = 3.35e12              # bytes/s, HBM3
NVLINK_BW_PER_LINK = 50e9     # bytes/s, NVLink 4 (900 GB/s over 18 links)


def production_shape(*, multi_pod: bool = False) -> Dict[str, int]:
    """The production mesh's axis sizes, by name, in mesh order."""
    if multi_pod:
        return {"pod": 2, "data": 32, "model": 8}
    return {"data": 32, "model": 8}


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _torchrun_world() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def _start_group(device: torch.device, *, one_rank: bool) -> None:
    """The default process group: one started by `torchrun` (its env://
    variables), else with `one_rank` a group of this process alone on a
    local store."""
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if _torchrun_world():
        dist.init_process_group(_backend(device), init_method="env://")
    elif one_rank:
        dist.init_process_group(_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    else:
        raise RuntimeError(
            "no process group: run under torchrun (RANK, WORLD_SIZE, "
            "MASTER_ADDR, MASTER_PORT) or call "
            "torch.distributed.init_process_group first")


def make_mesh(shape: Sequence[int], names: Sequence[str], *, device="cuda"):
    """A DeviceMesh of `shape` over every rank of the default process group
    (ranks in row-major order), which must hold exactly prod(shape)."""
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    _start_group(device, one_rank=False)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh over {tuple(names)} needs "
                         f"{n} ranks; this world has {world}")
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production mesh (`production_shape`) over a torchrun world of
    its size; raises when the world is another size."""
    shape = production_shape(multi_pod=multi_pod)
    return make_mesh(list(shape.values()), list(shape), device=device)


def make_host_mesh(model_axis: int = 1, *, device="cuda"):
    """A (data, model) mesh over the ranks of the default process group;
    with no group, over a one-rank group of this process (NCCL on "cuda",
    gloo on "cpu")."""
    device = resolve_device(device)
    _start_group(device, one_rank=True)
    world = dist.get_world_size()
    data = max(1, world // model_axis)
    return make_mesh((data, model_axis), ("data", "model"), device=device)
