"""Production mesh definition over ``torch.distributed``.

``make_production_mesh`` is a FUNCTION (importing this module touches no
process group).  Single-pod: 16x16 = 256 ranks; multi-pod: 2 pods x 256 =
512 ranks with a leading ``pod`` axis (data parallelism across pods).  The
process group must already be running with exactly that many ranks (e.g.
under ``torchrun``): a mesh is never built over fewer ranks than it names.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type(device) -> str:
    return "cpu" if str(device).startswith("cpu") else "cuda"


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh "
            f"{shape} needs a process group of {need} ranks, this one has "
            f"{world}")
    return init_device_mesh(_device_type(device), shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device="cpu") -> DeviceMesh:
    """A ``(data, model)`` mesh over the running process group (its world
    size must be ``data * model``) — for the distributed tests and small
    runs, never the production shapes."""
    return init_device_mesh(_device_type(device), (data, model),
                            mesh_dim_names=("data", "model"))
