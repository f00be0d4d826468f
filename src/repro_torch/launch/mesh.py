"""Device meshes over ``torch.distributed``: the port of
``repro.launch.mesh``.

Axes, as the reference's: "data" (batch, federated cohorts, FSDP),
"model" (tensor and expert parallel) and, on two pods, "pod". A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, which the caller initialises first (its address, world size and
rank: nothing here reads a cluster's environment). A mesh always spans
the whole world: a mesh whose shape does not cover every rank raises
and names both sizes, where the reference would leave devices idle.

The planners (``launch/sharding.py``, ``launch/specs.py``) take axis
sizes (``mesh_axis_sizes``), not devices, so a 16 x 16 plan is computed
on one card or on the CPU.

The card's constants below are NVIDIA's data sheet for the H100 SXM part
("NVIDIA H100 80GB HBM3"), dense rates at its 700 W limit; the roofline
reckonings of the port read them from here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

# NVIDIA H100 80GB HBM3 (SXM), NVIDIA's data sheet, per card
H100_NAME = "NVIDIA H100 80GB HBM3"
H100_PEAK_FLOPS_BF16 = 989e12     # FLOP/s, tensor cores, dense
H100_PEAK_FLOPS_F32 = 67e12       # FLOP/s, outside the tensor cores
H100_HBM_BW = 3.35e12             # bytes/s, HBM3
H100_HBM_BYTES = 80e9             # bytes of HBM3
H100_NVLINK_BW = 450e9            # bytes/s each way, to the host's other cards

PRODUCTION_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def mesh_over_world(shape: Tuple[int, ...], axes: Tuple[str, ...],
                    device_type: str):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default process group, in rank order; raises where the shape does not
    hold exactly the world."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh holds "
                           f"{size} ranks, the world has {world}")
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``: 256 or 512 ranks."""
    if multi_pod:
        return mesh_over_world((2, 16, 16), MULTI_POD_AXES, device_type)
    return mesh_over_world((16, 16), PRODUCTION_AXES, device_type)


def smoke_mesh_shape(world: int, multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The smoke mesh's (shape, axes) at ``world`` ranks: the reference's
    rule, (2, 2, 2) with ``multi_pod`` at 8 ranks, (2, 2) at 4, (1, 1) at
    1; at any other world size, (world, 1), every rank on "data" (the
    reference would use a subset of its devices there)."""
    if multi_pod and world == 8:
        return (2, 2, 2), MULTI_POD_AXES
    if world == 4:
        return (2, 2), PRODUCTION_AXES
    return (world, 1), PRODUCTION_AXES


def make_smoke_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The small mesh over every rank of the world (``smoke_mesh_shape``):
    one process, or ``torchrun --nproc-per-node N``."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    shape, axes = smoke_mesh_shape(dist.get_world_size(), multi_pod)
    return mesh_over_world(shape, axes, device_type)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``: what the planners take."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
