"""Meshes over the initialised process group, and the card's constants.

Counterpart of ``repro.launch.mesh``'s ``make_host_mesh`` and ``HW``. The
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank of
the default process group (one rank a device: NCCL on the card, gloo on
the CPU). The reference's ``make_production_mesh`` (256 and 512 devices)
belongs with its dry run and is not ported yet.

Functions, not module constants: importing this module touches no device
and no process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["make_host_mesh", "HW"]


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    default process group's ranks, in rank order; ``device_type`` defaults
    to ``cuda`` under NCCL and ``cpu`` otherwise. Raises if no group is
    initialised or its world size is not ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: initialise the process group first "
                           "(torch.distributed.init_process_group)")
    shape, axes = tuple(shape), tuple(axes)
    world = dist.get_world_size()
    if world != math.prod(shape) or len(shape) != len(axes):
        raise ValueError(f"make_host_mesh: a {shape} mesh named {axes} over a world of {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


class HW:
    """Roofline constants of one NVIDIA H100 80GB HBM3 (SXM), per card.

    ``PEAK_FLOPS_BF16`` (989 TFLOP/s, dense bf16/fp16 tensor-core peak) and
    ``HBM_BW`` (3.35 TB/s) are the datasheet figures the port's kernel
    bounds use; ``NVLINK_BW`` (900 GB/s, bidirectional NVLink 4 per card)
    is a datasheet number, not a measurement. ``hbm_bytes`` reads the
    card's ``total_memory``. The card the port was measured on reported
    "NVIDIA H100 80GB HBM3, 700.00 W" to ``nvidia-smi --query-gpu=name,
    power.limit``; a card set below 700 W runs slower under load."""

    PEAK_FLOPS_BF16 = 989e12  # FLOP/s
    HBM_BW = 3.35e12  # B/s
    NVLINK_BW = 900e9  # B/s, datasheet

    @staticmethod
    def hbm_bytes(device=0) -> int:
        return torch.cuda.get_device_properties(device).total_memory
