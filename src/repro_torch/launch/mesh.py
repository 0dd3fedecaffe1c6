"""Meshes over the initialised process group, and the card's constants.

Counterpart of ``repro.launch.mesh``. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every rank of the default
process group (one rank a device: NCCL on the card, gloo on the CPU).
``make_production_mesh`` gives the reference's production meshes, 16 x 16
("data", "model") and 2 x 16 x 16 ("pod", "data", "model"): "pod" is pure
data parallelism, "data" FSDP, "model" tensor parallelism. The dry run
(``launch/dryrun.py``) builds them over a fake group of 256 or 512 ranks in
one process (``fake_group``), where this process is rank 0 and every
collective returns at once.

Functions, not module constants: importing this module touches no device
and no process group.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

__all__ = ["make_host_mesh", "make_production_mesh", "fake_group", "HW"]


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


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of a production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The 16 x 16 ("data", "model") mesh, or with ``multi_pod`` the 2 x 16 x
    16 ("pod", "data", "model") one, over the process group the caller
    opened (``fake_group`` for a dry run)."""
    shape, axes = production_shape(multi_pod)
    return make_host_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A fake default process group of ``world`` ranks in this process
    (``torch.testing``'s ``FakeStore``, backend "fake"): this process is
    ``rank``, every collective returns at once and leaves its output as it
    was. Raises if a default group is already open (one a process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: this process already has a default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


class HW:
    """Roofline constants of one NVIDIA H100 80GB HBM3 (SXM), per card.

    ``PEAK_FLOPS_BF16`` (989 TFLOP/s, dense bf16/fp16 tensor-core peak) and
    ``HBM_BW`` (3.35 TB/s) are the datasheet figures the port's kernel
    bounds use; ``NVLINK_BW`` (900 GB/s, bidirectional NVLink 4 per card)
    is a datasheet number, not a measurement. ``hbm_bytes`` reads the
    card's ``total_memory``. The card the port was measured on reported
    "NVIDIA H100 80GB HBM3, 700.00 W" to ``nvidia-smi --query-gpu=name,
    power.limit``; a card set below 700 W runs slower under load.

    The collective term of the dry run's roofline charges a group's wire
    bytes (already a rank's, under the ring factors) to the slowest link
    its ring crosses (``link_bw``): inside one 8-card NVLink domain (a DGX
    H100 node) ``NVLINK_BW`` / 2 a direction; a group that spans nodes
    crosses ``IB_BW``, the datasheet 400 Gb/s of one NDR InfiniBand
    ConnectX-7 port a card (50 GB/s a direction). On the production meshes
    every axis spans nodes: "model" (16 consecutive ranks) two, "data" and
    "pod" (strides of 16 and 256) sixteen and two."""

    PEAK_FLOPS_BF16 = 989e12  # FLOP/s
    HBM_BW = 3.35e12  # B/s
    NVLINK_BW = 900e9  # B/s, datasheet, both directions
    IB_BW = 50e9  # B/s a direction, datasheet: one 400 Gb/s NDR port a card
    NVLINK_DOMAIN = 8  # cards a node share one NVLink switch fabric

    @staticmethod
    def hbm_bytes(device=0) -> int:
        return torch.cuda.get_device_properties(device).total_memory

    @classmethod
    def link_bw(cls, shape: tuple, axes: tuple, axis: str) -> float:
        """B/s a direction of the slowest link a group along ``axis`` of a
        mesh of ``shape`` named ``axes`` crosses (ranks in row-major order,
        ``NVLINK_DOMAIN`` consecutive ranks a node)."""
        i = axes.index(axis)
        stride = math.prod(shape[i + 1:])
        return cls.NVLINK_BW / 2 if stride * shape[i] <= cls.NVLINK_DOMAIN else cls.IB_BW
