"""Loss scaling (paper §IV-A: 'a single scaling factor of 1024').

Counterpart of ``repro.core.loss_scaling``. Static scaling is the paper's;
dynamic scaling (skip on overflow, halve; double after a run of finite
steps) is the option for runs beyond it. The state is three 0-d tensors on
the device and every update is a ``torch.where``, so no step waits on a
host read of the scale or of the finite flag.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._tree import tree_leaves, tree_map

__all__ = [
    "LossScaleState", "static_init", "dynamic_init", "scale_loss",
    "unscale_and_check", "adjust",
]


class LossScaleState(NamedTuple):
    scale: torch.Tensor  # f32 scalar
    growth_counter: torch.Tensor  # int32 scalar
    dynamic: torch.Tensor  # bool scalar


def _init(scale: float, dynamic: bool, device) -> LossScaleState:
    return LossScaleState(
        torch.tensor(scale, dtype=torch.float32, device=device),
        torch.tensor(0, dtype=torch.int32, device=device),
        torch.tensor(dynamic, device=device),
    )


def static_init(scale: float = 1024.0, device=None) -> LossScaleState:
    return _init(scale, False, device)


def dynamic_init(init_scale: float = 2.0**15, device=None) -> LossScaleState:
    return _init(init_scale, True, device)


def scale_loss(loss: torch.Tensor, st: LossScaleState) -> torch.Tensor:
    return loss * st.scale.to(loss.dtype)


def _tree_finite(tree) -> torch.Tensor:
    flags = [torch.isfinite(leaf.to(torch.float32)).all() for leaf in tree_leaves(tree)]
    return torch.stack(flags).all()


def unscale_and_check(grads, st: LossScaleState):
    """Unscale a gradient tree in f32, stored back in each leaf's dtype;
    returns (grads, all finite) with the flag on the device."""
    inv = (1.0 / st.scale).to(torch.float32)
    grads = tree_map(lambda g: (g.to(torch.float32) * inv).to(g.dtype), grads)
    return grads, _tree_finite(grads)


def adjust(st: LossScaleState, grads_finite: torch.Tensor, *,
           growth_interval: int = 2000) -> LossScaleState:
    """Dynamic-mode update (halve on a nonfinite step, down to 1; double
    after ``growth_interval`` finite steps, up to 2^24); identity in static
    mode."""
    grow = grads_finite & (st.growth_counter + 1 >= growth_interval)
    new_scale = torch.where(
        grads_finite,
        torch.where(grow, torch.clamp(st.scale * 2.0, max=2.0**24), st.scale),
        torch.clamp(st.scale / 2.0, min=1.0),
    )
    zero = torch.zeros_like(st.growth_counter)
    new_counter = torch.where(
        grads_finite, torch.where(grow, zero, st.growth_counter + 1), zero
    ).to(torch.int32)
    return LossScaleState(
        torch.where(st.dynamic, new_scale, st.scale),
        torch.where(st.dynamic, new_counter, st.growth_counter),
        st.dynamic,
    )
