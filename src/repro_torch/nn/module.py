"""Parameter-init helpers of the port's modules.

Counterpart of ``repro.nn.module``'s initializers. Every module is a frozen
dataclass whose ``init(generator)`` returns a nested dict of tensors on the
generator's device. The port draws from a ``torch.Generator``, so the same
seed gives other numbers than ``jax.random``; the tests hand both packages
one set of numpy parameters instead. Stacked (scanned) parameters get a
leading layer axis (``stack_init``), as the reference's ``Stack`` has them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._tree import tree_map

__all__ = ["truncated_normal_init", "uniform_init", "stack_init"]


def truncated_normal_init(generator: torch.Generator, shape, stddev: float | None = None) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2]; ``stddev=None`` scales by the
    fan-in, 1/sqrt(shape[0]) (1/sqrt(shape[-1]) for a vector)."""
    if stddev is None:
        stddev = 1.0 / float(np.sqrt(shape[0] if len(shape) > 1 else shape[-1]))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(
        t, std=stddev, a=-2.0 * stddev, b=2.0 * stddev, generator=generator
    )


def uniform_init(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """U(-scale, scale), on the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.uniform_(-scale, scale, generator=generator)


def stack_init(layer_init: Callable, n: int) -> Callable:
    """init for ``n`` stacked copies of a layer: every leaf gets a leading
    axis of ``n``, filled one layer at a time in place (the peak is the
    stacked tree plus one layer, never two stacked trees)."""

    def init(generator: torch.Generator):
        first = layer_init(generator)
        out = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
        for i in range(n):
            layer = first if i == 0 else layer_init(generator)
            tree_map(lambda o, t: o[i].copy_(t), out, layer)
        return out

    return init
