"""Parameter-init helpers of the port's modules.

Counterpart of ``repro.nn.module``'s initializers. Every module is a frozen
dataclass whose ``init(generator)`` returns a nested dict of tensors on the
generator's device. The port draws from a ``torch.Generator``, so the same
seed gives other numbers than ``jax.random``; the tests hand both packages
one set of numpy parameters instead. Stacked (scanned) parameters get a
leading layer axis (``stack_init``), as the reference's ``Stack`` has them.

``specs()`` gives a module's logical-axis tree, the reference's: the same
structure as ``init``'s, a tuple of logical names per leaf, one a dim
(``distributed.sharding`` maps them to mesh axes); ``stack_specs`` puts
the layer axis in front of every leaf.

``init(SHAPES_ONLY)`` builds every leaf on the meta device and draws
nothing: the shapes and dtypes alone, the counterpart of the reference's
``jax.eval_shape`` of ``init``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._tree import tree_map

__all__ = ["truncated_normal_init", "uniform_init", "stack_init", "stack_specs", "SHAPES_ONLY"]


class _ShapesOnly:
    """Stands in for the ``torch.Generator`` an ``init`` takes: its device
    is meta, and the initialisers below draw nothing on it."""

    device = torch.device("meta")


SHAPES_ONLY = _ShapesOnly()


def truncated_normal_init(generator: torch.Generator, shape, stddev: float | None = None) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2]; ``stddev=None`` scales by the
    fan-in, 1/sqrt(shape[0]) (1/sqrt(shape[-1]) for a vector)."""
    if stddev is None:
        stddev = 1.0 / float(np.sqrt(shape[0] if len(shape) > 1 else shape[-1]))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if t.is_meta:
        return t
    return torch.nn.init.trunc_normal_(
        t, std=stddev, a=-2.0 * stddev, b=2.0 * stddev, generator=generator
    )


def uniform_init(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """U(-scale, scale), on the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t if t.is_meta else t.uniform_(-scale, scale, generator=generator)


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


def stack_specs(specs):
    """Prepend the scan axis name ("layers") to every leaf spec."""
    return tree_map(lambda s: ("layers",) + tuple(s), specs, is_leaf=lambda s: type(s) is tuple)
