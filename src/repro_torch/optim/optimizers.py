"""Optimizers over a reduced-precision master copy (paper §III-B, §IV-B).

Counterpart of ``repro.optim.optimizers`` (``sgd``; ``adam`` comes with the
other tasks). The master copy is the parameter tree, stored in the policy's
master dtype (FP16 under Table VI); updates are computed in f32 with f32
momentum, and the train step adds them to the master.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .._tree import tree_map

__all__ = ["Optimizer", "sgd"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]  # params -> state
    update: Callable[..., tuple]  # (grads, state, params, lr) -> (updates, state)


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)

    def update(grads, state, params, lr):
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, g32), state
        buf = tree_map(lambda b, g: momentum * b + g, state, g32)
        if nesterov:
            upd = tree_map(lambda b, g: -lr * (momentum * b + g), buf, g32)
        else:
            upd = tree_map(lambda b: -lr * b, buf)
        return upd, buf

    return Optimizer(init, update)
