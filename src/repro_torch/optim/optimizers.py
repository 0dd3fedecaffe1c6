"""Optimizers over a reduced-precision master copy (paper §III-B, §IV-B).

Counterpart of ``repro.optim.optimizers``: ``sgd``, ``adam`` (the three
sequence tasks' optimizer) and the factored-second-moment ``adafactor``,
with the reference's arithmetic op for op. The master copy is the
parameter tree, stored in the policy's master dtype (FP16 under Table VI);
updates are computed in f32 and the train step adds them to the master.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from .._tree import tree_leaves, tree_map

__all__ = ["Optimizer", "sgd", "AdamState", "adam", "FactorState", "adafactor", "get_optimizer"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]  # params -> state
    update: Callable[..., tuple]  # (grads, state, params, lr) -> (updates, state)
    name: str = ""


def sgd(momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device), params)

    def update(grads, state, params, lr):
        g32 = tree_map(lambda g: g.to(f32), grads)
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, g32), state
        buf = tree_map(lambda b, g: momentum * b + g, state, g32)
        if nesterov:
            upd = tree_map(lambda b, g: -lr * (momentum * b + g), buf, g32)
        else:
            upd = tree_map(lambda b: -lr * b, buf)
        return upd, buf

    return Optimizer(init, update, "sgd")


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt, as XLA's. The card's f32 sqrt is (IEEE
    by nvcc's default); torch's vectorised f32 sqrt on the CPU is an ulp
    off on some inputs, so there it goes through f64, whose one rounding
    to f32 is exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(f32)
    return torch.sqrt(x)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor  # int32 scalar


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         moment_dtype=torch.float32) -> Optimizer:
    """Adam with moments stored in ``moment_dtype`` and updated, and bias
    corrected, in f32."""

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)  # noqa: E731
        return AdamState(tree_map(z, params), tree_map(z, params), _count(params))

    def update(grads, state, params, lr):
        c = state.count + 1
        bc1 = 1 - b1 ** c.to(f32)
        bc2 = 1 - b2 ** c.to(f32)

        def upd_mu(m, g):
            return (b1 * m.to(f32) + (1 - b1) * g.to(f32)).to(moment_dtype)

        def upd_nu(v, g):
            gf = g.to(f32)
            return (b2 * v.to(f32) + (1 - b2) * gf * gf).to(moment_dtype)

        mu = tree_map(upd_mu, state.mu, grads)
        nu = tree_map(upd_nu, state.nu, grads)

        def step(m, v):
            mh = m.to(f32) / bc1
            vh = v.to(f32) / bc2
            return -lr * mh / (_sqrt(vh) + eps)

        return tree_map(step, mu, nu), AdamState(mu, nu, c)

    return Optimizer(init, update, "adam")


class FactorState(NamedTuple):
    row: Any  # factored second moments (() for a vector)
    col: Any
    full: Any  # a vector's full second moment (() for a matrix)
    count: torch.Tensor  # int32 scalar


def adafactor(decay: float = 0.8, eps: float = 1e-30, clip: float = 1.0) -> Optimizer:
    """Factored second moment (Shazeer & Stern): O(n + m) optimizer state
    per n x m matrix."""

    def init(params):
        def rows(p):
            return torch.zeros(p.shape[:-1], dtype=f32, device=p.device) if p.ndim >= 2 else ()

        def cols(p):
            return torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32, device=p.device) if p.ndim >= 2 else ()

        def full(p):
            return () if p.ndim >= 2 else torch.zeros(p.shape, dtype=f32, device=p.device)

        return FactorState(tree_map(rows, params), tree_map(cols, params), tree_map(full, params),
                           _count(params))

    def update(grads, state, params, lr):
        c = state.count + 1
        beta = 1.0 - c.to(f32) ** -decay

        def one(g, r, cl, f):
            gf = g.to(f32)
            g2 = gf * gf + eps
            if g.ndim >= 2:
                r2 = beta * r + (1 - beta) * torch.mean(g2, dim=-1)
                c2 = beta * cl + (1 - beta) * torch.mean(g2, dim=-2)
                rm = torch.mean(r2, dim=-1, keepdim=True)
                v = (r2 / torch.clamp(rm, min=eps))[..., None] * c2[..., None, :]
                upd = gf / _sqrt(torch.clamp(v, min=eps))
                new = (r2, c2, f)
            else:
                f2 = beta * f + (1 - beta) * g2
                upd = gf / _sqrt(torch.clamp(f2, min=eps))
                new = (r, cl, f2)
            rms = _sqrt(torch.mean(upd * upd))
            upd = upd / torch.clamp(rms / clip, min=1.0)
            return -lr * upd, new

        # a () moment is a leaf here: flatten the moments up to the grads' leaves
        is_leaf = lambda x: isinstance(x, torch.Tensor) or x == ()  # noqa: E731
        moments = [tree_leaves(t, is_leaf=is_leaf) for t in (state.row, state.col, state.full)]
        outs = [one(g, r, cl, f) for g, r, cl, f in zip(tree_leaves(grads), *moments)]

        def unflatten(vals):
            it = iter(vals)
            return tree_map(lambda _: next(it), grads)

        upd = unflatten(o[0] for o in outs)
        row, col, full = (unflatten(o[1][i] for o in outs) for i in range(3))
        return upd, FactorState(row, col, full, c)

    return Optimizer(init, update, "adafactor")


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "adam": adam, "adafactor": adafactor}[name](**kw)
