"""Preallocated per-lane recurrent-state slab with masked reset.

Counterpart of ``repro.serving.state_pool``. A serving engine keeps B
decode lanes for the whole process; each lane's LSTM (h, c) lives at a fixed
batch index of one list of per-layer states. Re-arming a lane zeroes exactly
that lane's slices: ``masked_reset`` runs at the top of the engine's step.
The zoo's ``CausalLM`` keeps a layer-major cache ([layers, lanes, ...] per
leaf: the RWKV state, or the dense family's KV cache of ``cache_len``
positions), which ``masked_reset`` passes through, as the reference's
does; the engine serves such a model in lockstep, each lane once.
"""
from __future__ import annotations

from typing import Any

import torch

from .._tree import tree_leaves, tree_map

__all__ = ["StatePool", "masked_reset"]


def masked_reset(caches: Any, mask: torch.Tensor) -> Any:
    """Zero lane b of every lane-major leaf where mask[b] != 0. Leaves
    whose leading dim is not the lane count pass through."""
    lanes = mask.shape[0]

    def _z(c):
        if c.dim() == 0 or c.shape[0] != lanes:
            return c
        keep = (mask == 0).reshape((lanes,) + (1,) * (c.dim() - 1))
        return torch.where(keep, c, torch.zeros_like(c))

    return tree_map(_z, caches)


class StatePool:
    """Owns the lane-state tree and its lifecycle (allocate/reset/swap)."""

    def __init__(self, caches: Any, lanes: int):
        self.caches = caches
        self.lanes = lanes

    @classmethod
    def for_model(cls, model, lanes: int, policy, device, cache_len: int | None = None) -> "StatePool":
        """Allocate through the model's ``init_cache``: the LSTM's states
        follow the policy; an attention model's KV cache takes
        ``cache_len`` positions, as the reference's pool gives it."""
        return cls(model.init_cache(lanes, policy, device, cache_len=cache_len), lanes)

    def reset(self, mask) -> None:
        """Host-initiated masked reset (the engine folds it into its step)."""
        leaf = tree_leaves(self.caches)[0]
        self.caches = masked_reset(self.caches, torch.as_tensor(mask, device=leaf.device))

    def extract(self, lane: int) -> Any:
        """Copies of lane ``lane``'s state slices."""
        return tree_map(lambda c: c[lane].clone(), self.caches)

    def inject(self, lane: int, snapshot: Any) -> None:
        """Overwrite lane ``lane``'s slice of every leaf with ``snapshot``
        (the structure of one extracted lane), in place."""
        if not 0 <= lane < self.lanes:
            raise ValueError(f"inject: lane {lane} out of range [0, {self.lanes})")

        def _set(c, s):
            s = torch.as_tensor(s)
            if tuple(s.shape) != tuple(c.shape[1:]):
                raise ValueError(
                    f"inject: snapshot leaf shape {tuple(s.shape)} does not match "
                    f"lane state shape {tuple(c.shape[1:])} (pool leaf {tuple(c.shape)})"
                )
            c[lane] = s.to(device=c.device, dtype=c.dtype)
            return c

        tree_map(_set, self.caches, snapshot)

    def swap(self, new_caches: Any) -> None:
        """Install the post-step state (once per engine step)."""
        self.caches = new_caches
