"""Preallocated per-lane recurrent-state slab with masked reset.

Counterpart of ``repro.serving.state_pool``. A serving engine keeps B
decode lanes for the whole process; each lane's LSTM (h, c) lives at a fixed
batch index of one list of per-layer states. Re-arming a lane zeroes exactly
that lane's slices: ``masked_reset`` runs at the top of the engine's step.
The zoo's ``CausalLM`` keeps a group-major cache ([groups, lanes, ...] per
leaf: the RWKV state, an attention layer's KV cache of ``cache_len``
positions, a Mamba layer's state and convolution window), which
``masked_reset`` passes through, as the reference's does (the lane-major
caches of Kimi K2's leading dense layer it zeroes per lane); the engine
serves such a model in lockstep, each lane once.

Per-lane snapshots (the prefix cache's entries and the engine's preemption
stash) are kept on the host as FP8: ``to_host_fp8`` casts every leaf with
``core.fp8.cast_fp8`` (saturating) on the state's device and copies the
bytes to the host in one transfer. numpy has no FP8 dtype, so a host
snapshot is a tree of CPU ``torch.float8_e4m3fn`` tensors (their
``uint8`` views are the bytes the reference's ml_dtypes arrays hold), and
its dtypes tree holds torch dtypes.
"""
from __future__ import annotations

from typing import Any

import torch

from .._tree import tree_leaves, tree_map
from ..core import fp8

__all__ = ["StatePool", "masked_reset", "to_host_fp8"]


def to_host_fp8(states: Any, dtype=fp8.FP8_E4M3) -> tuple[Any, Any]:
    """(the tree cast to ``dtype`` on the host, the tree of the original
    leaf dtypes). Casts on the states' device, then one device-to-host copy
    of all the leaves' bytes."""
    leaves = tree_leaves(states)
    q = [fp8.cast_fp8(x, dtype).reshape(-1) for x in leaves]
    flat = torch.cat([t.view(torch.uint8) for t in q]).cpu()
    pieces = iter(torch.split(flat, [t.numel() for t in q]))
    host = tree_map(lambda x: next(pieces).view(dtype).reshape(x.shape), states)
    return host, tree_map(lambda x: x.dtype, states)


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

    def snapshot_fp8(self, lane: int, dtype=fp8.FP8_E4M3) -> tuple[Any, Any]:
        """Host FP8 copy of lane ``lane``'s state plus the leaf dtypes: the
        prefix cache's storage format (and its 2^-4 relative rounding
        bound), the engine's preemption snapshot. Restored by
        ``inject_fp8``."""
        return to_host_fp8(self.extract(lane), dtype)

    def inject_fp8(self, lane: int, snapshot: Any, dtypes: Any) -> None:
        """Widen a ``snapshot_fp8`` tree back to the pool dtypes and
        overwrite lane ``lane`` (an injected lane must not also be reset in
        the same step: the reset would zero the injection)."""
        self.inject(lane, tree_map(lambda q, dt: q.to(dt), snapshot, dtypes))

    def swap(self, new_caches: Any) -> None:
        """Install the post-step state (once per engine step)."""
        self.caches = new_caches
