"""Logical-axis -> mesh-axis mapping (MaxText-style), on a ``DeviceMesh``.

Counterpart of ``repro.distributed.sharding``, with its own copy of the
rules. Weight dims carry logical names (``nn`` modules' ``specs()``);
activations use ("batch", "seq", ...) names. The rules give FSDP over
"data" (weights' embed dim), TP/EP over "model" (heads / mlp / vocab /
experts) and pure DP over "pod" (the batch only). A logical axis drops to
replicated when the mesh lacks its mesh axis (e.g. "pod" on one pod) or
the dim is not divisible by the axes' size (e.g. granite's kv_heads=1), as
in the reference.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (NCCL on the
card, gloo on the CPU) or, where only its shape is read
(``logical_to_spec``), a device-less ``MeshShape``. A spec is a tuple with
one entry a dim: a mesh axis name, a tuple of names (one dim over several
axes, the first the most significant) or None.

Under a mesh the batch is split over its batch axes (``batch_axes``:
"pod" and "data"), and a rank's loss and gradients are its *shares*: the
shares summed over the ranks are the global ones (``batch_ranks`` is the
number of shares). The port runs no tensor parallelism yet: ``constrain``
raises where a "model" axis larger than one would shard an activation.

Every collective of the mesh path goes through ``all_gather`` /
``all_reduce`` here, which count their launches in ``COLLECTIVES``; a
group of one rank still launches (an identity), so one card runs the
launches a world of N does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
from typing import Any, Sequence

import torch
import torch.distributed as dist

from .._tree import tree_map

__all__ = [
    "LOGICAL_RULES", "MeshShape", "active_mesh", "use_mesh", "bind", "axis_sizes", "logical_to_spec",
    "logical_to_placements", "NamedSharding", "named_sharding", "tree_shardings", "constrain",
    "batch_axes", "batch_ranks", "batch_rank", "all_gather", "all_reduce", "shard_tree",
    "gather_tree", "COLLECTIVES",
]

# logical axis -> mesh axis (tuples shard one dim over several mesh axes)
LOGICAL_RULES: dict[str, Any] = {
    # --- weights ---
    "embed": "data",        # FSDP: params sharded over the data axis
    "embed2": None,
    "mlp": "model",         # TP
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "expert": "model",      # EP
    "expert_inner": None,   # per-expert hidden dim (E already on model)
    "hidden": None,         # LSTM recurrent input dim (output dim shards)
    "hidden4": "model",
    "layers": None,         # scan axis
    # --- activations ---
    "batch": ("pod", "data"),
    "seq": None,
    "seq_shard": "model",   # sequence parallelism for long-context
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "expert_cap": "data",   # MoE buffer capacity dim
}

#: launches of the mesh path's collectives, by name ("all_gather",
#: "all_reduce"); each wrapper adds one where it launches
COLLECTIVES: collections.Counter = collections.Counter()

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes with no devices (the reference's
    ``AbstractMesh``): enough for ``logical_to_spec``."""

    shape: tuple
    mesh_dim_names: tuple


def active_mesh():
    """The mesh of the innermost ``use_mesh`` on this thread, or None."""
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    """Make ``mesh`` (and ``rules`` over ``LOGICAL_RULES``) the active ones
    on this thread; a nested ``use_mesh`` without rules inherits the
    active overrides."""
    prev = getattr(_STATE, "mesh", None)
    prev_rules = getattr(_STATE, "rules", None)
    _STATE.mesh = mesh
    base = prev_rules if (rules is None and prev_rules) else LOGICAL_RULES
    _STATE.rules = {**base, **(rules or {})}
    try:
        yield mesh
    finally:
        _STATE.mesh = prev
        _STATE.rules = prev_rules


def _rules() -> dict:
    return getattr(_STATE, "rules", None) or LOGICAL_RULES


def bind(fn):
    """``fn`` run under the mesh and rules active now, on whatever thread
    calls it (autograd runs a CUDA backward, and a checkpoint's recompute,
    on its device thread, which has no mesh of its own)."""
    mesh, rules = active_mesh(), getattr(_STATE, "rules", None)
    if mesh is None:
        return fn

    def bound(*args, **kwargs):
        with use_mesh(mesh, rules):
            return fn(*args, **kwargs)

    return bound


def axis_sizes(mesh) -> dict[str, int]:
    """{mesh axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _names(ax) -> tuple:
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def logical_to_spec(logical: Sequence[str | None], shape: Sequence[int] | None = None,
                    mesh=None) -> tuple:
    """Map logical names to a spec; drop the axes the mesh lacks and any
    mapping whose axes' size does not divide the dim."""
    mesh = mesh or active_mesh()
    rules = _rules()
    sizes = axis_sizes(mesh) if mesh is not None else {}
    out = []
    for i, name in enumerate(logical):
        ax = rules.get(name) if name else None
        if ax is not None and mesh is not None:
            axes = tuple(a for a in _names(ax) if a in sizes)
            ax = axes if len(axes) > 1 else (axes[0] if axes else None)
            if ax is not None and shape is not None and shape[i] % math.prod(sizes[a] for a in _names(ax)):
                ax = None
        out.append(ax)
    return tuple(out)


def _placements(spec: tuple, mesh) -> list:
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for i, ax in enumerate(spec):
        for a in _names(ax):
            if a in dims:
                raise ValueError(f"mesh axis {a!r} shards two dims of spec {spec}")
            dims[a] = i
    return [Shard(dims[a]) if a in dims else Replicate() for a in mesh.mesh_dim_names]


def logical_to_placements(logical: Sequence[str | None], shape: Sequence[int] | None = None,
                          mesh=None) -> list:
    """The DTensor placements of ``logical_to_spec``: one ``Shard(dim)`` or
    ``Replicate()`` per mesh dim, in the mesh's order."""
    mesh = mesh or active_mesh()
    return _placements(logical_to_spec(logical, shape, mesh), mesh)


def _coordinate(mesh, axes: tuple) -> tuple[int, int]:
    """(this rank's index, the count) along ``axes`` taken together, the
    first the most significant."""
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx, math.prod(sizes[a] for a in axes)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh: how a full tensor lies across the ranks. ``shard``
    cuts this rank's piece out of the full tensor (no communication);
    ``gather`` rebuilds the full tensor from the pieces (all-gathers over
    the spec's axes)."""

    mesh: Any
    spec: tuple

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        out = full
        for dim, ax in enumerate(self.spec):
            if ax is not None:
                idx, n = _coordinate(self.mesh, _names(ax))
                size = out.shape[dim] // n
                out = out.narrow(dim, idx * size, size)
        return out.clone() if out is not full else full

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        out = local
        for dim, ax in enumerate(self.spec):
            for a in reversed(_names(ax)):  # the least significant axis first
                out = all_gather(out, dim, (a,), self.mesh)
        return out


def named_sharding(logical, shape=None, mesh=None) -> NamedSharding:
    mesh = mesh or active_mesh()
    return NamedSharding(mesh, logical_to_spec(logical, shape, mesh))


def _is_spec(s) -> bool:
    return type(s) is tuple


def tree_shardings(spec_tree, shape_tree, mesh=None):
    """specs (tuples of logical names) + shapes (tensors or shapes) ->
    ``NamedSharding`` tree."""
    mesh = mesh or active_mesh()
    return tree_map(lambda s, x: named_sharding(s, tuple(getattr(x, "shape", x)), mesh),
                    spec_tree, shape_tree, is_leaf=_is_spec)


def batch_axes(mesh=None) -> tuple:
    """The mesh axes the batch is split over (the "batch" rule's axes the
    mesh has), () without a mesh."""
    mesh = mesh or active_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in _names(_rules()["batch"]) if a in axis_sizes(mesh))


def batch_ranks(mesh=None) -> int:
    """How many ranks the batch is split over: the number of loss and
    gradient shares (1 without a mesh)."""
    mesh = mesh or active_mesh()
    return math.prod(axis_sizes(mesh)[a] for a in batch_axes(mesh)) if mesh is not None else 1


def batch_rank(mesh=None) -> int:
    """This rank's index among the batch's ``batch_ranks`` shares."""
    mesh = mesh or active_mesh()
    return _coordinate(mesh, batch_axes(mesh))[0] if mesh is not None else 0


def constrain(x: torch.Tensor, logical: Sequence[str | None]) -> torch.Tensor:
    """The reference's sharding constraint by logical names: the identity
    without a mesh. Under one, the batch is already split per rank and the
    port shards no activation over another axis, so this checks the local
    rank of ``x`` and that no axis but the batch's would split it (tensor
    parallelism over a "model" axis > 1 is not ported), and returns x."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if x.dim() != len(logical):
        raise ValueError(f"constrain: a {x.dim()}-d tensor named {tuple(logical)}")
    sizes, split = axis_sizes(mesh), set(batch_axes(mesh))
    for ax in logical_to_spec(logical, None, mesh):
        for a in _names(ax):
            if a not in split and sizes[a] > 1:
                raise NotImplementedError(
                    f"constrain: {tuple(logical)} would shard over mesh axis {a!r} of size {sizes[a]}; "
                    "the port runs tensor parallelism over no axis but the batch's")
    return x


# ---------------------------------------------------------------------------
# collectives (counted)
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, dim: int, axes: tuple, mesh=None) -> torch.Tensor:
    """The pieces of ``x`` from every rank along ``axes`` (each axis's group
    in turn, the last axis first), concatenated along ``dim`` in rank
    order."""
    mesh = mesh or active_mesh()
    for a in reversed(axes):
        group = mesh.get_group(a)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        COLLECTIVES["all_gather"] += 1
        x = torch.cat(parts, dim)
    return x


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, axes: tuple | None = None, mesh=None, op: str = "sum",
               group=None) -> torch.Tensor:
    """``x`` reduced (``op``: sum, max or min) over the ranks of ``group``,
    or of each mesh axis in ``axes`` in turn; a new tensor."""
    out = x.clone()
    groups = [group] if group is not None else [(mesh or active_mesh()).get_group(a) for a in axes]
    for g in groups:
        dist.all_reduce(out, op=_OPS[op], group=g)
        COLLECTIVES["all_reduce"] += 1
    return out


def shard_tree(tree, shardings):
    """Each leaf's piece on this rank (``NamedSharding.shard``)."""
    return tree_map(lambda s, x: s.shard(x), shardings, tree, is_leaf=lambda s: isinstance(s, NamedSharding))


def gather_tree(tree, shardings):
    """Every leaf whole on every rank (``NamedSharding.gather``)."""
    return tree_map(lambda s, x: s.gather(x), shardings, tree, is_leaf=lambda s: isinstance(s, NamedSharding))
