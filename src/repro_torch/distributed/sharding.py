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
number of shares).

Tensor parallelism (TP) over a "model" axis larger than one runs for the
families in ``TP_FAMILIES`` (the dense family): a weight whose output dim
the rules put on "model" is a column piece, one whose input dim they put
there a row piece (``tp_pieces``), and each rank runs its share of the
heads, the MLP and the vocab. The model enters ``tp_scope(family)``;
``constrain`` and ``check_tp`` raise ``NotImplementedError`` naming any
other family. The autograd-aware collectives of that path
(``copy_to_model``: identity forward, the gradient summed over "model";
``reduce_from_model``: the sum forward, identity backward;
``gather_from_model``: the pieces concatenated forward, the gradient summed
and cut back to the piece backward) are Megatron-LM's f and g operators.

Every collective of the mesh path goes through ``all_gather`` /
``all_reduce`` here, which count their launches in ``COLLECTIVES``; inside
a ``collective_log()`` block each launch is also logged as a ``Launch``:
its mesh axis, its wire bytes under the reference's ring factors
(``repro.launch.hlo_analysis``: an all-reduce moves 2 (n - 1) / n of its
bytes, an all-gather (n - 1) / n of its output's), its operand and result
bytes. A group of one rank still launches (an identity, 0 wire bytes), so
one card runs the launches a world of N does.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import threading
from typing import Any, NamedTuple, Sequence

import torch
import torch.distributed as dist

from .._tree import tree_map

__all__ = [
    "LOGICAL_RULES", "MeshShape", "active_mesh", "use_mesh", "bind", "axis_sizes", "logical_to_spec",
    "logical_to_placements", "NamedSharding", "named_sharding", "tree_shardings", "constrain",
    "batch_axes", "batch_ranks", "batch_rank", "all_gather", "all_reduce", "shard_tree",
    "gather_tree", "COLLECTIVES", "Launch", "collective_log", "TP_FAMILIES", "tp_scope", "check_tp",
    "model_size", "model_rank", "tp_pieces", "copy_to_model", "reduce_from_model", "gather_from_model",
    "model_only",
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


class Launch(NamedTuple):
    """One collective launch: its name, its mesh axis ("group" for an
    explicit group), its wire bytes under the ring factors, its operand
    and result bytes."""

    name: str
    axis: str
    wire: float
    nin: int
    nout: int


_LOGS: list[list] = []  # the lists of the open collective_log() blocks

#: the families whose tensor parallelism over "model" is ported
TP_FAMILIES = ("dense",)

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
    """``fn`` run under the mesh, rules and ``tp_scope`` active now, on
    whatever thread calls it (autograd runs a CUDA backward, and a checkpoint's recompute,
    on its device thread, which has no mesh of its own)."""
    mesh, rules, family = active_mesh(), getattr(_STATE, "rules", None), getattr(_STATE, "family", None)
    if mesh is None:
        return fn

    def bound(*args, **kwargs):
        with use_mesh(mesh, rules), tp_scope(family):
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


def model_size(mesh=None) -> int:
    """The "model" axis's size on ``mesh`` (default: the active one), 1
    without a mesh or without that axis."""
    mesh = mesh or active_mesh()
    return axis_sizes(mesh).get("model", 1) if mesh is not None else 1


def model_rank(mesh=None) -> int:
    """This rank's index along "model" (0 off tensor parallelism)."""
    mesh = mesh or active_mesh()
    return mesh.get_local_rank("model") if model_size(mesh) > 1 else 0


def tp_pieces(logical: str | None, dim: int, mesh=None) -> int:
    """How many "model" pieces a dim of size ``dim`` named ``logical`` is
    cut into: the "model" axis's size where the rules put the name on it
    and that size divides the dim, else 1."""
    mesh = mesh or active_mesh()
    if model_size(mesh) == 1:
        return 1
    return model_size(mesh) if "model" in _names(logical_to_spec((logical,), (dim,), mesh)[0]) else 1


@contextlib.contextmanager
def tp_scope(family: str):
    """Run the block as a model of ``family``: ``constrain`` and
    ``check_tp`` read it."""
    prev = getattr(_STATE, "family", None)
    _STATE.family = family
    try:
        yield
    finally:
        _STATE.family = prev


def check_tp(family: str | None = None, mesh=None) -> None:
    """Raise ``NotImplementedError`` where the mesh's "model" axis is above
    one and ``family`` (default: the innermost ``tp_scope``'s) has no
    ported tensor parallelism."""
    family = family or getattr(_STATE, "family", None)
    n = model_size(mesh)
    if n > 1 and family not in TP_FAMILIES:
        raise NotImplementedError(
            f"tensor parallelism over a 'model' axis of {n} is not ported for the {family or 'unnamed'} family "
            f"(ported: {', '.join(TP_FAMILIES)})")


def constrain(x: torch.Tensor, logical: Sequence[str | None]) -> torch.Tensor:
    """The reference's sharding constraint by logical names: the identity
    without a mesh. Under one, the batch is already split per rank and a
    "model" axis above one holds this rank's share (tensor parallelism of a
    family in ``TP_FAMILIES``), so this checks the local rank of ``x`` and
    that no axis but the batch's and "model" would split it, raises
    (``check_tp``) where "model" would and the model's family has no
    ported tensor parallelism, and returns x."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if x.dim() != len(logical):
        raise ValueError(f"constrain: a {x.dim()}-d tensor named {tuple(logical)}")
    sizes, split = axis_sizes(mesh), set(batch_axes(mesh))
    for ax in logical_to_spec(logical, None, mesh):
        for a in _names(ax):
            if a in split or sizes[a] == 1:
                continue
            if a != "model":
                raise NotImplementedError(
                    f"constrain: {tuple(logical)} would shard over mesh axis {a!r} of size {sizes[a]}")
            check_tp(mesh=mesh)
    return x


# ---------------------------------------------------------------------------
# collectives (counted)
# ---------------------------------------------------------------------------


def _note(name: str, axis: str, wire: float, nin: int, nout: int) -> None:
    COLLECTIVES[name] += 1
    for log in _LOGS:
        log.append(Launch(name, axis, wire, nin, nout))


@contextlib.contextmanager
def collective_log():
    """Yields a list that gets a ``Launch`` for each collective launched
    inside the block (``launch.step_analysis`` sums a trace's)."""
    log: list[Launch] = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def all_gather(x: torch.Tensor, dim: int, axes: tuple, mesh=None) -> torch.Tensor:
    """The pieces of ``x`` from every rank along ``axes`` (each axis's group
    in turn, the last axis first), concatenated along ``dim`` in rank
    order."""
    mesh = mesh or active_mesh()
    for a in reversed(axes):
        group = mesh.get_group(a)
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        _note("all_gather", a, (n - 1) * x.nbytes, x.nbytes, n * x.nbytes)
        x = torch.cat(parts, dim)
    return x


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, axes: tuple | None = None, mesh=None, op: str = "sum",
               group=None) -> torch.Tensor:
    """``x`` reduced (``op``: sum, max or min) over the ranks of ``group``,
    or of each mesh axis in ``axes`` in turn; a new tensor."""
    out = x.clone()
    groups = ([("group", group)] if group is not None
              else [(a, (mesh or active_mesh()).get_group(a)) for a in axes])
    for a, g in groups:
        dist.all_reduce(out, op=_OPS[op], group=g)
        n = dist.get_world_size(g)
        _note("all_reduce", a, 2.0 * (n - 1) / n * out.nbytes, out.nbytes, out.nbytes)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ("model",), ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, ("model",), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.size = dim, mesh, x.shape[dim]
        return all_gather(x, dim, ("model",), mesh)

    @staticmethod
    def backward(ctx, g):
        full = all_reduce(g, ("model",), ctx.mesh)
        return full.narrow(ctx.dim, model_rank(ctx.mesh) * ctx.size, ctx.size).contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over "model" (a column-parallel
    site's input: each rank's dx is a partial sum)."""
    return _CopyToModel.apply(x, mesh or active_mesh())


def reduce_from_model(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` summed over "model" (a row-parallel site's partial products);
    the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, mesh or active_mesh())


def gather_from_model(x: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """The "model" pieces of ``x`` concatenated along ``dim``; the gradient
    summed over "model" (an all-reduce) and cut back to this rank's piece."""
    return _GatherFromModel.apply(x, dim, mesh or active_mesh())


def _without(sh: NamedSharding, keep: tuple) -> NamedSharding:
    """``sh`` with the mesh axes in ``keep`` taken out of its spec."""
    if not keep:
        return sh

    def drop(ax):
        names = tuple(a for a in _names(ax) if a not in keep)
        return names if len(names) > 1 else (names[0] if names else None)

    return NamedSharding(sh.mesh, tuple(drop(ax) for ax in sh.spec))


def model_only(shardings):
    """The ``NamedSharding`` tree with every mesh axis but "model" taken out
    of its specs: a leaf's pieces under tensor parallelism alone."""
    return tree_map(lambda s: _without(s, tuple(a for a in axis_sizes(s.mesh) if a != "model")),
                    shardings, is_leaf=lambda s: isinstance(s, NamedSharding))


def shard_tree(tree, shardings, keep: tuple = ()):
    """Each leaf's piece on this rank (``NamedSharding.shard``); a leaf is
    already cut along the mesh axes in ``keep``."""
    return tree_map(lambda s, x: _without(s, keep).shard(x), shardings, tree,
                    is_leaf=lambda s: isinstance(s, NamedSharding))


def gather_tree(tree, shardings, keep: tuple = ()):
    """Every leaf whole on every rank (``NamedSharding.gather``), but for
    its pieces along the mesh axes in ``keep``."""
    return tree_map(lambda s, x: _without(s, keep).gather(x), shardings, tree,
                    is_leaf=lambda s: isinstance(s, NamedSharding))
