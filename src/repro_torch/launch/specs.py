"""Input specs and sharding trees for every (arch x shape) cell.

Counterpart of ``repro.launch.specs``: ``build_cell(arch, shape, mesh, ...)``
returns the function a dry run traces, its arguments as whole (global)
tensors on the meta device (the reference's ``ShapeDtypeStruct``s:
nothing is allocated), and the ``NamedSharding`` trees of its inputs and
outputs on the mesh. ``Cell.local_args`` cuts each argument to this rank's
piece. Parameters and state come from ``init(SHAPES_ONLY)`` (the
counterpart of ``jax.eval_shape``).

The cell functions run a rank's share: the parameters arrive as pieces
(FSDP over "data", tensor parallelism over "model"); a prefill or decode
cell gathers them over "data" first (the all-gathers GSPMD would insert),
a train cell is ``make_train_step(shardings=)``, which does the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from .._tree import tree_map
from ..configs.base import SHAPES, ArchConfig, get_config
from ..core.policy import Policy, get_policy
from ..distributed import sharding as shd
from ..models import build
from ..nn.module import SHAPES_ONLY
from ..optim import adafactor, adam
from ..optim.optimizers import AdamState, FactorState, Optimizer
from ..optim.train_state import TrainState, init_state, make_train_step
from ..optim.train_state import state_shardings as _state_shardings

__all__ = ["Cell", "build_cell", "batch_specs", "param_shardings", "opt_specs", "state_shardings",
           "piece_shape"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape_name: str, policy: Policy):
    """(meta tensors, logical axis tuples) of the input batch."""
    seq, gbatch, kind = SHAPES[shape_name]
    cdt = policy.cdt() or torch.float32
    if kind in ("train", "prefill"):
        b = {"tokens": _meta((gbatch, seq), torch.int32), "labels": _meta((gbatch, seq), torch.int32)}
        s = {"tokens": ("batch", None), "labels": ("batch", None)}
        if cfg.family == "audio":
            b["frames"] = _meta((gbatch, cfg.enc_seq, cfg.d_model), cdt)
            s["frames"] = ("batch", None, None)
        if cfg.family == "vlm":
            b["patch_embeds"] = _meta((gbatch, cfg.n_patches, cfg.d_model), cdt)
            s["patch_embeds"] = ("batch", None, None)
        return b, s
    # decode: one new token against a seq_len cache
    return {"tokens": _meta((gbatch, 1), torch.int32)}, {"tokens": ("batch", None)}


def param_shardings(model, mesh, params_shape=None):
    """(the parameters' ``NamedSharding`` tree, their meta tree)."""
    if params_shape is None:
        params_shape = model.init(SHAPES_ONLY)
    return shd.tree_shardings(model.specs(), params_shape, mesh), params_shape


def opt_specs(opt_name: str, param_specs):
    """Optimizer-state logical specs mirroring the parameters' specs."""
    if opt_name == "adam":
        return AdamState(param_specs, param_specs, ())
    if opt_name == "adafactor":
        def rows(s):
            return tuple(s[:-1]) if len(s) >= 2 else ()

        def cols(s):
            return tuple(s[:-2]) + tuple(s[-1:]) if len(s) >= 2 else ()

        def full(s):
            return () if len(s) >= 2 else tuple(s)

        def t(fn):
            return tree_map(fn, param_specs, is_leaf=lambda x: type(x) is tuple)

        return FactorState(t(rows), t(cols), t(full), ())
    if opt_name == "sgd":
        return ()  # plain sgd: no state
    raise ValueError(opt_name)


def state_shardings(model, policy: Policy, mesh, opt: Optimizer):
    """(the TrainState on the meta device, its ``NamedSharding`` tree),
    nothing allocated."""
    state_shape = init_state(model.init(SHAPES_ONLY), opt, policy)
    return state_shape, _state_shardings(model.specs(), state_shape, mesh)


def piece_shape(sharding, shape) -> tuple:
    """The shape of this rank's piece of a tensor of ``shape``."""
    sizes = shd.axis_sizes(sharding.mesh)
    return tuple(d // math.prod(sizes[a] for a in shd._names(ax)) for d, ax in zip(shape, sharding.spec))


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str  # train | prefill | decode
    fn: Callable  # the rank's program
    args: tuple  # whole arguments on the meta device
    in_shardings: tuple
    out_shardings: Any
    cfg: ArchConfig
    model: Any
    policy: Policy
    mesh: Any

    def local_args(self) -> tuple:
        """Each argument's piece on this rank, uninitialised on the CPU (under
        ``FakeTensorMode``: fake tensors of the pieces' shapes)."""
        return tree_map(lambda s, x: torch.empty(piece_shape(s, x.shape), dtype=x.dtype), self.in_shardings,
                        self.args, is_leaf=lambda s: isinstance(s, shd.NamedSharding))


def _keep(mesh) -> tuple:
    return ("model",) if shd.model_size(mesh) > 1 else ()


def build_cell(arch: str, shape_name: str, mesh, policy_name: str = "floatsd8_tpu",
               cfg: ArchConfig | None = None) -> Cell:
    """The cell of ``arch`` (or ``cfg``) at ``shape_name`` on ``mesh``.
    Raises ``ValueError`` for a skipped cell and ``NotImplementedError``
    where the mesh's "model" axis is above one and the family has no
    ported tensor parallelism. The optimizer is the reference's default:
    Adafactor for the 1T model (factored moments), Adam else; the decode
    caches are bf16, as the port's models keep theirs."""
    cfg = cfg or get_config(arch)
    policy = get_policy(policy_name)
    seq, gbatch, kind = SHAPES[shape_name]
    skip = cfg.skips(shape_name)
    if skip:
        raise ValueError(f"cell ({arch},{shape_name}) skipped: {skip}")
    shd.check_tp(cfg.family, mesh)

    opt = adafactor() if cfg.n_experts >= 256 else adam()
    model = build(cfg)
    keep = _keep(mesh)

    with shd.use_mesh(mesh):
        bspec, blog = batch_specs(cfg, shape_name, policy)
        bshard = shd.tree_shardings(blog, bspec, mesh)
        logits_sh = shd.named_sharding(("batch", None, "vocab"),
                                       (gbatch, seq if kind != "decode" else 1, cfg.vocab_padded()), mesh)
        if kind == "train":
            state_shape, state_shard = state_shardings(model, policy, mesh, opt)
            step = make_train_step(model.loss, opt, policy, lr=1e-4, shardings=state_shard)
            fn = step
            args = (state_shape, bspec)
            in_sh = (state_shard, bshard)
            out_sh = (state_shard, None)
        elif kind == "prefill":
            pshard, pshape = param_shardings(model, mesh)

            def fn(params, batch):
                full = shd.gather_tree(params, pshard, keep)
                with shd.use_mesh(mesh):
                    if cfg.family == "audio":
                        enc = model.encode(full, batch["frames"], policy)
                        return model.decode_seq(full, batch["tokens"], enc, policy)
                    return model.prefill(full, batch, policy)

            args = (pshape, bspec)
            in_sh = (pshard, bshard)
            out_sh = logits_sh
        else:  # decode
            pshard, pshape = param_shardings(model, mesh)
            with torch.device("meta"):
                cache_shape = model.init_cache(gbatch, policy, "meta", cache_len=seq)
            cshard = shd.tree_shardings(model.cache_specs(), cache_shape, mesh)

            def fn(params, tokens, caches):
                full = shd.gather_tree(params, pshard, keep)
                with shd.use_mesh(mesh), torch.no_grad():
                    return model.decode_step(full, tokens, caches, policy)

            args = (pshape, bspec["tokens"], cache_shape)
            in_sh = (pshard, bshard["tokens"], cshard)
            out_sh = (logits_sh, cshard)
    if kind == "prefill":
        fn = torch.no_grad()(fn)
    return Cell(arch, shape_name, kind, fn, args, in_sh, out_sh, cfg, model, policy, mesh)

