"""TrainState and the train step: the paper's update pipeline.

Counterpart of ``repro.optim.train_state``, with its two gradient paths:

  * **fused** (``fused=None`` resolves to it when ``policy.grad_quant ==
    'fp8'``): loss * scale -> backward through the fused quantized BPTT
    (FP8 activations and activation gradients inside the model, FP8 dW
    emitted by the matmul_dw kernel) -> master gradients -> FP8
    ``grad_quant`` (an exact no-op on the kernel-emitted leaves) -> unscale
    in f32, finite check -> global-norm clip -> the optimizer in f32 -> f32
    add into the master;
  * **autodiff** (``fused=False``, or a policy that quantizes no gradient,
    such as the FP32 baseline): plain autograd through the per-step cell,
    the same tree pass doing all of the gradient quantization.

``telemetry=True`` adds the reference's quantization-health statistics
(``obs.telemetry``) to the metrics under ``"tel"``, as device tensors.

Every cast is the reference's. A nonfinite step keeps the old parameters
and optimizer state (its step count included) through ``torch.where`` on
the device, and the loss scale is adjusted there too, so nothing in the
step waits on the host.

**On a mesh** (``shardings=``, the state's ``NamedSharding`` tree from
``state_shardings``): the state is stored sharded, each rank holding its
piece of every master and moment (FSDP over "data" on the "embed" dims,
by the model's ``specs()``), and the batch is this rank's rows. A step
all-gathers the full masters (the kernels take plain tensors), runs the
loss under the mesh (this rank's share of the global loss; the LSTM
engine's ``matmul_dw`` gathers the global rows, so its FP8 snap sees the
global sum), sums the loss and every gradient over the batch ranks in one
f32 all-reduce, then runs the FP8 sweep, the unscale and finite check, the
clip norm and telemetry on the full summed gradients, the same on every
rank (so every rank skips together and the loss scale stays equal), and
the optimizer and the master add on this rank's pieces. At a world of one
rank every collective is an identity and the step equals the unsharded
one bit for bit.

With a "model" axis above one (tensor parallelism, ``distributed.sharding``)
the masters are gathered over the batch axes only (FSDP): each rank keeps
its "model" pieces, the model runs its share of the heads, the MLP and the
vocab, and a piece's gradient is summed over the batch axes only. The
finite flag is reduced over "model" (every rank skips together), the clip
norm sums the pieces' squares over "model" and counts a leaf that is whole
on every "model" rank once, and telemetry reads the gradients and masters
gathered whole.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import numpy as np
import torch

from .._tree import tree_leaves, tree_map
from ..core import loss_scaling as ls
from ..core.fp8 import grad_quant
from ..core.policy import Policy
from ..distributed import sharding as shd
from ..obs import telemetry as obs_telemetry
from .optimizers import Optimizer

__all__ = ["TrainState", "init_state", "make_train_step", "batch_to_device", "state_shardings"]


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    params: Any  # master copy, in the policy's master dtype
    opt_state: Any
    scale: ls.LossScaleState


def init_state(params, opt: Optimizer, policy: Policy, dynamic_scale: bool = False) -> TrainState:
    """Cast ``params`` to the master dtype and start the optimizer and the
    loss scale, on the parameters' device."""
    master = tree_map(lambda p: p.detach().to(policy.mdt()), params)
    dev = tree_leaves(master)[0].device
    st = ls.dynamic_init(device=dev) if dynamic_scale else ls.static_init(policy.loss_scale,
                                                                           device=dev)
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), master,
                      opt.init(master), st)


def state_shardings(param_specs, state: TrainState, mesh=None) -> TrainState:
    """The ``NamedSharding`` tree of a TrainState on ``mesh`` (default: the
    active one): the masters by the model's logical specs and their
    shapes; every optimizer-state part shaped as the parameters alike (the
    Adam moments, SGD's momentum); scalars (step, counts, loss scale)
    replicated."""
    mesh = mesh or shd.active_mesh()
    psh = shd.tree_shardings(param_specs, state.params, mesh)
    structure = _structure(state.params)

    def replicated(x):
        return shd.NamedSharding(mesh, (None,) * x.dim())

    def like_params(sub):
        if _structure(sub) == structure:
            return psh
        if hasattr(sub, "_fields"):
            return type(sub)(*(like_params(getattr(sub, f)) for f in sub._fields))
        return tree_map(replicated, sub)

    return TrainState(replicated(state.step), psh, like_params(state.opt_state),
                      tree_map(replicated, state.scale))


def _structure(tree):
    """A tree's nesting and leaf shapes (a hashable summary)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return tuple(getattr(tree, "shape", ()))


def _sum_shares(loss: torch.Tensor, grads, mesh):
    """The loss and every gradient summed over the batch ranks in one f32
    all-reduce (each leaf back in its dtype)."""
    leaves = tree_leaves(grads)
    flat = shd.all_reduce(torch.cat([loss.detach().to(torch.float32).reshape(1)]
                                    + [g.to(torch.float32).reshape(-1) for g in leaves]),
                          shd.batch_axes(mesh), mesh)
    sizes = [1] + [g.numel() for g in leaves]
    parts = iter(torch.split(flat, sizes))
    loss = next(parts)[0]
    summed = iter([p.view(g.shape).to(g.dtype) for p, g in zip(parts, leaves)])
    return loss, tree_map(lambda _: next(summed), grads)


def _model_whole(tree, psh):
    """Every leaf of ``tree`` (cut along "model" only) gathered whole."""
    return shd.gather_tree(tree, shd.model_only(psh))


def _square_sum(grads, split, mesh) -> torch.Tensor:
    """The global sum of the gradients' squares in f32: under tensor
    parallelism (``split``: per leaf, cut along "model") the pieces' sums
    reduced over "model", plus each whole leaf's once."""
    if split is None:
        return sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads))
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads)]
    cut = [s for s, c in zip(sq, tree_leaves(split)) if c]
    rest = [s for s, c in zip(sq, tree_leaves(split)) if not c]
    total = shd.all_reduce(sum(cut), ("model",), mesh) if cut else 0.0
    return total + sum(rest)


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch of token ids -> int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(device) for k, v in batch.items()}


def make_train_step(loss_fn, opt: Optimizer, policy: Policy, lr: float = 1e-3,
                    grad_clip: float | None = 1.0, fused: bool | None = None,
                    telemetry: bool = False, shardings: TrainState | None = None):
    """loss_fn(params, batch, policy) -> scalar loss. Returns
    ``step(state, batch) -> (state, metrics)``, metrics holding the raw
    loss, ``grads_finite`` and the new ``loss_scale`` as device scalars.

    ``fused=None`` resolves to ``policy.grad_quant == 'fp8'``: such a
    policy runs the fused quantized BPTT, as the reference's default does;
    ``fused=False`` trains it through autodiff instead.

    ``telemetry=True`` adds ``metrics["tel"]``: the FP8 saturation,
    underflow and zero fractions of the loss-scaled gradients at the
    ``grad_quant`` sweep point, each parameter group's gradient norm after
    unscaling (``"grad_norm"``), and the FloatSD carry and clamp fractions
    of the applied update (after the skip-select, so a skipped step
    reports no carries). All are device tensors; no host read is added.

    ``shardings`` (``state_shardings``) runs the step on their mesh, on a
    state sharded by them (module docstring); telemetry then describes the
    global step, its update statistics read from the gathered masters."""
    mesh = psh = None
    keep = ()  # the mesh axes a rank keeps its pieces along (tensor parallelism: "model")
    split = None  # per leaf: whether it is cut along "model"
    if shardings is not None:
        psh = shardings.params
        mesh = shardings.step.mesh
        if opt.name == "adafactor" and shd.batch_ranks(mesh) > 1:
            raise NotImplementedError("adafactor's factored moments span the sharded dims: "
                                      "shard its state on no mesh of more than one batch rank")
        if shd.model_size(mesh) > 1:
            keep = ("model",)
            split = tree_map(lambda s: any("model" in shd._names(ax) for ax in s.spec), psh,
                             is_leaf=lambda s: isinstance(s, shd.NamedSharding))
    if fused is None:
        fused = policy.grad_quant == "fp8"
    run_policy = (policy.replace(grad_quant="fp8_kernel")
                  if fused and policy.grad_quant == "fp8" else policy)

    def step(state: TrainState, batch):
        full = state.params if psh is None else shd.gather_tree(state.params, psh, keep)
        params = tree_map(lambda p: p.detach().requires_grad_(), full)
        with shd.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            raw_loss = loss_fn(params, batch, run_policy)
            scaled = ls.scale_loss(raw_loss.to(torch.float32), state.scale)
            flat = iter(torch.autograd.grad(scaled, tree_leaves(params), allow_unused=True))
        # a leaf the loss does not read (a vlm's patch_proj without patches) gets zeros, as from jax.grad
        grads = tree_map(lambda _: next(flat), params)
        grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g, grads, params)
        if mesh is not None:
            raw_loss, grads = _sum_shares(raw_loss, grads, mesh)
        whole = (lambda t: t) if not keep else (lambda t: _model_whole(t, psh))
        # the loss-scaled values the FP8 quantizer is about to see
        tel = obs_telemetry.fp8_grad_stats(whole(grads)) if telemetry else None
        if run_policy.grad_quant in ("fp8", "fp8_kernel"):
            grads = grad_quant(grads)
        grads, finite = ls.unscale_and_check(grads, state.scale)
        if keep:
            finite = shd.all_reduce(finite.to(torch.float32), keep, mesh, op="min") > 0
        if telemetry:
            tel["grad_norm"] = obs_telemetry.layer_grad_norms(whole(grads))
        if grad_clip is not None:
            gnorm = torch.sqrt(_square_sum(grads, split, mesh))
            coef = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = tree_map(lambda g: g * coef.to(g.dtype), grads)
        if psh is not None:
            grads = shd.shard_tree(grads, psh, keep)
        updates, new_opt = opt.update(grads, state.opt_state, state.params, lr)
        # FP16 master + update: an f32 add, stored back in the master dtype
        new_params = tree_map(lambda p, u: (p.to(torch.float32) + u.to(torch.float32)).to(p.dtype),
                              state.params, updates)
        # skip-on-nonfinite: keep the old state when the gradients overflowed
        new_params = tree_map(lambda n, o: torch.where(finite, n, o), new_params, state.params)
        new_opt = tree_map(lambda n, o: torch.where(finite, n, o), new_opt, state.opt_state)
        new_scale = ls.adjust(state.scale, finite)
        metrics = {"loss": raw_loss.detach(), "grads_finite": finite,
                   "loss_scale": new_scale.scale}
        if telemetry:
            new_full = new_params if psh is None else shd.gather_tree(new_params, psh)
            tel.update(obs_telemetry.floatsd_update_stats(whole(full), new_full))
            metrics["tel"] = tel
        return TrainState(state.step + 1, new_params, new_opt, new_scale), metrics

    return step
