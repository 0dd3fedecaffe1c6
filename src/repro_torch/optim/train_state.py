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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .._tree import tree_leaves, tree_map
from ..core import loss_scaling as ls
from ..core.fp8 import grad_quant
from ..core.policy import Policy
from ..obs import telemetry as obs_telemetry
from .optimizers import Optimizer

__all__ = ["TrainState", "init_state", "make_train_step", "batch_to_device"]


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


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch of token ids -> int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(device) for k, v in batch.items()}


def make_train_step(loss_fn, opt: Optimizer, policy: Policy, lr: float = 1e-3,
                    grad_clip: float | None = 1.0, fused: bool | None = None,
                    telemetry: bool = False):
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
    reports no carries). All are device tensors; no host read is added."""
    if fused is None:
        fused = policy.grad_quant == "fp8"
    run_policy = (policy.replace(grad_quant="fp8_kernel")
                  if fused and policy.grad_quant == "fp8" else policy)

    def step(state: TrainState, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(), state.params)
        raw_loss = loss_fn(params, batch, run_policy)
        scaled = ls.scale_loss(raw_loss.to(torch.float32), state.scale)
        flat = iter(torch.autograd.grad(scaled, tree_leaves(params)))
        grads = tree_map(lambda _: next(flat), params)
        # the loss-scaled values the FP8 quantizer is about to see
        tel = obs_telemetry.fp8_grad_stats(grads) if telemetry else None
        if run_policy.grad_quant in ("fp8", "fp8_kernel"):
            grads = grad_quant(grads)
        grads, finite = ls.unscale_and_check(grads, state.scale)
        if telemetry:
            tel["grad_norm"] = obs_telemetry.layer_grad_norms(grads)
        if grad_clip is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                                   for g in tree_leaves(grads)))
            coef = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = tree_map(lambda g: g * coef.to(g.dtype), grads)
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
            tel.update(obs_telemetry.floatsd_update_stats(state.params, new_params))
            metrics["tel"] = tel
        return TrainState(state.step + 1, new_params, new_opt, new_scale), metrics

    return step
