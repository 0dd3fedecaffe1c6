"""LSTM with FloatSD8 inference semantics — the paper's core (Eqs. 1-6).

Counterpart of ``repro.nn.lstm`` (the serving half: ``LSTMCell.step`` with
``inference=True`` and ``LSTMLayer.apply``'s plain and lengths-masked
forward scans). Per time step: two FloatSD8 x FP8 gate matmuls through the
dispatched ``floatsd_matmul`` and one fused ``lstm_cell`` (two-region
sigmoid, FP8 tanh, FP16 cell state).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.policy import Policy
from ..kernels import dispatch as kd
from .linear import policy_einsum, quant_act, quant_weight, uniform_init

__all__ = ["LSTMCell", "LSTMLayer", "LSTMState"]


class LSTMState(NamedTuple):
    h: torch.Tensor  # [B, H]
    c: torch.Tensor  # [B, H]


@dataclasses.dataclass(frozen=True)
class LSTMCell:
    in_dim: int
    hidden: int

    def init(self, generator: torch.Generator):
        h = self.hidden
        scale = 1.0 / h**0.5
        b = torch.zeros((4 * h,), dtype=torch.float32, device=generator.device)
        b[h : 2 * h] = 1.0  # gate order i, f, g, o; forget bias +1
        return {
            "wx": uniform_init(generator, (self.in_dim, 4 * h), scale),
            "wh": uniform_init(generator, (h, 4 * h), scale),
            "b": b,
        }

    def step(self, p, x_t: torch.Tensor, state: LSTMState, policy: Policy):
        """One inference time step. ``p["wx"]``/``p["wh"]`` have passed the
        weight quantizer and x_t the activation quantizer; h is quantized
        here, since it changes every step."""
        cdt = policy.cdt() or x_t.dtype
        hq = quant_act(state.h.to(x_t.dtype), policy)
        z = (
            policy_einsum("bd,dk->bk", x_t.to(cdt), p["wx"]).to(cdt)
            + policy_einsum("bd,dk->bk", hq.to(cdt), p["wh"]).to(cdt)
            + p["b"].to(cdt)
        )
        h_t, c_t = kd.lstm_cell(
            z, state.c, quantized=policy.sigmoid_quant, c_dtype=policy.cell_dtype()
        )
        return h_t, LSTMState(h_t, c_t)


@dataclasses.dataclass(frozen=True)
class LSTMLayer:
    in_dim: int
    hidden: int

    def init(self, generator: torch.Generator):
        return LSTMCell(self.in_dim, self.hidden).init(generator)

    def apply(self, p, xs: torch.Tensor, policy: Policy, state: LSTMState | None = None,
              lengths: torch.Tensor | None = None):
        """xs: [B, S, in_dim] -> ([B, S, H], final state).

        ``lengths`` ([B] int): lane b's state freezes once t >= lengths[b];
        later positions are padding (chunked prefill advances every lane a
        different number of tokens). The emitted h rows are the raw cell
        outputs, frozen lanes included, as in the reference.
        """
        cell = LSTMCell(self.in_dim, self.hidden)
        b, s = xs.shape[:2]
        cdt = policy.cdt() or xs.dtype
        c_dt = policy.cell_dtype()
        if state is None:
            state = LSTMState(
                torch.zeros((b, self.hidden), dtype=cdt, device=xs.device),
                torch.zeros((b, self.hidden), dtype=c_dt, device=xs.device),
            )
        else:
            state = LSTMState(state.h.to(cdt), state.c.to(c_dt))
        xs_t = quant_act(xs, policy).transpose(0, 1)  # [S, B, D]
        # the weight quantizer is time-invariant: once, outside the loop
        # (packed weights pass through; the plain version decodes them here)
        pq = dict(p)
        for name in ("wx", "wh"):
            pq[name] = kd.hoist_packed(quant_weight(p[name], policy))
        hs = []
        for t in range(s):
            h_t, new = cell.step(pq, xs_t[t], state, policy)
            if lengths is not None:
                keep = (t < lengths)[:, None]
                new = LSTMState(torch.where(keep, new.h, state.h),
                                torch.where(keep, new.c, state.c))
            state = new
            hs.append(h_t)
        return torch.stack(hs, dim=1), state
