"""LSTM with FloatSD8 semantics — the paper's core (Eqs. 1-6).

Counterpart of ``repro.nn.lstm``: ``LSTMCell.step`` with ``inference=True``
and ``LSTMLayer.apply``'s plain and lengths-masked forward scans (the
serving half), and the fused quantized BPTT that trains a forward,
unmasked layer (``_LSTMBPTT``, the reference's ``_make_lstm_bptt`` in its
default remat mode). Per time step: two FloatSD8 x FP8 gate matmuls through
the dispatched ``floatsd_matmul`` (``floatsd4_matmul`` on FloatSD4-packed
weights, which serve only) and one fused ``lstm_cell`` (two-region
sigmoid, FP8 tanh, FP16 cell state).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.fp8 import quantize_fp8
from ..core.policy import Policy
from ..kernels import dispatch as kd
from .linear import policy_einsum, quant_act, quant_weight
from .module import uniform_init

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
            policy_einsum("bd,dk->bk", x_t.to(cdt), p["wx"], policy).to(cdt)
            + policy_einsum("bd,dk->bk", hq.to(cdt), p["wh"], policy).to(cdt)
            + p["b"].to(cdt)
        )
        h_t, c_t = kd.lstm_cell(
            z, state.c, quantized=policy.sigmoid_quant, c_dtype=policy.cell_dtype()
        )
        return h_t, LSTMState(h_t, c_t)


# ---------------------------------------------------------------------------
# fused quantized BPTT: one autograd.Function over the whole time scan
# ---------------------------------------------------------------------------


def _z_of(x: torch.Tensor, hq: torch.Tensor, wqx: kd.PackedTensor, wqh: kd.PackedTensor,
          b: torch.Tensor, ordered: bool = False) -> torch.Tensor:
    """Gate pre-activations x @ Wx + Q(h) @ Wh + b in f32, on the packed
    codes (the inference step's arithmetic, so the values agree bit for
    bit; ``ordered`` keeps that order over any number of rows)."""
    return (kd.matmul(x, wqx.codes, wqx.bias, dense=wqx.dense, ordered=ordered)
            + kd.matmul(hq, wqh.codes, wqh.bias, dense=wqh.dense, ordered=ordered) + b)


class _LSTMBPTT(torch.autograd.Function):
    """Forward scan on the dispatched matmuls and fused cell, saving only
    xs, h0, c0, b, the cell-state trajectory cs_prev [S, B, H] and hs
    [S, B, H] (the codes ride on ctx). Backward: Q(h_{t-1}) for every step
    in one pass, all of zs recomputed as one GEMM pair over S*B rows, one
    reverse scan of ``lstm_cell_grad`` + the ``matmul_dx`` recurrence +
    FP8 gradient quantization, then dWx and dWh as one ``matmul_dw`` each
    (FP8 at the kernel's flush), dXs as one ``matmul_dx``, and db. The
    batched recompute and dXs ask the matmul for its ordered route: the
    recomputed zs equal the forward's per-step zs bit for bit, and the
    kernel path trains bit for bit as the plain path does.

    dWx and dWh leave on the FP8 grid and go straight through to the dense
    masters (FP8 values are exact in fp16); the dc chain stays f32, as in
    the reference."""

    @staticmethod
    def forward(ctx, xs, h0, c0, wx, wh, b, wqx, wqh, quantized, c_dtype, afwd, abwd):
        hs, cs_prev = [], []
        h_prev, c_prev = h0, c0
        for x_t in xs:
            z = _z_of(x_t, quantize_fp8(h_prev, afwd), wqx, wqh, b)
            cs_prev.append(c_prev)
            h_new, c_prev = kd.lstm_cell(z, c_prev, quantized=quantized, c_dtype=c_dtype)
            h_prev = h_new.to(h0.dtype)
            hs.append(h_prev)
        hs_t, cs_t = torch.stack(hs), torch.stack(cs_prev)
        ctx.save_for_backward(xs, h0, c0, b, cs_t, hs_t)
        ctx.packed = (wqx, wqh)
        ctx.cfg = (quantized, c_dtype, afwd, abwd, wx.dtype, wh.dtype)
        return hs_t, h_prev, c_prev

    @staticmethod
    def backward(ctx, g_hs, g_ht, g_ct):
        xs, h0, c0, b, cs_prev, hs = ctx.saved_tensors
        wqx, wqh = ctx.packed
        quantized, c_dtype, afwd, abwd, wx_dtype, wh_dtype = ctx.cfg
        f32 = torch.float32
        s, bsz, d = xs.shape
        h = hs.shape[-1]
        # step t consumed Q(h_{t-1}), h0 at t = 0: one batched fake-quant
        hqs = quantize_fp8(torch.cat([h0[None].to(hs.dtype), hs[:-1]]), afwd)
        zs = _z_of(xs.reshape(s * bsz, d), hqs.reshape(s * bsz, h), wqx, wqh, b, ordered=True)
        zs = zs.reshape(s, bsz, 4 * h)
        dh, dc = g_ht.to(f32), g_ct.to(f32)
        dzs = [None] * s
        for t in reversed(range(s)):
            dz, dc = kd.lstm_cell_grad(zs[t], cs_prev[t], g_hs[t].to(f32) + dh, dc,
                                       quantized=quantized, c_dtype=c_dtype)
            dzs[t] = dz
            # cotangent of h_{t-1} through the hq quantizer
            dh = quantize_fp8(kd.matmul_dx(dz, wqh.codes, wqh.bias, dense=wqh.dense), abwd)
        dzs_f = torch.stack(dzs).reshape(s * bsz, 4 * h)
        dwx = kd.matmul_dw(xs.reshape(s * bsz, d), dzs_f)
        dwh = kd.matmul_dw(hqs.reshape(s * bsz, h), dzs_f)
        dxs = kd.matmul_dx(dzs_f, wqx.codes, wqx.bias, dense=wqx.dense, ordered=True)
        return (dxs.reshape(s, bsz, d).to(xs.dtype), dh.to(h0.dtype), dc.to(c0.dtype),
                dwx.to(wx_dtype), dwh.to(wh_dtype), dzs_f.sum(0).to(b.dtype),
                None, None, None, None, None, None)


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

        Training (a policy whose ``grad_quant`` is ``fp8_kernel``, which
        only the train step sets, with FloatSD8 weights, f32 compute and
        dense masters: the reference's condition) runs the fused quantized BPTT,
        whose forward values equal the inference scan's on packed weights
        bit for bit. Its lengths-masked variant and the autodiff path
        through the per-step cell are not ported and raise.
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
        fused = (
            policy.grad_quant == "fp8_kernel"
            and policy.weight_quant == "floatsd8"
            and policy.cdt() in (None, torch.float32)
            and not (kd.is_any_packed(p["wx"]) or kd.is_any_packed(p["wh"]))
        )
        if fused:
            if lengths is not None:
                raise NotImplementedError("the lengths-masked fused BPTT scan is not ported")
            afwd, abwd = policy.act_dtypes("hidden")
            hs, h_f, c_f = _LSTMBPTT.apply(
                xs_t.contiguous(), state.h, state.c, p["wx"], p["wh"], p["b"].to(cdt),
                kd.hoist_train(p["wx"]), kd.hoist_train(p["wh"]),
                policy.sigmoid_quant, c_dt, afwd, abwd,
            )
            return hs.transpose(0, 1), LSTMState(h_f, c_f)
        if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in (xs, *p.values())
        ):
            raise NotImplementedError(
                "training outside the fused BPTT (autodiff through the per-step cell) is "
                "not ported: train under a policy whose grad_quant is 'fp8_kernel'"
            )
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
