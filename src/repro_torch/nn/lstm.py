"""LSTM with FloatSD8 semantics — the paper's core (Eqs. 1-6).

Counterpart of ``repro.nn.lstm``: ``LSTMCell.step``, ``LSTMLayer`` (forward
or reverse, with an optional lengths mask) and ``BiLSTM``. A layer runs one
of three paths, as the reference does:

- the fused quantized BPTT (``_LSTMBPTT``, the reference's
  ``_make_lstm_bptt``, in remat or save-z mode by ``BPTT_REMAT``) when the
  train step's policy asks for it (``grad_quant == "fp8_kernel"``). Per time step: two
  FloatSD8 x FP8 gate matmuls through the dispatched ``floatsd_matmul``
  and one fused ``lstm_cell`` (two-region sigmoid, FP8 tanh, FP16 cell
  state); a hand-written backward on ``lstm_cell_grad``, ``matmul_dx`` and
  ``matmul_dw``;
- autodiff through ``LSTMCell.step`` when a gradient is wanted under any
  other policy (the FP32 baseline, or FloatSD8 with ``fused=False``): the
  gate matmuls as einsums on the straight-through weights, the gates
  through ``qsigmoid``/``qtanh_fp8`` or the smooth functions;
- the inference scan otherwise: the same matmuls (``floatsd4_matmul`` on
  FloatSD4-packed weights) and the fused ``lstm_cell``. Packed weights
  serve only: a gradient that reaches their outputs raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.fp8 import quantize_fp8
from ..core.policy import Policy
from ..core.qsigmoid import qsigmoid, qtanh_fp8
from ..kernels import dispatch as kd
from .linear import policy_einsum, quant_act, quant_weight
from .module import uniform_init

__all__ = ["LSTMCell", "LSTMLayer", "BiLSTM", "LSTMState", "BPTT_REMAT"]

# The fused BPTT's residual mode, read at every engine call (the reference
# reads it from REPRO_BPTT_REMAT once; the port reads no environment
# variable: the training CLI's --save-z sets it to False). True (remat, the
# default): the backward recomputes all of zs as one batched GEMM pair over
# the saved h trajectory. False (save-z): the forward saves its per-step zs
# [S, B, 4H] f32 instead, S * B * 4H * 4 bytes more residuals and two
# matmul launches fewer per engine call. Every product of the engine sums in
# the ordered route, so both modes give the same gradients bit for bit.
BPTT_REMAT = True


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

    def step(self, p, x_t: torch.Tensor, state: LSTMState, policy: Policy,
             inference: bool = True):
        """One time step. ``p["wx"]``/``p["wh"]`` have passed the weight
        quantizer and x_t the activation quantizer; h is quantized here,
        since it changes every step. ``inference`` runs the gates on the
        dispatched fused cell; otherwise they are differentiable torch ops
        (the reference's non-inference branch)."""
        cdt = policy.cdt() or x_t.dtype
        hq = quant_act(state.h.to(x_t.dtype), policy)
        z = (
            policy_einsum("bd,dk->bk", x_t.to(cdt), p["wx"], policy).to(cdt)
            + policy_einsum("bd,dk->bk", hq.to(cdt), p["wh"], policy).to(cdt)
            + p["b"].to(cdt)
        )
        c_dt = policy.cell_dtype()
        if inference:
            h_t, c_t = kd.lstm_cell(z, state.c, quantized=policy.sigmoid_quant, c_dtype=c_dt)
            return h_t, LSTMState(h_t, c_t)
        zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
        if policy.sigmoid_quant:
            i_t, f_t, o_t = qsigmoid(zi), qsigmoid(zf), qsigmoid(zo)
            g_t = qtanh_fp8(zg)
        else:
            i_t, f_t, o_t = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
            g_t = torch.tanh(zg)
        # Eq. (5): FloatSD8 (f, i) x FP products, the cell state in c_dt
        c_t = (f_t * state.c.to(f_t.dtype) + i_t * g_t).to(c_dt)
        # Eq. (6)
        tc = qtanh_fp8(c_t.to(cdt)) if policy.sigmoid_quant else torch.tanh(c_t.to(cdt))
        h_t = (o_t * tc).to(cdt)
        return h_t, LSTMState(h_t, c_t)


# ---------------------------------------------------------------------------
# fused quantized BPTT: one autograd.Function over the whole time scan
# ---------------------------------------------------------------------------


def _z_of(x: torch.Tensor, hq: torch.Tensor, wqx: kd.PackedTensor, wqh: kd.PackedTensor,
          b: torch.Tensor) -> torch.Tensor:
    """Gate pre-activations x @ Wx + Q(h) @ Wh + b in f32, on the packed
    codes, both products on the matmul's ordered route: a row's sum order
    does not depend on how many rows share the call."""
    return (kd.matmul(x, wqx.codes, wqx.bias, dense=wqx.dense, ordered=True)
            + kd.matmul(hq, wqh.codes, wqh.bias, dense=wqh.dense, ordered=True) + b)


class _LSTMBPTT(torch.autograd.Function):
    """Forward scan on the dispatched matmuls and fused cell (in reverse
    time order for a ``reverse`` layer; with ``lens`` [B], lane b's carried
    state freezes once t >= lens[b], the emitted rows staying the raw cell
    outputs), saving only xs, h0, c0, b, the cell-state trajectory cs_prev
    [S, B, H], hs [S, B, H], under the mask the entry states hs_prev
    (the frozen carry is not recoverable from hs), and without ``remat``
    the per-step zs [S, B, 4H]. The codes ride on ctx.
    Backward: Q(h) of every step's entry state in one pass, all of zs
    recomputed as one GEMM pair over S*B rows (or the saved zs), one scan
    against the forward's order of ``lstm_cell_grad`` + the ``matmul_dx`` recurrence +
    FP8 gradient quantization (a frozen lane passes dh and dc through),
    then dWx and dWh as one ``matmul_dw`` each (FP8 at the kernel's flush),
    dXs as one ``matmul_dx``, and db.

    Every product sums in the matmul's ordered route (route A's order at
    any number of rows): the recomputed zs equal the forward's per-step zs
    bit for bit at every batch size, and the kernel path trains bit for bit
    as the plain path does. dWx and dWh leave on the FP8 grid and go
    straight through to the dense masters (FP8 values are exact in fp16);
    the dc chain stays f32, as in the reference."""

    @staticmethod
    def forward(ctx, xs, h0, c0, wx, wh, b, lens, wqx, wqh, quantized, c_dtype, afwd, abwd, reverse,
                remat=True):
        s = xs.shape[0]
        hs, cs_prev, hs_prev, zs = [None] * s, [None] * s, [None] * s, [None] * s
        h_prev, c_prev = h0, c0
        for t in (reversed(range(s)) if reverse else range(s)):
            z = _z_of(xs[t], quantize_fp8(h_prev, afwd), wqx, wqh, b)
            h_new, c_new = kd.lstm_cell(z, c_prev, quantized=quantized, c_dtype=c_dtype)
            h_new = h_new.to(h0.dtype)
            hs[t], cs_prev[t], hs_prev[t] = h_new, c_prev, h_prev
            if not remat:
                zs[t] = z
            if lens is None:
                h_prev, c_prev = h_new, c_new
            else:
                keep = (t < lens)[:, None]
                h_prev, c_prev = torch.where(keep, h_new, h_prev), torch.where(keep, c_new, c_prev)
        hs_t, cs_t = torch.stack(hs), torch.stack(cs_prev)
        saved = [xs, h0, c0, b, cs_t, hs_t]
        if not remat:
            saved.append(torch.stack(zs))
        if lens is not None:
            saved += [lens, torch.stack(hs_prev)]
        ctx.save_for_backward(*saved)
        ctx.packed = (wqx, wqh)
        ctx.cfg = (quantized, c_dtype, afwd, abwd, reverse, wx.dtype, wh.dtype, remat)
        return hs_t, h_prev, c_prev

    @staticmethod
    def backward(ctx, g_hs, g_ht, g_ct):
        quantized, c_dtype, afwd, abwd, reverse, wx_dtype, wh_dtype, remat = ctx.cfg
        xs, h0, c0, b, cs_prev, hs, *rest = ctx.saved_tensors
        zs, masked = (None, rest) if remat else (rest[0], rest[1:])
        wqx, wqh = ctx.packed
        f32 = torch.float32
        s, bsz, d = xs.shape
        h = hs.shape[-1]
        # step t consumed Q of its entry state: one batched fake-quant
        if masked:
            lens, prevs = masked
        elif reverse:
            lens, prevs = None, torch.cat([hs[1:], h0[None].to(hs.dtype)])
        else:
            lens, prevs = None, torch.cat([h0[None].to(hs.dtype), hs[:-1]])
        hqs = quantize_fp8(prevs, afwd)
        if zs is None:  # remat: all of zs as one GEMM pair
            zs = _z_of(xs.reshape(s * bsz, d), hqs.reshape(s * bsz, h), wqx, wqh, b)
            zs = zs.reshape(s, bsz, 4 * h)
        dh, dc = g_ht.to(f32), g_ct.to(f32)
        dzs = [None] * s
        for t in (range(s) if reverse else reversed(range(s))):
            dh_cell, dc_cell = g_hs[t].to(f32), dc
            if lens is None:
                dh_cell = dh_cell + dh
            else:  # a frozen lane's carry skips the cell
                keep = (t < lens)[:, None]
                dh_cell = dh_cell + torch.where(keep, dh, 0.0)
                dc_cell = torch.where(keep, dc, 0.0)
                dh_pass, dc_pass = torch.where(keep, 0.0, dh), torch.where(keep, 0.0, dc)
            dz, dc = kd.lstm_cell_grad(zs[t], cs_prev[t], dh_cell, dc_cell,
                                       quantized=quantized, c_dtype=c_dtype)
            dzs[t] = dz
            # cotangent of the entry h through the hq quantizer
            dh = quantize_fp8(kd.matmul_dx(dz, wqh.codes, wqh.bias, dense=wqh.dense, ordered=True), abwd)
            if lens is not None:
                dh, dc = dh_pass + dh, dc_pass + dc
        dzs_f = torch.stack(dzs).reshape(s * bsz, 4 * h)
        dwx = kd.matmul_dw(xs.reshape(s * bsz, d), dzs_f)
        dwh = kd.matmul_dw(hqs.reshape(s * bsz, h), dzs_f)
        dxs = kd.matmul_dx(dzs_f, wqx.codes, wqx.bias, dense=wqx.dense, ordered=True)
        return (dxs.reshape(s, bsz, d).to(xs.dtype), dh.to(h0.dtype), dc.to(c0.dtype),
                dwx.to(wx_dtype), dwh.to(wh_dtype), dzs_f.sum(0).to(b.dtype),
                None, None, None, None, None, None, None, None, None)


@dataclasses.dataclass(frozen=True)
class LSTMLayer:
    in_dim: int
    hidden: int
    reverse: bool = False

    def init(self, generator: torch.Generator):
        return LSTMCell(self.in_dim, self.hidden).init(generator)

    def apply(self, p, xs: torch.Tensor, policy: Policy, state: LSTMState | None = None,
              lengths: torch.Tensor | None = None):
        """xs: [B, S, in_dim] -> ([B, S, H] in time order, final state).

        A ``reverse`` layer scans from the last position to the first.
        ``lengths`` ([B] int; forward layers only): lane b's state freezes
        once t >= lengths[b]; later positions are padding (chunked prefill
        advances every lane a different number of tokens). The emitted h
        rows are the raw cell outputs, frozen lanes included, as in the
        reference.

        Training under a policy whose ``grad_quant`` is ``fp8_kernel``
        (which only the train step sets), with FloatSD8 weights, f32
        compute and dense masters (the reference's condition), runs the
        fused quantized BPTT, whose forward values equal the inference
        scan's on packed weights bit for bit. A gradient under any other
        policy runs autodiff through ``LSTMCell.step``.
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
        if lengths is not None and self.reverse:
            raise ValueError("lengths-masked scan requires a forward layer")
        xs_t = quant_act(xs, policy).transpose(0, 1)  # [S, B, D]
        packed = kd.is_any_packed(p["wx"]) or kd.is_any_packed(p["wh"])
        fused = (
            policy.grad_quant == "fp8_kernel"
            and policy.weight_quant == "floatsd8"
            and policy.cdt() in (None, torch.float32)
            and not packed
        )
        if fused:
            afwd, abwd = policy.act_dtypes("hidden")
            hs, h_f, c_f = _LSTMBPTT.apply(
                xs_t.contiguous(), state.h, state.c, p["wx"], p["wh"], p["b"].to(cdt), lengths,
                kd.hoist_train(p["wx"]), kd.hoist_train(p["wh"]),
                policy.sigmoid_quant, c_dt, afwd, abwd, self.reverse, BPTT_REMAT,
            )
            return hs.transpose(0, 1), LSTMState(h_f, c_f)
        grad = torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (xs, state.h, state.c, *p.values())
        )
        # the weight quantizer is time-invariant: once, outside the loop
        # (packed weights pass through; the plain version decodes them here)
        pq = dict(p)
        for name in ("wx", "wh"):
            pq[name] = kd.hoist_packed(quant_weight(p[name], policy))
        inference = packed or not grad
        hs = [None] * s
        for t in (reversed(range(s)) if self.reverse else range(s)):
            h_t, new = cell.step(pq, xs_t[t], state, policy, inference=inference)
            if lengths is not None:
                keep = (t < lengths)[:, None]
                new = LSTMState(torch.where(keep, new.h, state.h),
                                torch.where(keep, new.c, state.c))
            state = new
            hs[t] = h_t
        out = torch.stack(hs, dim=1)
        if packed and grad:
            out = kd.inference_only(out)
            state = LSTMState(kd.inference_only(state.h), kd.inference_only(state.c))
        return out, state


@dataclasses.dataclass(frozen=True)
class BiLSTM:
    in_dim: int
    hidden: int  # per direction

    def init(self, generator: torch.Generator):
        return {
            "fwd": LSTMLayer(self.in_dim, self.hidden).init(generator),
            "bwd": LSTMLayer(self.in_dim, self.hidden, reverse=True).init(generator),
        }

    def apply(self, p, xs: torch.Tensor, policy: Policy) -> torch.Tensor:
        """xs [B, S, in_dim] -> [B, S, 2H]: the forward layer's h beside the
        reverse layer's."""
        hf, _ = LSTMLayer(self.in_dim, self.hidden).apply(p["fwd"], xs, policy)
        hb, _ = LSTMLayer(self.in_dim, self.hidden, reverse=True).apply(p["bwd"], xs, policy)
        return torch.cat([hf, hb], dim=-1)
