"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mixing with
data-dependent decay, and the channel mix.

Counterpart of ``repro.nn.rwkv``, with its parameter names and its
simplifications (one learned token-shift lerp per projection, decay LoRA
rank 64). The receptance gates (``g`` of the time mix, ``r`` of the channel
mix) are the paper's two-region FloatSD8 sigmoid through
``dispatch.qsigmoid``: its kernel on the card. Inference only: no gradient
is defined through the kernels.

The wkv recurrence of a full sequence from a zero state (``state is None``,
S > 1, S % 16 == 0) runs ``dispatch.rwkv_wkv``, the hand-written chunked
kernel on the card. The reference computes that case with its XLA chunked
scan (``_wkv_chunked``); its Pallas kernel computes the same function but
no model module calls it, so routing the model to the kernel is a recorded
deviation (``ROADMAP.md`` Queue 3). Every other call runs the per-token
recurrence ``_wkv_sequential`` in plain torch ops. For S = 1 (each decode
step) and S % 16 != 0 the reference does the same; for S > 1, S % 16 == 0
from a carried state it takes its chunked scan from that state, and the
port the per-token loop, the same function (no caller passes such a
state: decode is S = 1, and a prefill starts from zero).

A served model's weight sites (``WEIGHT_SITES``) may be FloatSD8-packed:
they hand their codes to the kernel dispatch. Every other leaf is a
tensor (``nn.transformer.hoist`` decodes a served stack's once).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.policy import Policy
from ..kernels import dispatch as kd
from ..kernels.floatsd_matmul.ref import no_tf32
from ..kernels.rwkv_wkv import ops as rw_ops
from ..kernels.rwkv_wkv.ref import wkv_ref
from .linear import quant_act, quant_einsum
from .module import truncated_normal_init, uniform_init

__all__ = ["RWKV6TimeMix", "RWKV6ChannelMix", "RWKVState", "WEIGHT_SITES"]

#: the leaves both mixes hand to the matmul kernel; the rest are small
WEIGHT_SITES = frozenset({"wr", "wk", "wv", "wg", "wo"})


class RWKVState(NamedTuple):
    s: torch.Tensor  # [B, H, K, V] wkv state
    x_tm: torch.Tensor  # [B, dim] previous token (time-mix shift)
    x_cm: torch.Tensor  # [B, dim] previous token (channel-mix shift)


def _sigmoid(x: torch.Tensor, q: bool) -> torch.Tensor:
    return kd.qsigmoid(x) if q else torch.sigmoid(x)


def _shift(xq: torch.Tensor, last) -> torch.Tensor:
    """The previous token of every position: zeros (or ``last``) at 0."""
    xprev = torch.cat([torch.zeros_like(xq[:, :1]), xq[:, :-1]], dim=1)
    if last is not None:
        xprev[:, 0] = last.to(xq.dtype)
    return xprev


@dataclasses.dataclass(frozen=True)
class RWKV6TimeMix:
    dim: int
    head_dim: int = 64
    decay_rank: int = 64

    @property
    def heads(self) -> int:
        return self.dim // self.head_dim

    def init(self, generator: torch.Generator):
        d, r, h, hd = self.dim, self.decay_rank, self.heads, self.head_dim
        g, dev = generator, generator.device
        return {
            "mix": uniform_init(g, (5, d), 0.5) + 0.5,  # r, k, v, w, g lerps
            "wr": truncated_normal_init(g, (d, d)),
            "wk": truncated_normal_init(g, (d, d)),
            "wv": truncated_normal_init(g, (d, d)),
            "wg": truncated_normal_init(g, (d, d)),
            "wo": truncated_normal_init(g, (d, d)),
            "w0": torch.full((d,), -6.0, dtype=torch.float32, device=dev),  # decay base
            "w_lora_a": truncated_normal_init(g, (d, r), 0.01),
            "w_lora_b": truncated_normal_init(g, (r, d), 0.01),
            "u": torch.zeros((h, hd), dtype=torch.float32, device=dev),  # bonus
            "ln_scale": torch.ones((d,), dtype=torch.float32, device=dev),
        }

    def _proj(self, p, x, xprev, policy: Policy):
        """Token-shift lerps and the five projections; x, xprev [B, S, d]."""
        mix = p["mix"]

        def lerp(i):
            m = mix[i].to(x.dtype)
            return x * m + xprev * (1 - m)

        r = quant_einsum("bsd,dk->bsk", lerp(0), p["wr"], policy)
        k = quant_einsum("bsd,dk->bsk", lerp(1), p["wk"], policy)
        v = quant_einsum("bsd,dk->bsk", lerp(2), p["wv"], policy)
        with no_tf32():
            wl = (lerp(3).to(torch.float32) @ p["w_lora_a"]) @ p["w_lora_b"]
        w = torch.exp(-torch.exp(p["w0"] + wl))  # data-dependent decay in (0, 1)
        g = quant_einsum("bsd,dk->bsk", lerp(4), p["wg"], policy)
        return r, k, v, w, g

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, s, _ = t.shape
        return t.reshape(b, s, self.heads, self.head_dim)

    def _wkv_sequential(self, rh, kh, vh, wh, u, s0):
        """Per-token recurrence from ``s0``; rh/kh/vh/wh [B, S, H, hd]."""
        return wkv_ref(rh, kh, vh, wh, u, s0)

    def apply(self, p, x: torch.Tensor, policy: Policy, state: RWKVState | None = None):
        """x [B, S, d] -> (out [B, S, d], (final wkv state, last shifted
        token))."""
        b, s, d = x.shape
        h, hd = self.heads, self.head_dim
        cdt = policy.cdt() or x.dtype
        xq = quant_act(x, policy)
        xprev = _shift(xq, None if state is None else state.x_tm)
        r, k, v, w, g = self._proj(p, xq, xprev, policy)
        rh, kh, vh = map(self._heads, (r, k, v))
        wh = self._heads(w.to(torch.float32))
        u = p["u"]
        if state is None and s > 1 and s % rw_ops.CHUNK == 0:
            ys, s_fin = kd.rwkv_wkv(rh, kh, vh, wh, u)
        else:
            s0 = state.s if state is not None else torch.zeros(
                (b, h, hd, hd), dtype=torch.float32, device=x.device)
            ys, s_fin = self._wkv_sequential(rh, kh, vh, wh, u, s0)
        # group norm per head, then the receptance-style output gate
        yh = ys.reshape(b, s, h, hd)
        yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-6)
        y = (yh.reshape(b, s, d) * p["ln_scale"]).to(cdt)
        y = y * _sigmoid(g, policy.sigmoid_quant)
        out = quant_einsum("bsd,dk->bsk", y, p["wo"], policy)
        return out, (s_fin, xq[:, -1])


@dataclasses.dataclass(frozen=True)
class RWKV6ChannelMix:
    dim: int
    hidden: int

    def init(self, generator: torch.Generator):
        g = generator
        return {
            "mix": uniform_init(g, (2, self.dim), 0.5) + 0.5,
            "wk": truncated_normal_init(g, (self.dim, self.hidden)),
            "wv": truncated_normal_init(g, (self.hidden, self.dim)),
            "wr": truncated_normal_init(g, (self.dim, self.dim)),
        }

    def apply(self, p, x: torch.Tensor, policy: Policy, x_prev_last=None):
        """x [B, S, d] -> (out [B, S, d], last shifted token)."""
        xq = quant_act(x, policy)
        xprev = _shift(xq, x_prev_last)
        m = p["mix"].to(x.dtype)
        xk = xq * m[0] + xprev * (1 - m[0])
        xr = xq * m[1] + xprev * (1 - m[1])
        k = quant_einsum("bsd,dk->bsk", xk, p["wk"], policy)
        k = torch.square(torch.relu(k))
        kv = quant_einsum("bsh,hd->bsd", k, p["wv"], policy)
        # the paper's technique, natively: sigmoid receptance -> FloatSD8
        r = _sigmoid(quant_einsum("bsd,dk->bsk", xr, p["wr"], policy), policy.sigmoid_quant)
        return r * kv, xq[:, -1]
