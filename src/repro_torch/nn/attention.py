"""GQA self-attention: the full-sequence path and the KV-cache decode.

Counterpart of ``repro.nn.attention`` for the dense family: MHA, GQA and
MQA (any KV head count dividing the heads), causal masking, a sliding
window (SWA), RoPE, biased q/k/v projections. Inference only.

The full-sequence path (``Attention.apply``) runs ``dispatch.flash_attention``
on the model layout, q [B, S, H, D] and k, v [B, S, Kh, D]: the
hand-written kernel on the card, and on the CPU the plain chunked online
softmax ``flash_attention`` (a port of the reference's ``_flash_fwd``,
with its chunks and its bf16 PV). The reference computes this call with
its XLA ``flash_attention`` and never calls its Pallas kernel, which
computes the same function; routing the model to the kernel is a recorded
deviation (``ROADMAP.md`` Queue 3), like the RWKV-6 prefill's wkv route.
Positions run from 0, as the reference's default positions do; K and V are
never expanded to the query heads.

The decode step (``Attention.decode``) keeps the reference's ring buffer: a
[B, S_max, Kh, D] cache (S_max = min(cache length, window)) whose slot
``pos % S_max`` takes the new key and value, the absolute position of
every slot rebuilt from ``pos``, and an f32 softmax over the valid slots,
in plain torch ops, as in the reference. Cross-attention (``kv=``, for
whisper) and M-RoPE (for qwen2-vl) come with their families.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.policy import Policy
from ..kernels import dispatch as kd
from ..kernels.flash_attention.ref import NEG_INF, softmax_scale
from ..kernels.flash_attention.ref import flash_attention_chunked as flash_attention
from ..kernels.floatsd_matmul.ref import no_tf32
from . import rotary
from .linear import QuantDense

__all__ = ["Attention", "KVCache", "flash_attention"]


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, Kh, D] (a ring buffer when windowed)
    v: torch.Tensor
    pos: torch.Tensor  # [] int32: the absolute position of the next token

    @staticmethod
    def init(batch: int, s_max: int, kv_heads: int, head_dim: int, dtype=torch.bfloat16,
             device=None) -> "KVCache":
        z = torch.zeros((batch, s_max, kv_heads, head_dim), dtype=dtype, device=device)
        return KVCache(z, z.clone(), torch.zeros((), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class Attention:
    dim: int
    heads: int
    kv_heads: int
    head_dim: int | None = None
    window: int | None = None
    rope: str = "rope"  # rope | none (mrope: not ported)
    rope_theta: float = 10000.0
    qkv_bias: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.heads

    @property
    def groups(self) -> int:
        return self.heads // self.kv_heads

    def __post_init__(self):
        if self.rope not in ("rope", "none"):
            raise NotImplementedError(
                f"rope {self.rope!r} is not ported: M-RoPE comes with qwen2-vl (ROADMAP.md Queue 1 item 8)")

    def _proj(self, out_dim: int) -> QuantDense:
        return QuantDense(self.dim, out_dim, use_bias=self.qkv_bias)

    def _out(self) -> QuantDense:
        return QuantDense(self.heads * self.hd, self.dim, use_bias=False)

    def init(self, generator: torch.Generator):
        h, kh, d = self.heads, self.kv_heads, self.hd
        return {"wq": self._proj(h * d).init(generator), "wk": self._proj(kh * d).init(generator),
                "wv": self._proj(kh * d).init(generator), "wo": self._out().init(generator)}

    def _qkv(self, p, x: torch.Tensor, policy: Policy, positions: torch.Tensor):
        b, s, _ = x.shape
        h, kh, d = self.heads, self.kv_heads, self.hd
        q = self._proj(h * d).apply(p["wq"], x, policy).reshape(b, s, h, d)
        k = self._proj(kh * d).apply(p["wk"], x, policy).reshape(b, s, kh, d)
        v = self._proj(kh * d).apply(p["wv"], x, policy).reshape(b, s, kh, d)
        if self.rope == "rope":
            q, k = rotary.apply_rope(q, k, positions, d, self.rope_theta)
        return q, k, v

    def apply(self, p, x: torch.Tensor, policy: Policy, kv=None) -> torch.Tensor:
        """Full-sequence causal self-attention (forward / prefill): x [B, S,
        dim] -> [B, S, dim]."""
        if kv is not None:
            raise NotImplementedError(
                "cross-attention is not ported: it comes with whisper (ROADMAP.md Queue 1 item 8)")
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        q, k, v = self._qkv(p, x, policy, positions)
        out = kd.flash_attention(q, k, v, window=self.window)
        return self._out().apply(p["wo"], out.reshape(b, s, self.heads * self.hd), policy)

    def decode(self, p, x: torch.Tensor, cache: KVCache, policy: Policy):
        """One-token decode: x [B, 1, dim] -> (out [B, 1, dim], new cache)."""
        b, s, _ = x.shape
        if s != 1:
            raise ValueError(f"Attention.decode takes one token a step, got {s}")
        s_max = cache.k.shape[1]
        pos = cache.pos
        q, k, v = self._qkv(p, x, policy, pos.expand(b, 1))
        slot = (pos % s_max).reshape(1).long()  # the ring buffer's slot, when windowed
        ck = cache.k.index_copy(1, slot, k.to(cache.k.dtype))
        cv = cache.v.index_copy(1, slot, v.to(cache.v.dtype))
        # slot i holds absolute position a iff a % s_max == i and a <= pos
        idx = torch.arange(s_max, dtype=torch.int32, device=x.device)
        abs_pos = (pos // s_max - (idx > slot).to(torch.int32)) * s_max + idx  # < 0: never written
        valid = (abs_pos >= 0) & (abs_pos <= pos)
        if self.window is not None:
            valid &= pos - abs_pos < self.window
        qg = q.reshape(b, 1, self.kv_heads, self.groups, self.hd).to(torch.float32)
        with no_tf32():
            sc = torch.einsum("bqkgd,bckd->bkgqc", qg * softmax_scale(self.hd), ck.to(torch.float32))
            sc = torch.where(valid, sc, NEG_INF)
            w = torch.softmax(sc, dim=-1)
            out = torch.einsum("bkgqc,bckd->bqkgd", w, cv.to(torch.float32))
        out = out.to(x.dtype).reshape(b, 1, self.heads * self.hd)
        return self._out().apply(p["wo"], out, policy), KVCache(ck, cv, pos + 1)
