"""GQA attention: the full-sequence path and the KV-cache decode.

Counterpart of ``repro.nn.attention``: MHA, GQA and MQA (any KV head count
dividing the heads), causal masking or none (an encoder's), a sliding
window (SWA), cross-attention (``kv=``: Whisper's decoder), RoPE and M-RoPE
(Qwen2-VL), biased q/k/v projections.

The full-sequence path (``Attention.apply``) runs ``dispatch.flash_attention``
on the model layout, q [B, S, H, D] and k, v [B, S, Kh, D]: the
hand-written kernel on the card, and on the CPU the plain chunked online
softmax ``flash_attention`` (a port of the reference's ``_flash_fwd``,
with its chunks and its bf16 PV). The reference computes this call with
its XLA ``flash_attention`` and never calls its Pallas kernel, which
computes the same function; routing the model to the kernel is a recorded
deviation (``ROADMAP.md`` Queue 3), like the RWKV-6 prefill's wkv route.
Trained, the same call is differentiable: its forward also writes each
row's log-sum-exp and its backward is ``flash_bwd``, a port of the
reference's custom VJP (``dispatch._FlashAttention``), for self- and
cross-attention, causal, windowed and with a ``prefix`` alike.
The rotary embedding takes the positions it is given (default 0, 1, ...;
M-RoPE's are [B, S, 3] (t, h, w) ids), but the mask is by index: causal is
j <= max(i, ``prefix`` - 1), which is the reference's mask on its positions
for every caller (``CausalLM`` passes ``prefix`` = the patches it embeds, 0
without; see ``kernels/flash_attention/ref.py``). Cross-attention admits
every key. K and V are never expanded to the query heads.

The decode step (``Attention.decode``) keeps the reference's ring buffer: a
[B, S_max, Kh, D] cache (S_max = min(cache length, window)) whose slot
``pos % S_max`` takes the new key and value, the absolute position of
every slot rebuilt from ``pos``, and an f32 softmax over the valid slots,
in plain torch ops, as in the reference; M-RoPE turns the new token by t
= h = w = its position, which is what every caller of the reference's
decode passes. ``Attention.cross_decode`` is Whisper's cross-attention
step over the cached encoder keys and values.
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
    causal: bool = True
    window: int | None = None
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    qkv_bias: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.heads

    @property
    def groups(self) -> int:
        return self.heads // self.kv_heads

    def __post_init__(self):
        if self.rope not in ("rope", "mrope", "none"):
            raise ValueError(f"rope must be rope, mrope or none, got {self.rope!r}")

    def _proj(self, out_dim: int) -> QuantDense:
        return QuantDense(self.dim, out_dim, use_bias=self.qkv_bias)

    def _out(self) -> QuantDense:
        return QuantDense(self.heads * self.hd, self.dim, use_bias=False)

    def init(self, generator: torch.Generator):
        h, kh, d = self.heads, self.kv_heads, self.hd
        return {"wq": self._proj(h * d).init(generator), "wk": self._proj(kh * d).init(generator),
                "wv": self._proj(kh * d).init(generator), "wo": self._out().init(generator)}

    def specs(self):
        def proj(axis):
            return QuantDense(self.dim, 1, use_bias=self.qkv_bias, out_axis=axis).specs()

        return {"wq": proj("heads"), "wk": proj("kv_heads"), "wv": proj("kv_heads"),
                "wo": {"w": ("heads", "embed")}}

    def _qkv(self, p, x: torch.Tensor, policy: Policy, positions: torch.Tensor):
        b, s, _ = x.shape
        h, kh, d = self.heads, self.kv_heads, self.hd
        q = self._proj(h * d).apply(p["wq"], x, policy).reshape(b, s, h, d)
        k = self._proj(kh * d).apply(p["wk"], x, policy).reshape(b, s, kh, d)
        v = self._proj(kh * d).apply(p["wv"], x, policy).reshape(b, s, kh, d)
        if self.rope == "rope":
            q, k = rotary.apply_rope(q, k, positions, d, self.rope_theta)
        elif self.rope == "mrope":
            q, k = rotary.apply_mrope(q, k, positions, d, self.mrope_sections, self.rope_theta)
        return q, k, v

    def kv_proj(self, p, kv: torch.Tensor, policy: Policy):
        """Keys and values of the states ``kv`` [B, Skv, dim] through wk and
        wv (with their biases): ([B, Skv, Kh, D], [B, Skv, Kh, D])."""
        b, sk, _ = kv.shape
        kh, d = self.kv_heads, self.hd
        return (self._proj(kh * d).apply(p["wk"], kv, policy).reshape(b, sk, kh, d),
                self._proj(kh * d).apply(p["wv"], kv, policy).reshape(b, sk, kh, d))

    def apply(self, p, x: torch.Tensor, policy: Policy, positions=None, kv=None, prefix: int = 0) -> torch.Tensor:
        """Full-sequence path (forward / prefill): x [B, S, dim] -> [B, S,
        dim]. ``positions`` turn the rotary embedding ([B, S], or [B, S, 3]
        for M-RoPE; default 0, 1, ..., t = h = w); the causal mask admits j
        <= max(i, ``prefix`` - 1). With ``kv`` [B, Skv, dim] it is
        cross-attention: K and V from ``kv`` through wk and wv, every key
        admitted; the reference rotates no key there either, and no config
        puts a rotary embedding on cross-attention, so that raises."""
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
            if self.rope == "mrope":
                positions = positions[..., None].expand(b, s, 3)
        if kv is None:
            q, k, v = self._qkv(p, x, policy, positions)
            causal = self.causal
        else:
            if self.rope != "none":
                raise ValueError("cross-attention takes no rotary embedding (rope='none')")
            q = self._proj(self.heads * self.hd).apply(p["wq"], x, policy).reshape(b, s, self.heads, self.hd)
            k, v = self.kv_proj(p, kv, policy)
            causal = False
        out = kd.flash_attention(q, k, v, causal=causal, window=self.window, prefix=prefix)
        return self._out().apply(p["wo"], out.reshape(b, s, self.heads * self.hd), policy)

    def decode(self, p, x: torch.Tensor, cache: KVCache, policy: Policy):
        """One-token decode: x [B, 1, dim] -> (out [B, 1, dim], new cache).
        M-RoPE turns the token by t = h = w = its position."""
        b, s, _ = x.shape
        if s != 1:
            raise ValueError(f"Attention.decode takes one token a step, got {s}")
        s_max = cache.k.shape[1]
        pos = cache.pos
        rp = pos.expand(b, 1, 3) if self.rope == "mrope" else pos.expand(b, 1)
        q, k, v = self._qkv(p, x, policy, rp)
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

    def cross_decode(self, p, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     policy: Policy) -> torch.Tensor:
        """One-token cross-attention: x [B, 1, dim] over the cached keys and
        values [B, Skv, Kh, D] of the encoder states -> [B, 1, dim]. Every
        key is admitted; the softmax is f32 with q / sqrt(D), in plain torch
        ops, as the reference's Whisper decode writes it."""
        b = x.shape[0]
        d = self.hd
        q = self._proj(self.heads * d).apply(p["wq"], x, policy)
        q = q.reshape(b, 1, self.kv_heads, self.groups, d).to(torch.float32)
        root = torch.sqrt(torch.tensor(float(d), dtype=torch.float32, device=x.device))
        with no_tf32():
            s = torch.einsum("bqkgd,bckd->bkgqc", q / root, k_cache.to(torch.float32))
            w = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgqc,bckd->bqkgd", w, v_cache.to(torch.float32))
        return self._out().apply(p["wo"], o.reshape(b, 1, self.heads * d).to(x.dtype), policy)
