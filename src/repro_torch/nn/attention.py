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

Under tensor parallelism (``distributed.sharding``: a "model" axis of m >
1) wq, wk and wv hold column pieces of their flattened [dim, heads x D]
weights and wo the matching row piece, as the specs shard them; a rank
attends with the heads its columns cover (``_TPHeads``). Where m divides
the head count those are whole heads of its own; where it does not (the
activation rules drop "act_heads" / "act_kv_heads" to replicated), the
pieces are gathered over "model" (counted collectives) and the rank takes
the whole heads that cover its columns, and of K and V the heads those
query heads read. The attention output's columns of the rank's wo rows
then go through wo, whose partial products are summed over "model". The
decode cache holds the rank's KV heads where m divides their count, else
all of them (``Block.cache_specs``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.policy import Policy
from ..distributed import sharding as shd
from ..kernels import dispatch as kd
from ..kernels.flash_attention.ref import NEG_INF, softmax_scale
from ..kernels.flash_attention.ref import flash_attention_chunked as flash_attention
from ..kernels.floatsd_matmul.ref import no_tf32
from . import rotary
from .linear import QuantDense

__all__ = ["Attention", "KVCache", "flash_attention"]


class _TPHeads(NamedTuple):
    """One rank's heads under tensor parallelism: query heads [h0, h1) of
    the model, KV heads [k0, k1); whether the q and the K/V pieces are
    gathered whole first; and the rank's columns [c0, c0 + cols) of the
    attention output (wo's rows), counted from head h0."""

    h0: int
    h1: int
    k0: int
    k1: int
    gather_q: bool
    gather_kv: bool
    c0: int
    cols: int

    @staticmethod
    def plan(heads: int, kv_heads: int, hd: int, m: int, r: int) -> "_TPHeads":
        cols = heads * hd // m
        h0, h1 = r * cols // hd, -(-(r + 1) * cols // hd)
        g = heads // kv_heads
        local = heads % m == 0 and kv_heads % m == 0
        return _TPHeads(h0, h1, h0 // g, (h1 - 1) // g + 1, heads % m != 0, not local, r * cols - h0 * hd,
                        cols)


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

    def _proj(self, out_dim: int, axis: str = "heads") -> QuantDense:
        return QuantDense(self.dim, out_dim, use_bias=self.qkv_bias, out_axis=axis)

    def _out(self) -> QuantDense:
        return QuantDense(self.heads * self.hd, self.dim, use_bias=False, in_axis="heads", out_axis="embed")

    def _tp(self) -> _TPHeads | None:
        """This rank's heads under tensor parallelism, or None off it.
        Raises where the specs leave a projection whole on a "model" axis
        above one (its flattened dim not divisible)."""
        m = shd.model_size()
        if m == 1:
            return None
        h, kh, d = self.heads, self.kv_heads, self.hd
        if shd.tp_pieces("heads", h * d) == 1 or shd.tp_pieces("kv_heads", kh * d) == 1:
            raise NotImplementedError(f"attention over {h}:{kh} heads of {d}: a 'model' axis of {m} divides "
                                      "no flattened projection")
        return _TPHeads.plan(h, kh, d, m, shd.model_rank())

    def _heads(self, y: torch.Tensor, gather: bool, lo: int, hi: int) -> torch.Tensor:
        """[B, S, n x D] (a column piece, gathered whole first if
        ``gather``) -> heads [lo, hi) of the model as [B, S, hi - lo, D];
        a piece of whole heads is already [lo, hi)."""
        b, s, _ = y.shape
        if gather:
            y = shd.gather_from_model(y, 2)
            return y.reshape(b, s, -1, self.hd)[:, :, lo:hi]
        return y.reshape(b, s, hi - lo, self.hd)

    def _kv_index(self, t: _TPHeads) -> torch.Tensor | None:
        """Where the rank's query heads do not fall into equal groups over
        its KV heads, the KV head of each query head (K and V are expanded
        to one a query head); else None."""
        nq, nk, g = t.h1 - t.h0, t.k1 - t.k0, self.groups
        idx = [(t.h0 + i) // g - t.k0 for i in range(nq)]
        if nq % nk == 0 and idx == [i // (nq // nk) for i in range(nq)]:
            return None
        return torch.tensor(idx)

    def init(self, generator: torch.Generator):
        h, kh, d = self.heads, self.kv_heads, self.hd
        return {"wq": self._proj(h * d).init(generator), "wk": self._proj(kh * d).init(generator),
                "wv": self._proj(kh * d).init(generator), "wo": self._out().init(generator)}

    def specs(self):
        def proj(axis):
            return self._proj(1, axis).specs()

        return {"wq": proj("heads"), "wk": proj("kv_heads"), "wv": proj("kv_heads"),
                "wo": {"w": ("heads", "embed")}}

    def _qkv(self, p, x: torch.Tensor, policy: Policy, positions: torch.Tensor, t: _TPHeads | None = None,
             cache_heads: bool = False):
        """q, k, v [B, S, heads, D] of x; under tensor parallelism ``t``
        the rank's query heads and the KV heads they read, or with
        ``cache_heads`` the KV heads the rank's decode cache holds."""
        b, s, _ = x.shape
        h, kh, d = self.heads, self.kv_heads, self.hd
        q = self._proj(h * d).apply(p["wq"], x, policy)
        k = self._proj(kh * d, "kv_heads").apply(p["wk"], x, policy)
        v = self._proj(kh * d, "kv_heads").apply(p["wv"], x, policy)
        if t is None:
            q, k, v = (y.reshape(b, s, n, d) for y, n in ((q, h), (k, kh), (v, kh)))
        else:
            q = self._heads(q, t.gather_q, t.h0, t.h1)
            k0, k1 = (0, kh) if cache_heads and t.gather_kv else (t.k0, t.k1)
            k, v = (self._heads(y, t.gather_kv, k0, k1) for y in (k, v))
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
        t = self._tp()
        if kv is None:
            q, k, v = self._qkv(p, x, policy, positions, t)
            causal = self.causal
        else:
            if self.rope != "none":
                raise ValueError("cross-attention takes no rotary embedding (rope='none')")
            if t is not None:
                shd.check_tp("audio")
            q = self._proj(self.heads * self.hd).apply(p["wq"], x, policy).reshape(b, s, self.heads, self.hd)
            k, v = self.kv_proj(p, kv, policy)
            causal = False
        if t is not None and (idx := self._kv_index(t)) is not None:
            k, v = k[:, :, idx.to(k.device)], v[:, :, idx.to(v.device)]
        out = kd.flash_attention(q, k, v, causal=causal, window=self.window, prefix=prefix)
        return self._out().apply(p["wo"], self._columns(out, t), policy)

    def _columns(self, out: torch.Tensor, t: _TPHeads | None) -> torch.Tensor:
        """[B, S, heads, D] -> [B, S, heads x D]; under tensor parallelism
        the rank's columns of it (wo's rows)."""
        b, s = out.shape[:2]
        out = out.reshape(b, s, -1)
        if t is not None and (t.c0 or out.shape[-1] != t.cols):
            out = out[..., t.c0:t.c0 + t.cols]
        return out

    def decode(self, p, x: torch.Tensor, cache: KVCache, policy: Policy):
        """One-token decode: x [B, 1, dim] -> (out [B, 1, dim], new cache).
        M-RoPE turns the token by t = h = w = its position."""
        b, s, _ = x.shape
        if s != 1:
            raise ValueError(f"Attention.decode takes one token a step, got {s}")
        s_max = cache.k.shape[1]
        pos = cache.pos
        rp = pos.expand(b, 1, 3) if self.rope == "mrope" else pos.expand(b, 1)
        t = self._tp()
        if t is not None and t.gather_kv and self.kv_heads % shd.model_size() == 0:
            raise NotImplementedError(f"decode over {self.heads}:{self.kv_heads} heads on a 'model' axis of "
                                      f"{shd.model_size()}: the cache's KV heads are not the ones its query heads read")
        q, k, v = self._qkv(p, x, policy, rp, t, cache_heads=True)
        slot = (pos % s_max).reshape(1).long()  # the ring buffer's slot, when windowed
        ck = cache.k.index_copy(1, slot, k.to(cache.k.dtype))
        cv = cache.v.index_copy(1, slot, v.to(cache.v.dtype))
        rk, rv = ck, cv  # the KV heads the rank's query heads read
        if t is not None:
            if t.gather_kv:
                rk, rv = ck[:, :, t.k0:t.k1], cv[:, :, t.k0:t.k1]
            if (idx := self._kv_index(t)) is not None:
                rk, rv = rk[:, :, idx.to(rk.device)], rv[:, :, idx.to(rv.device)]
        # slot i holds absolute position a iff a % s_max == i and a <= pos
        idx = torch.arange(s_max, dtype=torch.int32, device=x.device)
        abs_pos = (pos // s_max - (idx > slot).to(torch.int32)) * s_max + idx  # < 0: never written
        valid = (abs_pos >= 0) & (abs_pos <= pos)
        if self.window is not None:
            valid &= pos - abs_pos < self.window
        nk = rk.shape[2]
        qg = q.reshape(b, 1, nk, q.shape[2] // nk, self.hd).to(torch.float32)
        with no_tf32():
            sc = torch.einsum("bqkgd,bckd->bkgqc", qg * softmax_scale(self.hd), rk.to(torch.float32))
            sc = torch.where(valid, sc, NEG_INF)
            w = torch.softmax(sc, dim=-1)
            out = torch.einsum("bkgqc,bckd->bqkgd", w, rv.to(torch.float32))
        out = self._columns(out.to(x.dtype).reshape(b, 1, q.shape[2], self.hd), t)
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
