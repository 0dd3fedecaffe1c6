"""Mamba (S6) mixer of the Jamba hybrid (arXiv:2403.19887: expand 2,
d_state 16, d_conv 4).

Counterpart of ``repro.nn.mamba``: the input projection to (x, z), a
causal depthwise convolution over x, SiLU, the selective-scan parameters
(dt through softplus, B and C) from ``x_proj`` and ``dt_proj``, the scan
h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t, y_t = h_t C_t in f32 from h_0 = 0,
the skip ``y + x d``, the SiLU gate on z and the output projection. The
four projections are ``quant_einsum`` weight sites (packed codes run the
matmul kernel); the rest runs in plain torch ops, as the reference runs
its scan in ``lax.scan``s outside any Pallas kernel. The reference chunks
the scan into scans of 256 steps, sequential across chunks, so the per-token
loop here computes the same values; trained, the loop keeps each state
out of place, so autograd goes through it (the same values).

The decode step keeps the reference's cache: the f32 state [B, d_inner,
d_state] and the last d_conv - 1 inputs of the convolution. The window is
built in the dtype the reference's concatenation promotes to, so after the
first step the convolution cache holds the inputs as computed (f32 under
an f32 compute dtype), as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.policy import Policy
from .ffn import _silu
from .linear import quant_act, quant_einsum
from .module import truncated_normal_init

__all__ = ["Mamba", "MambaCache", "softplus"]


class MambaCache(NamedTuple):
    ssm: torch.Tensor  # [B, d_inner, d_state] f32
    conv: torch.Tensor  # [B, d_conv - 1, d_inner]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``:
    max(x, 0) + log1p(exp(-|x|))), not torch's thresholded form."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


@dataclasses.dataclass(frozen=True)
class Mamba:
    dim: int
    expand: int = 2
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int | None = None
    quant_silu: bool = False

    @property
    def d_inner(self) -> int:
        return self.expand * self.dim

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, self.dim // 16)

    def init(self, generator: torch.Generator):
        di, ds, r = self.d_inner, self.d_state, self.rank
        dev = generator.device
        a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)[None].repeat(di, 1)
        return {
            "in_proj": truncated_normal_init(generator, (self.dim, 2 * di)),
            "conv_w": truncated_normal_init(generator, (self.d_conv, di), 0.5),
            "conv_b": torch.zeros((di,), dtype=torch.float32, device=dev),
            "x_proj": truncated_normal_init(generator, (di, r + 2 * ds)),
            "dt_proj": truncated_normal_init(generator, (r, di)),
            "dt_bias": torch.full((di,), -4.6, dtype=torch.float32, device=dev),  # softplus^-1(0.01)
            "a_log": torch.log(a),
            "d": torch.ones((di,), dtype=torch.float32, device=dev),
            "out_proj": truncated_normal_init(generator, (di, self.dim)),
        }

    def specs(self):
        return {
            "in_proj": ("embed", "mlp"),
            "conv_w": (None, "mlp"),
            "conv_b": ("mlp",),
            "x_proj": ("mlp", None),
            "dt_proj": (None, "mlp"),
            "dt_bias": ("mlp",),
            "a_log": ("mlp", None),
            "d": ("mlp",),
            "out_proj": ("mlp", "embed"),
        }

    def _gate(self, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        return _silu(x, self.quant_silu and policy.sigmoid_quant)

    def _pre(self, p, u: torch.Tensor, policy: Policy):
        """u [B, S, dim] -> x, z [B, S, d_inner]."""
        xz = quant_einsum("bsd,dk->bsk", u, p["in_proj"], policy)
        return xz[..., : self.d_inner], xz[..., self.d_inner:]

    def _ssm_params(self, p, x: torch.Tensor, policy: Policy):
        """x [B, S, d_inner] -> dt [B, S, d_inner], B and C [B, S, d_state], f32."""
        ds, r = self.d_state, self.rank
        proj = quant_einsum("bsd,dk->bsk", x, p["x_proj"], policy)
        dt_r, bm, cm = proj[..., :r], proj[..., r:r + ds], proj[..., r + ds:]
        dt = quant_einsum("bsr,rd->bsd", dt_r, p["dt_proj"], policy)
        dt = softplus(dt.to(torch.float32) + p["dt_bias"])
        return dt, bm.to(torch.float32), cm.to(torch.float32)

    def _scan(self, h: torch.Tensor, x, dt, bm, cm, a):
        """The selective scan from state h [B, d_inner, d_state] over S
        tokens, f32: (y [B, S, d_inner], the last state). exp(dt a) and
        dt x B are formed for all tokens at once; the loop does the
        recurrence's multiply and add, one token at a time."""
        da = torch.exp(dt[..., None] * a)  # [B, S, di, ds]
        dbx = (dt * x)[..., None] * bm[:, :, None, :]
        if torch.is_grad_enabled() and (h.requires_grad or da.requires_grad or dbx.requires_grad):  # trained
            states = []
            for t in range(x.shape[1]):
                h = h * da[:, t] + dbx[:, t]
                states.append(h)
            hs = torch.stack(states, dim=1)
        else:
            hs = torch.empty_like(da)
            for t in range(x.shape[1]):
                torch.mul(h, da[:, t], out=hs[:, t])
                hs[:, t] += dbx[:, t]
                h = hs[:, t]
        return (hs * cm[:, :, None, :]).sum(-1), h

    def apply(self, p, u: torch.Tensor, policy: Policy) -> torch.Tensor:
        """u [B, S, dim] -> [B, S, dim]."""
        b, s, _ = u.shape
        cdt = policy.cdt() or u.dtype
        x, z = self._pre(p, quant_act(u, policy), policy)
        # the causal depthwise convolution, its taps summed in order
        xp = torch.nn.functional.pad(x, (0, 0, self.d_conv - 1, 0))
        xc = 0
        for i in range(self.d_conv):
            xc = xc + xp[:, i:i + s, :] * p["conv_w"][i].to(x.dtype)
        x = self._gate(xc + p["conv_b"].to(x.dtype), policy)
        dt, bm, cm = self._ssm_params(p, x, policy)
        a = -torch.exp(p["a_log"])  # [di, ds]
        h0 = torch.zeros((b, self.d_inner, self.d_state), dtype=torch.float32, device=u.device)
        y, _ = self._scan(h0, x.to(torch.float32), dt, bm, cm, a)
        y = y + x.to(torch.float32) * p["d"]
        y = y.to(cdt) * self._gate(z, policy)
        return quant_einsum("bsd,dk->bsk", y, p["out_proj"], policy)

    def decode(self, p, u: torch.Tensor, cache: MambaCache, policy: Policy):
        """One token: u [B, 1, dim] -> ([B, 1, dim], the new cache)."""
        cdt = policy.cdt() or u.dtype
        x, z = self._pre(p, quant_act(u, policy), policy)  # [B, 1, di]
        wdt = torch.promote_types(cache.conv.dtype, x.dtype)
        window = torch.cat([cache.conv.to(wdt), x.to(wdt)], dim=1)  # [B, d_conv, di]
        w32, cw = window.to(torch.float32), p["conv_w"].to(torch.float32)
        xc = w32[:, 0] * cw[0]
        for i in range(1, self.d_conv):
            xc = xc + w32[:, i] * cw[i]
        xa = self._gate((xc + p["conv_b"]).to(x.dtype), policy)[:, None, :]
        dt, bm, cm = self._ssm_params(p, xa, policy)
        a = -torch.exp(p["a_log"])
        y, h = self._scan(cache.ssm, xa.to(torch.float32), dt, bm, cm, a)
        y = y + xa.to(torch.float32) * p["d"]
        y = y.to(cdt) * self._gate(z, policy)
        return quant_einsum("bsd,dk->bsk", y, p["out_proj"], policy), MambaCache(h, window[:, 1:])
