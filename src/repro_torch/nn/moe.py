"""Mixture of experts with grouped, capacity-based sort/scatter dispatch.

Counterpart of ``repro.nn.moe``: the tokens are split into routing groups
(``_groups``, the reference's: without an active mesh g = gcd(tokens,
``dispatch_groups``); under one, the mesh's pod x data groups of the
global batch, of which each rank holds one), and each group is routed on
its own:

  * the router's logits in f32, softmax, the top-k experts (ties to the
    lower index, as ``jax.lax.top_k`` breaks them: a stable descending
    sort, where ``torch.topk`` would take the higher) and their
    renormalised gates;
  * each assignment's rank within its expert from a stable sort and
    ``searchsorted``; ranks at or past the capacity C are dropped into an
    E + 1'th bucket;
  * the tokens scattered into an [E, C, d] buffer, stored in the policy's
    FP8 activation dtype where it quantizes activations (the values are on
    that grid, so the cast is exact; the scatter writes their bytes);
  * the expert SwiGLU as three products ``gecd,edh->gech`` /
    ``gech,ehd->gecd`` (``quant_einsum``: packed codes run the matmul
    kernel once per expert, ``dispatch.packed_einsum``);
  * the combine: each slot's output scaled by its gate and added into its
    token's row by ``index_put_(accumulate=True)``, which sums a token's k
    rows in slot order (serially on the CPU, through a sort on the card),
    not by atomics, so two runs are bit-identical;
  * the Switch-style load-balancing loss E sum(mean probs x top-1 share),
    averaged over the groups (under a mesh, this rank's share of that
    mean).

The reference's gather-based combine switch (``REPRO_MOE_GATHER_COMBINE``)
is not ported. The router is not a weight site: a served tree hands it
decoded (``nn.transformer.hoist``). Trained, the dispatch's gradient is
the transpose of the reference's (``_Dispatch``); routing, the combine and
the load-balancing loss go through plain autograd, the router's gradient
from the gates and the loss.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..core.policy import Policy
from ..distributed import sharding as shd
from ..kernels.floatsd_matmul.ref import no_tf32
from .ffn import _silu
from .linear import quant_act, quant_einsum
from .module import truncated_normal_init

__all__ = ["MoE", "Route", "record_routes"]

_ROUTES: list = []  # record_routes() stack


@contextlib.contextmanager
def record_routes():
    """Collect the ``Route`` of every ``MoE.apply`` inside the block, in
    call order: the list this yields."""
    out: list = []
    _ROUTES.append(out)
    try:
        yield out
    finally:
        _ROUTES.pop()


def _dispatch(xq: torch.Tensor, slots, e: int, cap: int, k: int, bdt) -> torch.Tensor:
    """Each token's row k times into its assignments' slots of a zero [g, E,
    C, d] buffer of ``bdt`` (the drop bucket E cut off). The buffer is
    written as bytes: index_put_ on the card takes no FP8 dtype."""
    g, _, d = xq.shape
    src = xq.to(bdt).repeat_interleave(k, dim=1)  # [g, t*k, d]
    buf = torch.zeros((g, e + 1, cap, d), dtype=bdt, device=xq.device)
    bytes_of = (lambda z: z.view(torch.uint8)) if bdt.itemsize == 1 else (lambda z: z)
    bytes_of(buf).index_put_(slots, bytes_of(src))
    return buf[:, :e]


class _Dispatch(torch.autograd.Function):
    """``_dispatch`` cast to the compute dtype, with the transpose of the
    reference's cast, scatter, repeat and cast as its backward: the
    buffer's gradient rounded to ``bdt`` (the cast's transpose), each
    assignment's slot gathered (zero in the drop bucket), a token's k rows
    summed in f32 and rounded to ``bdt`` once, then cast to xq's dtype."""

    @staticmethod
    def forward(ctx, xq, slots, e, cap, k, bdt, cdt):
        ctx.slots, ctx.k, ctx.bdt, ctx.x_dtype = slots, k, bdt, xq.dtype
        return _dispatch(xq, slots, e, cap, k, bdt).to(cdt)

    @staticmethod
    def backward(ctx, g):
        gb = torch.nn.functional.pad(g.to(ctx.bdt).to(torch.float32), (0, 0, 0, 0, 0, 1))  # + the drop bucket
        rows = gb[ctx.slots]  # [g, t*k, d]
        n, tk, d = rows.shape
        dx = rows.reshape(n, tk // ctx.k, ctx.k, d).sum(2).to(ctx.bdt).to(ctx.x_dtype)
        return dx, None, None, None, None, None, None


@dataclasses.dataclass(frozen=True)
class Route:
    """One call's routing, per group: expert indices [g, t, k], gates
    [g, t, k], each assignment's expert or the drop bucket E (``slot_e``)
    and slot (``slot_c``, 0 when dropped) and ``keep`` [g, t*k]."""

    expert_idx: torch.Tensor
    gate: torch.Tensor
    slot_e: torch.Tensor
    slot_c: torch.Tensor
    keep: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoE:
    dim: int
    hidden: int  # per-expert FFN hidden width
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dispatch_groups: int = 16
    quant_silu: bool = False

    def init(self, generator: torch.Generator):
        e, d, h = self.n_experts, self.dim, self.hidden
        return {
            "router": truncated_normal_init(generator, (d, e), 0.02),
            "wi": truncated_normal_init(generator, (e, d, h)),
            "wg": truncated_normal_init(generator, (e, d, h)),
            "wo": truncated_normal_init(generator, (e, h, d), 1.0 / h**0.5),
        }

    def specs(self):
        return {
            "router": ("embed", None),
            "wi": ("expert", "embed", "expert_inner"),
            "wg": ("expert", "embed", "expert_inner"),
            "wo": ("expert", "expert_inner", "embed"),
        }

    def capacity(self, n_tokens: int) -> int:
        """Slots an expert has in a group of ``n_tokens``: capacity_factor
        x k x tokens / E rounded up to a multiple of 8, within [8, tokens
        x k]."""
        c = int(self.capacity_factor * self.top_k * n_tokens / self.n_experts)
        return max(8, min(n_tokens * self.top_k, -(-c // 8) * 8))

    def route(self, router: torch.Tensor, xg: torch.Tensor, cap: int):
        """Route the groups xg [g, t, d]: (Route, aux per group [g])."""
        g, t, _ = xg.shape
        e, k = self.n_experts, self.top_k
        with no_tf32():
            logits = torch.einsum("gtd,de->gte", xg.to(torch.float32), router.to(torch.float32))
        probs = torch.softmax(logits, dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, expert_idx = top.values[..., :k], top.indices[..., :k]
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

        # slot assignment: the rank of each assignment within its expert
        flat = expert_idx.reshape(g, t * k)
        sorted_e, order = torch.sort(flat, dim=-1, stable=True)
        experts = torch.arange(e, device=xg.device).expand(g, e).contiguous()
        seg_start = torch.searchsorted(sorted_e, experts)
        rank_sorted = torch.arange(t * k, device=xg.device) - torch.gather(seg_start, 1, sorted_e)
        rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
        keep = rank < cap
        slot_e = torch.where(keep, flat, e)
        slot_c = torch.where(keep, rank, 0)

        me = probs.mean(dim=1)  # [g, e]
        ce = torch.nn.functional.one_hot(expert_idx[..., 0], e).to(torch.float32).mean(dim=1)
        aux = e * (me * ce).sum(-1)
        return Route(expert_idx, gate, slot_e, slot_c, keep), aux

    def apply(self, p, x: torch.Tensor, policy: Policy):
        """x [B, S, d] -> ([B, S, d], the load-balancing loss)."""
        b, s, d = x.shape
        t = b * s
        g = self._groups(t)
        tg = t // g
        cap = self.capacity(tg)
        e, k = self.n_experts, self.top_k
        xf = shd.constrain(x.reshape(g, tg, d), ("batch", None, None))
        route, auxs = self.route(p["router"], xf, cap)
        for out in _ROUTES:
            out.append(route)

        dev = x.device
        gi = torch.arange(g, device=dev)[:, None].expand(g, tg * k)
        xq = quant_act(xf, policy)  # the activations entering the expert products
        bdt = policy.act_dtypes()[0] if policy.act_fwd == "fp8" else xq.dtype
        cdt = policy.cdt() or x.dtype
        slots = (gi, route.slot_e, route.slot_c)
        if torch.is_grad_enabled() and xq.requires_grad:
            be = _Dispatch.apply(xq, slots, e, cap, k, bdt, cdt)
        else:
            be = _dispatch(xq, slots, e, cap, k, bdt).to(cdt)
        hi = quant_einsum("gecd,edh->gech", be, p["wi"], policy)
        hg = quant_einsum("gecd,edh->gech", be, p["wg"], policy)
        act = _silu(hg, self.quant_silu and policy.sigmoid_quant) * hi
        out_e = shd.constrain(quant_einsum("gech,ehd->gecd", act, p["wo"], policy),
                              ("batch", "expert", None, None))
        y = self._combine(out_e, route, gi, tg)
        y = shd.constrain(y.reshape(b, s, d), ("batch", None, None))
        return y.to(x.dtype), auxs.mean() / shd.batch_ranks()

    def _groups(self, t: int) -> int:
        """Routing groups of this call's t tokens. Without an active mesh,
        gcd(t, ``dispatch_groups``). Under one, the reference routes the
        global batch's T tokens in gcd(T, P) groups, P the mesh's pod x
        data size; the batch is split over those P ranks (``t = T / P``,
        whole rows), so each rank holds gcd(T, P) / P = 1 group."""
        mesh = shd.active_mesh()
        if mesh is None:
            return math.gcd(t, self.dispatch_groups)
        n = shd.batch_ranks(mesh)
        return math.gcd(t * n, n) // n

    def _combine(self, out_e: torch.Tensor, route: Route, gi: torch.Tensor, t: int) -> torch.Tensor:
        """Scale each slot's output by its gate and add it into its token's
        row; empty slots add into a dropped row t."""
        g, e, cap, d = out_e.shape
        k = self.top_k
        dev = out_e.device
        gate = torch.where(route.keep, route.gate.reshape(g, t * k), 0.0).to(out_e.dtype)
        gbuf = torch.zeros((g, e + 1, cap), dtype=out_e.dtype, device=dev)
        gbuf.index_put_((gi, route.slot_e, route.slot_c), gate)
        scaled = out_e * gbuf[:, :e, :, None]
        tok = torch.full((g, e + 1, cap), t, dtype=torch.long, device=dev)
        tok.index_put_((gi, route.slot_e, route.slot_c), torch.arange(t * k, device=dev).expand(g, t * k) // k)
        y = torch.zeros((g, t + 1, d), dtype=out_e.dtype, device=dev)
        rows = tok[:, :e].reshape(g, e * cap)
        y.index_put_((torch.arange(g, device=dev)[:, None].expand(g, e * cap), rows),
                     scaled.reshape(g, e * cap, d), accumulate=True)
        return y[:, :t]
