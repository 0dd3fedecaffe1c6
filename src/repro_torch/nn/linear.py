"""Quantized weight sites: the embedding, the dense layer and the matmul
primitives.

Counterpart of ``repro.nn.linear``. Weights are FloatSD8 (dense fake-quant
with a straight-through gradient to the master copy, or packed codes that
pass straight to the dispatched kernel) or packed FloatSD4 codes (serving
only), activations pass the policy's
(forward, gradient) quantizers at each site, and every product accumulates
in f32. When the policy quantizes gradients, a dense weight site emits its
dW through bf16 (the reference's gradient-compression point): XLA on the
CPU computes that product in f32 and rounds once to bf16, and so does this
port.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import floatsd, floatsd4
from ..core.fp8 import act_quant
from ..core.policy import Policy
from ..kernels import dispatch as kd
from ..kernels.floatsd_matmul.ref import no_tf32
from .module import truncated_normal_init

__all__ = [
    "QuantDense", "QuantEmbedding", "quant_act", "quant_weight", "policy_einsum",
    "quant_einsum",
]


def quant_weight(w, policy: Policy):
    """The policy's weight quantizer, then a cast to the compute dtype; the
    gradient reaches the master (an fp16 one too) through the cast and the
    straight-through quantizer. Packed weights (either format) pass
    through: the codes are the quantized weights."""
    if kd.is_any_packed(w):
        return w
    if policy.weight_quant == "floatsd8":
        w = floatsd.quantize_ste(w, floatsd.fit_bias(w.detach()))
    return w.to(policy.cdt() or w.dtype)


def quant_act(x: torch.Tensor, policy: Policy, site: str = "hidden") -> torch.Tensor:
    """Activation quantization node at 'first' | 'hidden' | 'last': the
    forward value and its incoming gradient, per the policy."""
    fwd, bwd = policy.act_dtypes(site)
    if fwd is None and bwd is None:
        return x
    return act_quant(x, fwd, bwd)


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with no_tf32():
        return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


class _EinsumGC(torch.autograd.Function):
    """einsum with an explicit-transpose backward: dx keeps f32; dW is
    computed in f32 and rounded once to bf16 (the gradient-compression
    point), then returned in w's dtype."""

    @staticmethod
    def forward(ctx, eq, x, w):
        ctx.eq = eq
        ctx.save_for_backward(x, w)
        return _einsum_f32(eq, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        in1, in2 = ins.split(",")
        dx = _einsum_f32(f"{in2},{out}->{in1}", w, g).to(x.dtype)
        dw = _einsum_f32(f"{in1},{out}->{in2}", x, g).to(torch.bfloat16).to(w.dtype)
        return None, dx, dw


def policy_einsum(eq: str, x: torch.Tensor, w, policy: Policy) -> torch.Tensor:
    """The bare matmul all weight sites share: f32 accumulation, bf16 dW
    emission when the policy quantizes gradients. Operands must already be
    quantized and cast. Packed weights (either format) go to the kernel
    dispatch layer."""
    if kd.is_any_packed(w):
        return kd.packed_einsum(eq, x, w)
    if policy.grad_quant != "none":
        return _EinsumGC.apply(eq.replace(" ", ""), x, w)
    return _einsum_f32(eq, x, w)


def quant_einsum(eq: str, x: torch.Tensor, w, policy: Policy, site: str = "hidden"):
    """einsum with both operands quantized per policy; f32 accumulation."""
    xq = quant_act(x, policy, site)
    cdt = policy.cdt() or x.dtype
    if kd.is_any_packed(w):
        y = kd.packed_einsum(eq, xq.to(cdt), w)
    else:
        y = policy_einsum(eq, xq.to(cdt), quant_weight(w, policy).to(cdt), policy)
    return y.to(cdt)


@dataclasses.dataclass(frozen=True)
class QuantDense:
    """A weight site with an optional bias: x [..., in] @ w [in, out] (+ b),
    both operands quantized per policy, f32 accumulation. A packed ``w``
    runs the matmul kernel."""

    in_dim: int
    out_dim: int
    use_bias: bool = True

    def init(self, generator: torch.Generator):
        p = {"w": truncated_normal_init(generator, (self.in_dim, self.out_dim))}
        if self.use_bias:
            p["b"] = torch.zeros((self.out_dim,), dtype=torch.float32, device=generator.device)
        return p

    def apply(self, p, x: torch.Tensor, policy: Policy, site: str = "hidden") -> torch.Tensor:
        y = quant_einsum("...d,df->...f", x, p["w"], policy, site)
        if self.use_bias:
            y = y + p["b"].to(y.dtype)
        return y


class _GatherRows(torch.autograd.Function):
    """table[tokens] whose backward sums the rows of duplicate tokens with
    ``index_put_(accumulate=True)``: serially in token order on the CPU, and
    on the card through PyTorch's sort-based path, which adds each token's
    rows in a fixed order (the atomics of ``index_add_``, behind the
    backward of ``index_select`` and ``embedding``, add them in no fixed
    order). So two identical training runs give identical losses."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        d = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        d.index_put_((tokens.reshape(-1),), g.reshape(-1, ctx.shape[-1]), accumulate=True)
        return d, None


@dataclasses.dataclass(frozen=True)
class QuantEmbedding:
    vocab: int
    dim: int

    def init(self, generator: torch.Generator):
        return {"table": truncated_normal_init(generator, (self.vocab, self.dim), 0.02)}

    def apply(self, p, tokens: torch.Tensor, policy: Policy) -> torch.Tensor:
        """tokens -> embeddings (the 'first layer activation' site). A
        packed table gathers the codes (a FloatSD4 one its nibbles and
        group exponents), then decodes only those rows."""
        table = p["table"]
        if kd.is_packed4(table):
            y = floatsd4.gather_decode(table.codes, table.exps, tokens,
                                       dtype=policy.cdt() or torch.float32)
        elif kd.is_packed(table):
            y = floatsd.decode(table.codes[tokens], table.bias,
                               dtype=policy.cdt() or torch.float32)
        else:
            y = _GatherRows.apply(quant_weight(table, policy), tokens)
        return quant_act(y, policy, site="first")

    def attend(self, p, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        """Tied-weight logits head x @ table^T (the 'last layer' site)."""
        return quant_einsum("...d,vd->...v", x, p["table"], policy, site="last")
