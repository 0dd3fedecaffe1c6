"""Quantized weight sites: the embedding and the matmul primitives.

Counterpart of ``repro.nn.linear`` (inference half). Weights are FloatSD8
(dense fake-quant, or packed codes that pass straight to the dispatched
kernel), activations are quantized to the policy's forward dtype at each
site, and every product accumulates in f32.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import floatsd
from ..core.fp8 import quantize_fp8
from ..core.policy import Policy
from ..kernels import dispatch as kd
from ..kernels.floatsd_matmul.ref import no_tf32

__all__ = [
    "QuantEmbedding", "quant_act", "quant_weight", "policy_einsum",
    "quant_einsum", "truncated_normal_init", "uniform_init",
]


def truncated_normal_init(generator: torch.Generator, shape, stddev: float) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2], on the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(
        t, std=stddev, a=-2.0 * stddev, b=2.0 * stddev, generator=generator
    )


def uniform_init(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """U(-scale, scale), on the generator's device."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.uniform_(-scale, scale, generator=generator)


def quant_weight(w, policy: Policy):
    """The policy's weight quantizer. Packed weights pass through: the codes
    are the quantized weights."""
    if kd.is_packed(w):
        return w
    if policy.weight_quant == "floatsd8":
        w, _ = floatsd.quantize(w)
    return w.to(policy.cdt() or w.dtype)


def quant_act(x: torch.Tensor, policy: Policy, site: str = "hidden") -> torch.Tensor:
    """Forward activation fake-quant at 'first' | 'hidden' | 'last'."""
    fwd, _ = policy.act_dtypes(site)
    return quantize_fp8(x, fwd)


def policy_einsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """The bare matmul all weight sites share, f32 accumulation. Packed
    weights go to the kernel dispatch layer."""
    if kd.is_packed(w):
        return kd.packed_einsum(eq, x, w)
    with no_tf32():
        return torch.einsum(eq, x.to(torch.float32), w.to(torch.float32))


def quant_einsum(eq: str, x: torch.Tensor, w, policy: Policy, site: str = "hidden"):
    """einsum with both operands quantized per policy; f32 accumulation."""
    xq = quant_act(x, policy, site)
    cdt = policy.cdt() or x.dtype
    if kd.is_packed(w):
        y = kd.packed_einsum(eq, xq.to(cdt), w)
    else:
        y = policy_einsum(eq, xq.to(cdt), quant_weight(w, policy).to(cdt))
    return y.to(cdt)


@dataclasses.dataclass(frozen=True)
class QuantEmbedding:
    vocab: int
    dim: int

    def init(self, generator: torch.Generator):
        return {"table": truncated_normal_init(generator, (self.vocab, self.dim), 0.02)}

    def apply(self, p, tokens: torch.Tensor, policy: Policy) -> torch.Tensor:
        """tokens -> embeddings (the 'first layer activation' site). A
        packed table gathers the 1-byte codes, then decodes only those rows."""
        table = p["table"]
        if kd.is_packed(table):
            y = floatsd.decode(table.codes[tokens], table.bias,
                               dtype=policy.cdt() or torch.float32)
        else:
            y = quant_weight(table, policy)[tokens]
        return quant_act(y, policy, site="first")

    def attend(self, p, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        """Tied-weight logits head x @ table^T (the 'last layer' site)."""
        return quant_einsum("...d,vd->...v", x, p["table"], policy, site="last")
