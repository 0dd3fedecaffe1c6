"""Normalization layers, computed in f32 (norm statistics are
accumulation-sensitive; the paper quantizes matmul operands, not norm
internals).

Counterpart of ``repro.nn.norms``. A served model hands these its decoded
per-layer scale and bias (the stacked leaves are FloatSD8-packed, as the
reference packs them)."""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["RMSNorm", "LayerNorm"]


@dataclasses.dataclass(frozen=True)
class RMSNorm:
    dim: int
    eps: float = 1e-6

    def init(self, generator: torch.Generator):
        return {"scale": torch.ones((self.dim,), dtype=torch.float32, device=generator.device)}

    def apply(self, p, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * p["scale"]).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    dim: int
    eps: float = 1e-5

    def init(self, generator: torch.Generator):
        dev = generator.device
        return {"scale": torch.ones((self.dim,), dtype=torch.float32, device=dev),
                "bias": torch.zeros((self.dim,), dtype=torch.float32, device=dev)}

    def apply(self, p, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.reciprocal(torch.sqrt(var + self.eps))
        return (y * p["scale"] + p["bias"]).to(x.dtype)
