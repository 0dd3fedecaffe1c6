"""Feed-forward blocks.

Counterpart of ``repro.nn.ffn``: SwiGLU, GELU and GeGLU over three (or
two) ``QuantDense`` weight sites. GELU is the tanh approximation, as
``jax.nn.gelu`` computes it by default. With ``quant_silu`` and a policy
whose ``sigmoid_quant`` is set, SwiGLU's sigmoid is the paper's two-region
FloatSD8 sigmoid through ``dispatch.qsigmoid`` (its kernel on the card);
the dense ``CausalLM`` leaves it off, as the reference does. Under tensor
parallelism wi and wg are column pieces and wo a row piece
(``QuantDense.tp``): the gate and the GELU run on the rank's columns of
the hidden layer."""
from __future__ import annotations

import dataclasses

import torch

from ..core.policy import Policy
from ..kernels import dispatch as kd
from .linear import QuantDense

__all__ = ["FFN"]


def _silu(x: torch.Tensor, quantized: bool) -> torch.Tensor:
    return x * (kd.qsigmoid(x) if quantized else torch.sigmoid(x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


@dataclasses.dataclass(frozen=True)
class FFN:
    dim: int
    hidden: int
    kind: str = "swiglu"  # swiglu | gelu | geglu
    quant_silu: bool = False

    def __post_init__(self):
        if self.kind not in ("swiglu", "gelu", "geglu"):
            raise ValueError(f"FFN kind must be swiglu, gelu or geglu, got {self.kind!r}")

    def _in(self) -> QuantDense:
        return QuantDense(self.dim, self.hidden, use_bias=False, in_axis="embed", out_axis="mlp")

    def _out(self) -> QuantDense:
        return QuantDense(self.hidden, self.dim, use_bias=False, in_axis="mlp", out_axis="embed")

    def init(self, generator: torch.Generator):
        p = {"wi": self._in().init(generator), "wo": self._out().init(generator)}
        if self.kind != "gelu":
            p["wg"] = self._in().init(generator)
        return p

    def specs(self):
        s = {"wi": self._in().specs(), "wo": self._out().specs()}
        if self.kind != "gelu":
            s["wg"] = self._in().specs()
        return s

    def apply(self, p, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        h = self._in().apply(p["wi"], x, policy)
        if self.kind == "swiglu":
            g = self._in().apply(p["wg"], x, policy)
            h = _silu(g, self.quant_silu and policy.sigmoid_quant) * h
        elif self.kind == "geglu":
            h = _gelu(self._in().apply(p["wg"], x, policy)) * h
        else:
            h = _gelu(h)
        return self._out().apply(p["wo"], h, policy)
