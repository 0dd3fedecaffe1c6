"""Precision policies (paper Tables II & VI), with torch dtypes.

Counterpart of ``repro.core.policy``: the same frozen ``Policy`` table. A
policy says, per quantization site, what to do: weights (floatsd8 | none),
weight gradients, inter-layer / first-layer / last-layer activations,
master-copy dtype, the two-region sigmoid, and the matmul compute dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["Policy", "FP32", "BF16", "FLOATSD8_TABLE2", "FLOATSD8_TABLE6", "get_policy"]

_DTYPES = {
    "fp8": torch.float8_e5m2,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
    "none": None,
}


def _dt(name: str | None):
    return None if name is None else _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str = "fp32"
    weight_quant: str = "none"  # "floatsd8" | "none"
    grad_quant: str = "none"  # "fp8" | "none" ("fp8_kernel": fused BPTT, set by the train step)
    act_fwd: str = "none"  # inter-layer activations, forward
    act_bwd: str = "none"  # inter-layer activation-gradients, backward
    first_layer_act: str = "none"  # embedding output
    last_layer_act: str = "none"  # logits/output layer
    master_dtype: str = "fp32"  # optimizer master copy
    sigmoid_quant: bool = False  # two-region FloatSD8 sigmoid (Eq. 7-8)
    compute_dtype: str = "fp32"  # dtype matmuls execute in
    param_dtype: str = "fp32"  # dtype quantized weights are materialized in
    loss_scale: float = 1.0

    def cdt(self):
        return _dt(self.compute_dtype)

    def mdt(self):
        """The optimizer master copy's dtype."""
        return _dt(self.master_dtype)

    def cell_dtype(self):
        """Cell-state storage dtype: fp16 under an fp16 master, else f32."""
        return torch.float16 if self.master_dtype == "fp16" else torch.float32

    def act_dtypes(self, site: str = "hidden"):
        """(fwd_dtype, bwd_dtype) for 'first' | 'hidden' | 'last'."""
        fwd = {"first": self.first_layer_act, "last": self.last_layer_act}.get(
            site, self.act_fwd
        )
        return _dt(fwd), _dt(self.act_bwd)

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)


FP32 = Policy(name="fp32")

BF16 = Policy(name="bf16", compute_dtype="bf16", param_dtype="bf16")

# Table II: the original proposed scheme — FP32 master, FP8 everywhere.
FLOATSD8_TABLE2 = Policy(
    name="floatsd8_table2",
    weight_quant="floatsd8",
    grad_quant="fp8",
    act_fwd="fp8",
    act_bwd="fp8",
    first_layer_act="fp8",
    last_layer_act="fp8",
    master_dtype="fp32",
    sigmoid_quant=True,
    loss_scale=1024.0,
)

# Table VI: the modified scheme — FP16 master, FP16 last-layer activations.
FLOATSD8_TABLE6 = FLOATSD8_TABLE2.replace(
    name="floatsd8_table6",
    last_layer_act="fp16",
    master_dtype="fp16",
)

# bf16 matmul-issue variant of Table VI
FLOATSD8_TPU = FLOATSD8_TABLE6.replace(
    name="floatsd8_tpu", compute_dtype="bf16", param_dtype="bf16"
)

_REGISTRY = {
    p.name: p for p in (FP32, BF16, FLOATSD8_TABLE2, FLOATSD8_TABLE6, FLOATSD8_TPU)
}


def get_policy(name: str, **overrides: Any) -> Policy:
    p = _REGISTRY[name]
    return p.replace(**overrides) if overrides else p
