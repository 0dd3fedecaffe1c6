"""FP8-compressed cross-pod gradient reduction.

Counterpart of ``repro.optim.grad_compress``. On a ("pod", "data",
"model") mesh the pods' partial gradients cross the slow link once a step;
``pod_compressed_mean`` sends each as FP8 e5m2 with a per-tensor
power-of-two scale (``fp8_psum``): a quarter of the f32 bytes. As in the
reference, no training path calls it: the train step reduces over "pod"
in full precision.

Two choices where the reference's arithmetic is not what it means:
  * the scale is 2^floor(log2(28672 / max|x|)) built from the quotient's
    exponent bits, an exact power of two at and beside every power of two
    (the reference's ``exp2(floor(log2(q)))`` on XLA's CPU is a ulp off
    where log2 rounds across an integer, and exp2 of an integer is not
    always a power of two);
  * the e5m2 cast saturates finite values at ±57344 (``core.fp8``), where
    the reference's ``astype`` overflows them to ±inf. The scale is the
    group's largest, so a rank whose max|x| is larger than another's can
    reach it.
"""
from __future__ import annotations

import torch

from .._tree import tree_map
from ..core.floatsd import exp2i
from ..core.fp8 import cast_fp8
from ..distributed import sharding as shd

__all__ = ["fp8_psum", "pod_compressed_mean"]

_f32 = torch.float32


def _po2_scale(x: torch.Tensor) -> torch.Tensor:
    """Power-of-two per-tensor scale placing max|x| at or below 28672 (half
    the e5m2 max): 2^floor(log2(28672 / amax)) from the quotient's bits;
    a zero or NaN max counts as 1; q = 0 (amax inf) gives 0, q = inf gives
    inf, as the reference's formula does."""
    amax = torch.max(torch.abs(x.to(_f32)))
    amax = torch.where(amax > 0, amax, torch.ones_like(amax))
    q = 28672.0 / amax
    _, ex = torch.frexp(q)  # q = m * 2^ex, m in [0.5, 1): floor(log2 q) = ex - 1
    return torch.where((q > 0) & torch.isfinite(q), exp2i(ex - 1), q)


def fp8_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Quantize to e5m2 at the group's largest po2 scale, sum in f32 over
    ``group`` (the default group when None), divide by (ranks x scale):
    the mean of the ranks' x as each would arrive in 8 bits. In x's dtype."""
    group = group or torch.distributed.group.WORLD
    s = shd.all_reduce(_po2_scale(x), op="max", group=group)
    xq = cast_fp8(x.to(_f32) * s)
    tot = shd.all_reduce(xq.to(_f32), op="sum", group=group)
    n = torch.full((), float(torch.distributed.get_world_size(group)), dtype=_f32, device=x.device)
    return (tot / (n * s)).to(x.dtype)


def pod_compressed_mean(grads, mesh, pod_axis: str = "pod"):
    """Each leaf's mean over the mesh's ``pod_axis`` ranks with FP8
    payloads (``fp8_psum`` over that axis's group); unchanged when the mesh
    has no such axis or it has one rank."""
    if shd.axis_sizes(mesh).get(pod_axis, 1) == 1:
        return grads
    group = mesh.get_group(pod_axis)
    return tree_map(lambda t: fp8_psum(t, group), grads)
