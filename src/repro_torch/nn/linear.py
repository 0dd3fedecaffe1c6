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

Under tensor parallelism (a "model" axis above one, ``distributed.sharding``)
a ``QuantDense`` whose output dim the rules put on "model" holds a column
piece of w (and of b) and computes its columns: its input's gradient,
which is then a partial sum, is summed over "model" in f32 before the FP8
backward cast of the activation quantizer it reaches. One whose input dim
is on "model" holds a row piece and takes the matching columns of x: its
f32 partial products are summed over "model" before the cast to the
compute dtype and the bias. A quantized piece takes the FloatSD8 bias of
the whole weight (max|w| reduced by max over "model"). The embedding is
vocab-parallel: each rank looks up the rows it holds, the sum over "model"
gives every token its row, and the tied head computes the rank's vocab
columns. At a "model" axis of one nothing of this runs.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import floatsd, floatsd4
from ..core.fp8 import act_quant
from ..core.policy import Policy
from ..distributed import sharding as shd
from ..kernels import dispatch as kd
from ..kernels.floatsd_matmul.ref import no_tf32
from .module import truncated_normal_init

__all__ = [
    "QuantDense", "QuantEmbedding", "quant_act", "quant_weight", "policy_einsum",
    "quant_einsum",
]


def quant_weight(w, policy: Policy, piece: bool = False):
    """The policy's weight quantizer, then a cast to the compute dtype; the
    gradient reaches the master (an fp16 one too) through the cast and the
    straight-through quantizer. Packed weights (either format) pass
    through: the codes are the quantized weights. A ``piece`` of a weight
    split over "model" is quantized at the whole weight's bias."""
    if kd.is_any_packed(w):
        if piece:
            raise NotImplementedError("tensor parallelism over packed weights is not ported")
        return w
    if policy.weight_quant == "floatsd8":
        amax = w.detach()
        if piece:
            amax = shd.all_reduce(torch.max(torch.abs(amax.to(torch.float32))), ("model",), op="max")
        w = floatsd.quantize_ste(w, floatsd.fit_bias(amax))
    return w.to(policy.cdt() or w.dtype)


def quant_act(x: torch.Tensor, policy: Policy, site: str = "hidden") -> torch.Tensor:
    """Activation quantization node at 'first' | 'hidden' | 'last': the
    forward value and its incoming gradient, per the policy."""
    fwd, bwd = policy.act_dtypes(site)
    if fwd is None and bwd is None:
        return x
    return act_quant(x, fwd, bwd)


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor, col: bool = False) -> torch.Tensor:
    """The product in f32; ``col``: a column piece's, a's gradient summed
    over "model" in f32."""
    af = a.to(torch.float32)
    if col:
        af = shd.copy_to_model(af)
    with no_tf32():
        return torch.einsum(eq, af, b.to(torch.float32))


class _EinsumGC(torch.autograd.Function):
    """einsum with an explicit-transpose backward: dx keeps f32; dW is
    computed in f32 and rounded once to bf16 (the gradient-compression
    point), then returned in w's dtype.

    Under a mesh (active at the forward) x and the incoming gradient hold
    this rank's share of the batch (dim 0). They are all-gathered, so dW is
    the global rows' one product, rounded once; the batch's first rank
    returns it and every other rank zeros, so the train step's sum of the
    ranks' shares is that dW exactly (the reference reduces before it
    quantizes). At a column piece (``col``) dx is a partial sum over
    "model", summed in f32 before its cast; dW is the piece's own."""

    @staticmethod
    def forward(ctx, eq, x, w, col):
        ctx.eq, ctx.col = eq, col
        ctx.mesh = shd.active_mesh()  # the backward may run on autograd's device thread
        ctx.save_for_backward(x, w)
        return _einsum_f32(eq, x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        in1, in2 = ins.split(",")
        dx = _einsum_f32(f"{in2},{out}->{in1}", w, g)
        if ctx.col:
            dx = shd.all_reduce(dx, ("model",), ctx.mesh)
        dx = dx.to(x.dtype)
        xs, gs = x, g
        if ctx.mesh is not None:
            axes = shd.batch_axes(ctx.mesh)
            xs, gs = shd.all_gather(x, 0, axes, ctx.mesh), shd.all_gather(g, 0, axes, ctx.mesh)
            if shd.batch_rank(ctx.mesh):
                return None, dx, torch.zeros_like(w), None
        dw = _einsum_f32(f"{in1},{out}->{in2}", xs, gs).to(torch.bfloat16).to(w.dtype)
        return None, dx, dw, None


def policy_einsum(eq: str, x: torch.Tensor, w, policy: Policy, col: bool = False) -> torch.Tensor:
    """The bare matmul all weight sites share: f32 accumulation, bf16 dW
    emission when the policy quantizes gradients. Operands must already be
    quantized and cast. Packed weights (either format) go to the kernel
    dispatch layer. ``col``: w is a column piece (``_EinsumGC``)."""
    if kd.is_any_packed(w):
        return kd.packed_einsum(eq, x, w)
    if policy.grad_quant != "none":
        return _EinsumGC.apply(eq.replace(" ", ""), x, w, col)
    return _einsum_f32(eq, x, w, col)


def quant_einsum(eq: str, x: torch.Tensor, w, policy: Policy, site: str = "hidden", tp: str | None = None):
    """einsum with both operands quantized per policy; f32 accumulation.
    ``tp``: w is a "col" or "row" piece of a weight split over "model"
    (module docstring)."""
    xq = quant_act(x, policy, site)
    cdt = policy.cdt() or x.dtype
    if kd.is_any_packed(w):
        if tp is not None:
            raise NotImplementedError("tensor parallelism over packed weights is not ported")
        y = kd.packed_einsum(eq, xq.to(cdt), w)
    else:
        y = policy_einsum(eq, xq.to(cdt), quant_weight(w, policy, tp is not None).to(cdt), policy,
                          tp == "col")
    if tp == "row":
        y = shd.reduce_from_model(y)
    return y.to(cdt)


@dataclasses.dataclass(frozen=True)
class QuantDense:
    """A weight site with an optional bias: x [..., in] @ w [in, out] (+ b),
    both operands quantized per policy, f32 accumulation. A packed ``w``
    runs the matmul kernel. ``in_axis`` and ``out_axis`` name w's dims
    (``specs``)."""

    in_dim: int
    out_dim: int
    use_bias: bool = True
    in_axis: str = "embed"
    out_axis: str = "mlp"

    def init(self, generator: torch.Generator):
        p = {"w": truncated_normal_init(generator, (self.in_dim, self.out_dim))}
        if self.use_bias:
            p["b"] = torch.zeros((self.out_dim,), dtype=torch.float32, device=generator.device)
        return p

    def specs(self):
        s = {"w": (self.in_axis, self.out_axis)}
        if self.use_bias:
            s["b"] = (self.out_axis,)
        return s

    def tp(self) -> str | None:
        """"col" where the rules put w's output dim on a "model" axis above
        one, "row" where they put its input dim there, else None."""
        if shd.model_size() == 1:
            return None
        shd.check_tp()
        if shd.tp_pieces(self.out_axis, self.out_dim) > 1:
            return "col"
        if shd.tp_pieces(self.in_axis, self.in_dim) > 1:
            return "row"
        return None

    def apply(self, p, x: torch.Tensor, policy: Policy, site: str = "hidden") -> torch.Tensor:
        y = quant_einsum("...d,df->...f", x, p["w"], policy, site, self.tp())
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

    def specs(self):
        return {"table": ("vocab", "embed")}

    def apply(self, p, tokens: torch.Tensor, policy: Policy) -> torch.Tensor:
        """tokens -> embeddings (the 'first layer activation' site). A
        packed table gathers the codes (a FloatSD4 one its nibbles and
        group exponents), then decodes only those rows."""
        table = p["table"]
        if self.tp():
            return quant_act(self._lookup_piece(table, tokens, policy), policy, site="first")
        if kd.is_packed4(table):
            y = floatsd4.gather_decode(table.codes, table.exps, tokens,
                                       dtype=policy.cdt() or torch.float32)
        elif kd.is_packed(table):
            y = floatsd.decode(table.codes[tokens], table.bias,
                               dtype=policy.cdt() or torch.float32)
        else:
            y = _GatherRows.apply(quant_weight(table, policy), tokens)
        return quant_act(y, policy, site="first")

    def tp(self) -> bool:
        """Whether the rules split the vocab over a "model" axis above one:
        the table is then this rank's rows."""
        if shd.model_size() == 1:
            return False
        shd.check_tp()
        return shd.tp_pieces("vocab", self.vocab) > 1

    def _lookup_piece(self, table, tokens: torch.Tensor, policy: Policy) -> torch.Tensor:
        """The rows of the tokens this rank's table piece holds, zeros for
        the others, summed over "model" in f32 (one rank holds each row)."""
        wq = quant_weight(table, policy, piece=True)
        n = wq.shape[0]
        local = tokens - shd.model_rank() * n
        inside = (local >= 0) & (local < n)
        y = _GatherRows.apply(wq, torch.where(inside, local, 0))
        y = torch.where(inside[..., None], y.to(torch.float32), 0.0)
        return shd.reduce_from_model(y).to(wq.dtype)

    def attend(self, p, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        """Tied-weight logits head x @ table^T (the 'last layer' site);
        under tensor parallelism this rank's vocab columns."""
        return quant_einsum("...d,vd->...v", x, p["table"], policy, site="last",
                            tp="col" if self.tp() else None)
