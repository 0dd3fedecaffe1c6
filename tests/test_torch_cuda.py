"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these skip without an
NVIDIA GPU. This file imports neither JAX nor the JAX package, so it runs
on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: floatsd_matmul and matmul_dx |y - y_plain| <= 1e-5 * (|x| @
|W|) elementwise on both routes (route A, M <= 64, sums in the plain
version's order, but on arbitrary f32 inputs the products are not exact and
a fused multiply-add may round differently from the plain version's; route
B, M > 64, sums on the tensor cores in their own order), bit for bit on
route A with FP8 or FP16 activations (every product exact, the same order),
and bit for bit from one launch to the next on both; matmul_dw the same
bound without the flush, and with it equal except at most 0.1% of
elements, each one e5m2 step apart, with inf and NaN where the plain
version has them, and bit for bit on FP8 x and g (exact products, the
same order over the rows); lstm_cell and lstm_cell_grad
bit for bit (the kernels round exactly where the plain versions round);
fused layer gradients, kernels against the plain versions, within rtol
2e-3, atol 1e-5 (the JAX package's kernel-vs-reference bound); two
identical train steps bit for bit; floatsd4_matmul bit for bit on FP8
and FP16 activations (every product exact, the plan's ordered split at any
M) and within the matmul bound on f32 ones;
the quantize kernel byte for byte against ``core.floatsd.encode``; the
qsigmoid kernel bit for bit on f32; the chunked rwkv_wkv kernel against the
per-token recurrence within rtol 2e-4, atol 2e-4 (the JAX package's
chunked-vs-recurrence bound) or, where a value cancels far below its terms
(slow decay over 1024 tokens), within 1e-5 of the sum of the terms'
magnitudes, outputs and final states, and bit for bit
from one launch to the next; the reduced RWKV-6 model on the kernels
against its plain versions on the card within 1e-4 of the logit scale;
the flash-attention kernel against both its plain versions (the f32
oracle and the model's chunked online softmax) within rtol 2e-2, atol 6e-3
on f32 inputs and rtol 3e-2, atol 2e-2 on bf16 ones (the JAX package's
kernel-vs-oracle bounds: p and v are rounded to bf16 before their
product), and bit for bit from one launch to the next; its f32 scores
against the chunked plain version (which rounds p and v as the kernel
does, so only the scores differ) within a quarter of the error of that
plain version on bf16-rounded q and k (one bf16 pass of the scores); the
wkv bound rejects the recurrence with the bonus u dropped; the reduced dense
model on the kernels against its plain versions within one bf16 step
(2^-8) of the logit scale with no activation quantizer (the two attentions
round p to bf16 from scores that differ in their last bits: a p on a
rounding boundary lands one step apart; seen 1.1e-3), and its decode
steps within 1e-2 of
it from its prefill (a bf16 KV cache against bf16 p and v: at this config
and a default init, whose logits stay below 1, the JAX package's own gap
is 3.1e-3 to 3.9e-3 over three seeds).
The training runtime: save-z against remat bit
for bit (B 4 and 128; plain, reverse, masked, fp16 cell), ``train_matmul``
(the forward on route A and FP8 activations bit for bit, dx and dw as
``matmul_dx`` and ``matmul_dw``) and
``lstm_cell_train`` bit for bit against their plain versions, the train
step's telemetry equal to the plain path's, the ``matmul_dw`` flush hook's
counts equal to the snapped dW's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import floatsd, floatsd4  # noqa: E402
from repro_torch.core.fp8 import FP16, quantize_fp8  # noqa: E402
from repro_torch.core.qsigmoid import qsigmoid_raw  # noqa: E402
from repro_torch.kernels import dispatch as kd  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ops import floatsd_matmul, matmul_dw, matmul_dx, plan  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ref import (  # noqa: E402
    floatsd_matmul_ref, matmul_dw_ref, matmul_dx_ref,
)
from repro_torch.kernels.floatsd4_matmul.ops import floatsd4_matmul  # noqa: E402
from repro_torch.kernels.floatsd4_matmul.ref import floatsd4_matmul_ref  # noqa: E402
from repro_torch.kernels.floatsd_quantize.ops import floatsd_quantize  # noqa: E402
from repro_torch.kernels.lstm_cell.ops import lstm_cell, lstm_cell_grad  # noqa: E402
from repro_torch.kernels.qsigmoid.ops import qsigmoid  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_gqa, flash_attention_ref  # noqa: E402
from repro_torch.kernels.rwkv_wkv.ops import rwkv_wkv  # noqa: E402
from repro_torch.kernels.rwkv_wkv.ref import wkv_ref  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_bwd_ref, lstm_cell_ref  # noqa: E402
from repro_torch.models import WikiText2LM  # noqa: E402
from repro_torch.nn.lstm import BiLSTM, LSTMLayer  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.optim.train_state import batch_to_device, init_state, make_train_step  # noqa: E402

# across the routes' boundary (route A for M <= 64, B above), ragged N and K
MATMUL_SHAPES = [(3, 100, 130), (8, 128, 256), (1, 64, 33), (24, 256, 512), (8, 1024, 4096),
                 (64, 1024, 4096), (64, 999, 130), (65, 1024, 4096), (65, 100, 130), (2048, 3840, 1000),
                 (2048, 1000, 264)]
CELL_SHAPES = [(5, 200), (8, 1024), (1, 33)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_floatsd_matmul_kernel_matches_plain(dev, m, k, n, transposed):
    g = _gen(dev, m + k + n)
    x = torch.randn((m, k), device=dev, generator=g)
    w = torch.randn((n, k) if transposed else (k, n), device=dev, generator=g) * 0.05
    codes, bias = floatsd.encode(w)
    n0 = floatsd_matmul.launches
    got = floatsd_matmul(x, codes, int(bias), transposed=transposed)
    want = floatsd_matmul_ref(x, codes, int(bias), transposed=transposed)
    wd = floatsd.decode(codes, bias).double().abs()
    bound = 1e-5 * (x.double().abs() @ (wd.t() if transposed else wd))
    torch.cuda.synchronize()
    assert floatsd_matmul.launches == n0 + 1
    assert bool(((got.double() - want.double()).abs() <= bound + 1e-30).all())


def _mm_bound(x, codes, bias, transposed):
    wd = floatsd.decode(codes, bias).double().abs()
    return 1e-5 * (x.double().abs() @ (wd.t() if transposed else wd)) + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("act", ["fp8", "fp16"])
def test_floatsd_matmul_routes_on_served_activations(dev, m, k, n, transposed, act):
    """FP8 or FP16 activations, as served: route A equals the plain version
    bit for bit, route B stays within the precise bound, and two launches
    are bit-identical on either."""
    g = _gen(dev, 3 * m + k + n)
    x = torch.randn((m, k), device=dev, generator=g)
    x = quantize_fp8(x) if act == "fp8" else quantize_fp8(x, torch.float16)
    w = torch.randn((n, k) if transposed else (k, n), device=dev, generator=g) * 0.05
    codes, bias = floatsd.encode(w)
    bias = int(bias)
    got = floatsd_matmul(x, codes, bias, transposed=transposed)
    again = floatsd_matmul(x, codes, bias, transposed=transposed)
    want = floatsd_matmul_ref(x, codes, bias, transposed=transposed)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if plan(m, n, k).route == "A":
        assert torch.equal(got, want)
    else:
        assert bool(((got.double() - want.double()).abs() <= _mm_bound(x, codes, bias, transposed)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(130, 1024, 200), (3072, 1024, 4096), (200, 1100, 140)])
@pytest.mark.parametrize("transposed", [False, True])
def test_floatsd_matmul_ordered_route_at_large_m(dev, m, k, n, transposed):
    """Asked for its ordered route, the kernel runs route A at any M (each
    block adding its tile's chunks in order where the partials would be
    large): bit for bit the plain version on FP8 activations, and each row
    the bits that a 64-row launch gives it; matmul_dx likewise."""
    g = _gen(dev, m + 5 * k + n)
    x = quantize_fp8(torch.randn((m, k), device=dev, generator=g))
    codes, bias = floatsd.encode(torch.randn((n, k) if transposed else (k, n), device=dev, generator=g) * 0.05)
    bias = int(bias)
    assert plan(m, n, k, True).route == "A"
    got = floatsd_matmul(x, codes, bias, transposed=transposed, ordered=True)
    assert torch.equal(got, floatsd_matmul_ref(x, codes, bias, transposed=transposed, ordered=True))
    assert torch.equal(got[64:128], floatsd_matmul(x[64:128].contiguous(), codes, bias, transposed=transposed))
    if not transposed:
        gr = quantize_fp8(torch.randn((m, n), device=dev, generator=g))
        dx = matmul_dx(gr, codes, bias, ordered=True)
        assert torch.equal(dx, matmul_dx_ref(gr, codes, bias, ordered=True))
        assert torch.equal(dx[:64], matmul_dx(gr[:64].contiguous(), codes, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
def test_floatsd_matmul_route_b_tiny_x_and_a_moved_code(dev, transposed):
    """Route B on f32 x near 2^-120 (its mid and lo pieces are bf16
    subnormals) stays within the bound; the plain version on codes with one
    code moved one mantissa step does not."""
    m, k, n = 130, 512, 200
    assert plan(m, n, k).route == "B"
    g = _gen(dev, 120 + transposed)
    x = torch.randn((m, k), device=dev, generator=g) * 2.0**-120
    codes, bias = floatsd.encode(torch.randn((n, k) if transposed else (k, n), device=dev, generator=g))
    bias = int(bias)
    got = floatsd_matmul(x, codes, bias, transposed=transposed)
    bound = _mm_bound(x, codes, bias, transposed)
    torch.cuda.synchronize()
    assert float(got.abs().max()) > 2.0**-120  # y is normal
    assert bool(((got.double() - floatsd_matmul_ref(x, codes, bias, transposed=transposed).double()).abs()
                 <= bound).all())
    x = quantize_fp8(x * 2.0**120)
    got = floatsd_matmul(x, codes, bias, transposed=transposed)
    flat = codes.reshape(-1).clone()
    i = int((((flat & 31) > 15) & ((flat & 31) < 30)).nonzero()[0])
    flat[i] += 1
    moved = floatsd_matmul_ref(x, flat.reshape(codes.shape), bias, transposed=transposed)
    bound = _mm_bound(x, codes, bias, transposed)
    torch.cuda.synchronize()
    assert bool(((got.double() - moved.double()).abs() > bound).any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", CELL_SHAPES)
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("c_dtype", [torch.float16, torch.float32])
def test_lstm_cell_kernel_matches_plain_bitwise(dev, b, h, quantized, c_dtype):
    g = _gen(dev, b * h)
    z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
    c = torch.randn((b, h), device=dev, generator=g).to(c_dtype)
    n0 = lstm_cell.launches
    h_k, c_k = lstm_cell(z, c, quantized=quantized, c_dtype=c_dtype)
    h_r, c_r = lstm_cell_ref(z, c, quantized, c_dtype=c_dtype)
    torch.cuda.synchronize()
    assert lstm_cell.launches == n0 + 1
    assert torch.equal(h_k, h_r) and torch.equal(c_k, c_r)


@pytest.mark.cuda
def test_dispatch_routes_cuda_tensors_to_the_kernels(dev):
    kd.STATS.reset()
    x = torch.randn((4, 64), device=dev)
    codes, bias = floatsd.encode(torch.randn((64, 32), device=dev))
    kd.matmul(x, codes, int(bias))
    kd.lstm_cell(torch.randn((4, 128), device=dev), torch.zeros((4, 32), device=dev, dtype=torch.float16))
    kd.matmul(x, codes, int(bias), backend="ref")
    torch.cuda.synchronize()
    assert kd.STATS.count("floatsd_matmul", "cuda") == 1 and kd.STATS.count("lstm_cell", "cuda") == 1
    assert kd.STATS.count("floatsd_matmul", "ref") == 1


# (M rows of g, K = out, N = contraction): the recurrence and batched dXs shapes
DX_SHAPES = [(3, 100, 130), (8, 128, 256), (64, 1024, 4096), (130, 300, 1000)]
# the last two ragged in all of M, K and N (none a multiple of the 128 x 128
# tile or of the 16-row stage): rows of a multiple of 4 floats, and not
DW_SHAPES = [(36, 12, 64), (100, 70, 130), (3072, 64, 256), (517, 300, 260), (1000, 201, 259)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", DX_SHAPES)
def test_matmul_dx_kernel_matches_plain(dev, m, k, n):
    g = _gen(dev, m * k + n)
    gr = torch.randn((m, n), device=dev, generator=g)
    codes, bias = floatsd.encode(torch.randn((k, n), device=dev, generator=g) * 0.05)
    n0 = matmul_dx.launches
    got = matmul_dx(gr, codes, int(bias))
    want = matmul_dx_ref(gr, codes, int(bias))
    bound = 1e-5 * (gr.double().abs() @ floatsd.decode(codes, bias).double().abs().t())
    torch.cuda.synchronize()
    assert matmul_dx.launches == n0 + 1 and got.shape == (m, k)
    assert bool(((got.double() - want.double()).abs() <= bound + 1e-30).all())


def _e5m2_step(v: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0**-14))) - 2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", DW_SHAPES)
def test_matmul_dw_kernel_matches_plain(dev, m, k, n):
    g = _gen(dev, m + k * n)
    x = torch.randn((m, k), device=dev, generator=g)
    gr = torch.randn((m, n), device=dev, generator=g) * 100
    n0 = matmul_dw.launches
    raw, raw_p = matmul_dw(x, gr, quant=False), matmul_dw_ref(x, gr, quant=False)
    got, want = matmul_dw(x, gr), matmul_dw_ref(x, gr)
    bound = 1e-5 * (x.double().abs().t() @ gr.double().abs())
    torch.cuda.synchronize()
    assert matmul_dw.launches == n0 + 2
    assert bool(((raw.double() - raw_p.double()).abs() <= bound + 1e-30).all())
    off = got != want
    assert int(off.sum()) <= 1e-3 * got.numel()
    step = _e5m2_step(torch.maximum(got.abs(), want.abs()))
    assert bool(((got - want).abs()[off] <= step[off]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", DW_SHAPES + [(3072, 1024, 512)])
def test_matmul_dw_sums_rows_in_order_bit_for_bit(dev, m, k, n):
    """FP8 x and g: every product is exact in f32, so the kernel's fmaf
    chain over m = 0 .. M-1 and the plain version's ordered sum give the
    same bits, raw and snapped; over exponents of 2^-6 .. 2^6 the sums
    round, so another order would not."""
    g = _gen(dev, 7 * m + k + n)

    def wide(shape):
        e = torch.randint(-6, 7, shape, device=dev, generator=g).float()
        return quantize_fp8(torch.randn(shape, device=dev, generator=g) * torch.exp2(e))

    x, gr = wide((m, k)), wide((m, n))
    raw, raw_p = matmul_dw(x, gr, quant=False), matmul_dw_ref(x, gr, quant=False)
    got, want = matmul_dw(x, gr), matmul_dw_ref(x, gr)
    torch.cuda.synchronize()
    assert torch.equal(raw, raw_p) and torch.equal(got, want)
    assert not torch.equal(raw, matmul_dw_ref(x.flip(0), gr.flip(0), quant=False))  # the order shows


@pytest.mark.cuda
def test_matmul_dw_flush_saturates_finite_and_keeps_inf_nan(dev):
    x = torch.ones((4, 4), device=dev)
    gr = torch.ones((4, 5), device=dev)
    x[:, 1] = 3e4  # sums to 1.2e5 * g: finite overflow of e5m2, saturates
    x[:, 2] = 1e20
    gr[:, 4] = 1e20  # 1e40 overflows f32: +inf
    x[2, 3] = float("nan")
    x[0, 0] = float("-inf")
    got, want = matmul_dw(x, gr), matmul_dw_ref(x, gr)
    torch.cuda.synchronize()
    assert bool((got.isnan() == want.isnan()).all()) and bool(got.isnan().any())
    assert bool((got.isinf() == want.isinf()).all()) and bool(got.isinf().any())
    fin = got.isfinite()
    assert torch.equal(got[fin], want[fin]) and float(got[fin].abs().max()) == 57344.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", CELL_SHAPES + [(64, 1024)])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("c_dtype", [torch.float16, torch.float32])
def test_lstm_cell_grad_kernel_matches_plain_bitwise(dev, b, h, quantized, c_dtype):
    """The kernel reads c_prev in its storage dtype and writes an f32
    dc_prev; the plain version sees the same values in f32."""
    g = _gen(dev, b * h + 1)
    z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
    c = torch.randn((b, h), device=dev, generator=g).to(torch.float16).to(c_dtype)
    dh, dc = (torch.randn((b, h), device=dev, generator=g) for _ in range(2))
    n0 = lstm_cell_grad.launches
    dz_k, dcp_k = lstm_cell_grad(z, c, dh, dc, quantized=quantized, c_dtype=c_dtype)
    dz_r, dcp_r = lstm_cell_bwd_ref(z, c.float(), dh, dc, quantized, c_dtype=c_dtype)
    torch.cuda.synchronize()
    assert lstm_cell_grad.launches == n0 + 1 and dcp_k.dtype == torch.float32
    assert torch.equal(dz_k, dz_r) and torch.equal(dcp_k, dcp_r)


@pytest.mark.cuda
def test_fused_layer_grads_kernels_match_plain(dev):
    pol = get_policy("floatsd8_table6").replace(grad_quant="fp8_kernel")
    layer = LSTMLayer(48, 40)
    p0 = {k: v.to(torch.float16) for k, v in layer.init(_gen(dev, 3)).items()}
    xs = torch.randn((4, 9, 48), device=dev, generator=_gen(dev, 4))

    def grads(backend):
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        with kd.use_backend(backend):
            h, fin = layer.apply(p, xs, pol)
            (h.square().sum() + fin.c.float().square().sum()).backward()
        return h.detach(), {k: v.grad.float() for k, v in p.items()}

    kd.STATS.reset()
    h_k, g_k = grads(None)
    assert kd.STATS.count(backend="ref") == 0 and kd.STATS.count("floatsd_matmul_dw", "cuda") == 2
    h_r, g_r = grads("ref")
    assert torch.equal(h_k, h_r)  # forward products are exact: bit for bit
    for k in g_k:
        torch.testing.assert_close(g_k[k], g_r[k], rtol=2e-3, atol=1e-5)


@pytest.mark.cuda
def test_training_forward_equals_inference_forward_on_card(dev):
    """The fused BPTT's forward and the serving scan run the same kernels
    on the same codes: equal bit for bit."""
    layer = LSTMLayer(48, 40)
    p = {k: v.to(torch.float16).requires_grad_() for k, v in layer.init(_gen(dev, 5)).items()}
    xs = torch.randn((4, 9, 48), device=dev, generator=_gen(dev, 6))
    pol = get_policy("floatsd8_table6")
    h_train, st_train = layer.apply(p, xs, pol.replace(grad_quant="fp8_kernel"))
    packed = {"wx": kd.pack_train(p["wx"]), "wh": kd.pack_train(p["wh"]), "b": p["b"].detach()}
    with torch.no_grad():
        h_inf, st_inf = layer.apply(packed, xs, pol)
    torch.cuda.synchronize()
    assert torch.equal(h_train.detach(), h_inf) and torch.equal(st_train.c.detach(), st_inf.c)


@pytest.mark.cuda
def test_train_step_is_deterministic_on_card(dev):
    """Two identical steps (duplicate tokens in the batch: the embedding's
    scatter must add them in a fixed order) give identical losses and
    identical parameters."""
    model = WikiText2LM(vocab=128, emb=32, hidden=32, n_layers=2)
    pol, opt = get_policy("floatsd8_table6"), sgd(0.9)
    batches = list(zip(range(2), synthetic.wikitext2(batch=8, seq=16, vocab=128).batches))

    def run():
        state = init_state(model.init(_gen(dev, 0)), opt, pol)
        step = make_train_step(model.loss, opt, pol, lr=0.5)
        losses = []
        for _, b in batches:
            state, m = step(state, batch_to_device(b, dev))
            losses.append(float(m["loss"]))
        return losses, state

    (l1, s1), (l2, s2) = run(), run()
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)))


def _engine_grads(dev, layer, p0, xs, lengths, backend):
    pol = get_policy("floatsd8_table6").replace(grad_quant="fp8_kernel")
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    with kd.use_backend(backend):
        h, fin = layer.apply(p, xs, pol, lengths=lengths)
        (h.square().sum() + fin.c.float().square().sum()).backward()
    torch.cuda.synchronize()
    return h.detach(), {k: v.grad.float() for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["reverse", "masked"])
def test_engine_variants_at_b128_kernels_match_plain(dev, variant):
    """The SNLI/Multi30K shape (B 128, K 300, H 300): every product of the
    engine on the ordered route, so h is the plain path's bit for bit; the
    gradients within the fused layer's bound (matmul_dw's f32 sum may
    round an FP8 snap differently)."""
    layer = LSTMLayer(300, 300, reverse=variant == "reverse")
    p0 = {k: v.to(torch.float16) for k, v in layer.init(_gen(dev, 7)).items()}
    xs = torch.randn((128, 5, 300), device=dev, generator=_gen(dev, 8))
    lengths = (torch.arange(128, device=dev) % 6) if variant == "masked" else None
    kd.STATS.reset()
    h_k, g_k = _engine_grads(dev, layer, p0, xs, lengths, None)
    assert kd.STATS.count(backend="ref") == 0 and kd.STATS.count("lstm_cell_grad", "cuda") == 5
    h_r, g_r = _engine_grads(dev, layer, p0, xs, lengths, "ref")
    assert torch.equal(h_k, h_r)
    for k in g_k:
        torch.testing.assert_close(g_k[k], g_r[k], rtol=2e-3, atol=1e-5)


@pytest.mark.cuda
def test_engine_forward_zs_equal_backward_recompute_at_b128_on_card(dev, monkeypatch):
    fwd, bwd = [], []
    cell, grad = kd.lstm_cell, kd.lstm_cell_grad
    monkeypatch.setattr(kd, "lstm_cell", lambda z, c, **kw: (fwd.append(z.clone()), cell(z, c, **kw))[1])
    monkeypatch.setattr(kd, "lstm_cell_grad", lambda z, *a, **kw: (bwd.append(z.clone()), grad(z, *a, **kw))[1])
    layer = LSTMLayer(300, 300)
    p = {k: v.to(torch.float16).requires_grad_() for k, v in layer.init(_gen(dev, 9)).items()}
    xs = torch.randn((128, 4, 300), device=dev, generator=_gen(dev, 10))
    h, fin = layer.apply(p, xs, get_policy("floatsd8_table6").replace(grad_quant="fp8_kernel"))
    (h.square().sum() + fin.c.float().square().sum()).backward()
    torch.cuda.synchronize()
    assert len(fwd) == len(bwd) == 4
    assert all(torch.equal(z, bwd[3 - t]) for t, z in enumerate(fwd))


@pytest.mark.cuda
def test_bilstm_launch_counts_on_card(dev):
    bi = BiLSTM(48, 40)
    p = {d: {k: v.to(torch.float16).requires_grad_() for k, v in leaves.items()}
         for d, leaves in bi.init(_gen(dev, 11)).items()}
    xs = torch.randn((6, 7, 48), device=dev, generator=_gen(dev, 12))
    wrappers = (floatsd_matmul, matmul_dx, matmul_dw, lstm_cell, lstm_cell_grad)
    for w in wrappers:
        w.launches = 0
    kd.STATS.reset()
    h = bi.apply(p, xs, get_policy("floatsd8_table6").replace(grad_quant="fp8_kernel"))
    h.float().square().sum().backward()
    torch.cuda.synchronize()
    s = xs.shape[1]
    # two engines: each 2S + 2 matmuls, S cells and cell backwards, S + 1 dx, 2 dw
    assert [w.launches for w in wrappers] == [2 * (2 * s + 2), 2 * (s + 1), 4, 2 * s, 2 * s]
    assert kd.STATS.count(backend="ref") == 0 and h.shape == (6, 7, 80)


@pytest.mark.cuda
def test_optimizer_sqrt_on_card_is_correctly_rounded(dev):
    """On the card ``_sqrt`` is torch's f32 sqrt, with no f64 round trip:
    on every f32 in [1, 4) it equals the f64 sqrt rounded once to f32."""
    from repro_torch.optim.optimizers import _sqrt

    x = (torch.arange(2**24, dtype=torch.int32, device=dev) + (127 << 23)).view(torch.float32)
    assert torch.equal(_sqrt(x), torch.sqrt(x.double()).float())


# ---------------------------------------------------------------------------
# the FloatSD4 matmul, the quantize kernel and the qsigmoid kernel
# ---------------------------------------------------------------------------

# (M, rows of the packed axis, the other axis): gate [M, K] @ [K, N] or, when
# transposed, head [M, K] @ table[N, K]^T; odd and K % 32 != 0 included
MATMUL4_SHAPES = [(5, 999, 300), (3, 100, 130), (1, 33, 7), (8, 1024, 4096), (64, 1024, 1000)]


def _packed4(dev, rows, cols, seed):
    w = torch.randn((rows, cols), device=dev, generator=_gen(dev, seed)) * 0.05
    codes, exps = floatsd4.encode(w)
    return floatsd4.pack_nibbles(codes), exps


@pytest.mark.cuda
@pytest.mark.parametrize("m,rows,cols", MATMUL4_SHAPES)
@pytest.mark.parametrize("transposed", [False, True])
def test_floatsd4_matmul_kernel_matches_plain(dev, m, rows, cols, transposed):
    codes, exps = _packed4(dev, rows, cols, m + rows + cols)
    k = cols if transposed else rows
    x = torch.randn((m, k), device=dev, generator=_gen(dev, k))
    n0 = floatsd4_matmul.launches
    xq = quantize_fp8(x)  # FP8 activations: exact products, so bit for bit
    assert torch.equal(floatsd4_matmul(xq, codes, exps, rows, transposed=transposed),
                       floatsd4_matmul_ref(xq, codes, exps, rows, transposed=transposed))
    got = floatsd4_matmul(x, codes, exps, rows, transposed=transposed)
    want = floatsd4_matmul_ref(x, codes, exps, rows, transposed=transposed)
    w = floatsd4.decode_packed(codes, exps, rows).double().abs()
    bound = 1e-5 * (x.double().abs() @ (w.t() if transposed else w))
    torch.cuda.synchronize()
    assert floatsd4_matmul.launches == n0 + 2
    assert bool(((got.double() - want.double()).abs() <= bound + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64, 65, 200])
@pytest.mark.parametrize("site", ["gate", "head"])
def test_floatsd4_matmul_ordered_split_bit_for_bit_at_any_m(dev, m, site):
    """Route A at every M, K split as plan(..., ordered=True) gives it: the
    gate [M, 1024] @ [1024, 4096] (8 chunks of 128) and the transposed head
    over a table of 2049 rows (an odd row count: a pad nibble), on FP8 and
    FP16 activations, bit for bit with the plain version."""
    rows, cols, tr = (1024, 4096, False) if site == "gate" else (2049, 1024, True)
    codes, exps = _packed4(dev, rows, cols, m + rows)
    k, n = (cols, rows) if tr else (rows, cols)
    assert plan(m, n, k, True).splits > 1
    x = torch.randn((m, k), device=dev, generator=_gen(dev, 3 * m))
    for xq in (quantize_fp8(x), quantize_fp8(x, FP16)):
        got = floatsd4_matmul(xq, codes, exps, rows, transposed=tr)
        want = floatsd4_matmul_ref(xq, codes, exps, rows, transposed=tr)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_floatsd4_matmul_subnormal_groups_on_a_split_k(dev):
    """Every other 32-row group at exponent -126 across a split K (8 chunks
    of 128): subnormal weights beside normal ones, on exact products (x in
    {-2, -1, 1, 2}), kept and summed as the plain version sums them."""
    g = _gen(dev, 126)
    codes = torch.randint(0, 16, (1024, 4096), device=dev, generator=g, dtype=torch.uint8)
    exps = torch.randint(-8, 0, (32, 4096), device=dev, generator=g, dtype=torch.int8)
    exps[::2] = -126
    packed = floatsd4.pack_nibbles(codes)
    x = torch.randint(1, 3, (8, 1024), device=dev, generator=g).float()
    x *= torch.randint(0, 2, (8, 1024), device=dev, generator=g).float() * 2 - 1
    got = floatsd4_matmul(x, packed, exps, 1024)
    want = floatsd4_matmul_ref(x, packed, exps, 1024)
    torch.cuda.synchronize()
    w = floatsd4.decode_packed(packed, exps, 1024)
    assert int(((w != 0) & (w.abs() < torch.finfo(torch.float32).tiny)).sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_floatsd4_matmul_keeps_subnormal_weights(dev):
    """Exponent -126: the codes of |mantissa| < 1 decode to f32 subnormals,
    which the kernel keeps (no flush to zero), as the plain version does."""
    codes = torch.arange(32, device=dev, dtype=torch.uint8).reshape(16, 2) % 16
    codes = floatsd4.pack_nibbles(torch.cat([codes, codes]))
    exps = torch.full((1, 2), -126, dtype=torch.int8, device=dev)
    x = torch.eye(32, device=dev)
    got = floatsd4_matmul(x, codes, exps, 32)
    assert torch.equal(got, floatsd4_matmul_ref(x, codes, exps, 32))
    assert int(((got != 0) & (got.abs() < torch.finfo(torch.float32).tiny)).sum()) == 16


def _quantize_edge_values(dev, bias, dtype):
    grid = torch.as_tensor(floatsd._GRID_POS, dtype=torch.float32, device=dev)
    mids = torch.as_tensor(floatsd._GRID_MID, dtype=torch.float32, device=dev)
    v = torch.cat([grid, mids, torch.nextafter(mids, torch.full_like(mids, 1e9)),
                   torch.tensor([600.0, 1e4], device=dev)])
    v = torch.cat([torch.tensor([0.0, -0.0], device=dev), v, -v])
    x = (v * 2.0 ** max(-126, min(120, bias))).to(dtype)
    return x[torch.isfinite(x)]  # no code for inf


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [-126, -7, 0, 127, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_quantize_kernel_matches_encode_bytewise(dev, bias, dtype):
    """±0, grid values, midpoints (ties) and their neighbours, values above
    the top, at both extreme biases, plus a random tensor at its fitted
    bias; f32 and fp16 input."""
    g = _gen(dev, 17)
    xs = [(torch.randn((1000, 33), device=dev, generator=g) * 0.3).to(dtype)]
    if bias is not None:
        xs.append(_quantize_edge_values(dev, bias, dtype))
    n0 = floatsd_quantize.launches
    for x in xs:
        b = floatsd.fit_bias(x) if bias is None else bias
        got = floatsd_quantize(x, b)
        want = floatsd.encode(x, b)[0]
        torch.cuda.synchronize()
        assert got.dtype == torch.uint8 and got.shape == x.shape
        assert torch.equal(got, want)
    assert floatsd_quantize.launches == n0 + len(xs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 4096), (1_000_003,), (7, 33)])
def test_qsigmoid_kernel_matches_plain_bitwise_on_f32(dev, shape):
    x = torch.randn(shape, device=dev, generator=_gen(dev, 23)) * 4
    x.view(-1)[:6] = torch.tensor([0.0, -0.0, 88.0, -88.0, 1e-30, -1e-30], device=dev)
    n0 = qsigmoid.launches
    got = qsigmoid(x)
    torch.cuda.synchronize()
    assert qsigmoid.launches == n0 + 1 and got.dtype == torch.float32
    assert torch.equal(got, qsigmoid_raw(x))


@pytest.mark.cuda
def test_new_kernels_raise_on_what_they_cannot_take(dev):
    """A wrong shape, dtype or bias raises; nothing falls back to the plain
    version on the card."""
    codes, exps = _packed4(dev, 64, 32, 1)
    x = torch.randn((4, 64), device=dev)
    n0 = (floatsd4_matmul.launches, floatsd_quantize.launches, qsigmoid.launches)
    with pytest.raises(ValueError):
        floatsd4_matmul(x, codes, exps, 63)  # rows disagree with x's K
    with pytest.raises(ValueError):
        floatsd4_matmul(x, codes[:-1].contiguous(), exps, 64)  # codes short of ceil(K/2) rows
    with pytest.raises(ValueError):
        floatsd4_matmul(x, codes, exps, 64, transposed=True)  # table [64, 32] has K = 32
    with pytest.raises(ValueError):
        floatsd_quantize(x, torch.zeros((), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        qsigmoid(x.double())
    assert (floatsd4_matmul.launches, floatsd_quantize.launches, qsigmoid.launches) == n0


@pytest.mark.cuda
def test_dispatch_routes_new_entry_points_to_the_kernels(dev):
    kd.STATS.reset()
    codes, exps = _packed4(dev, 64, 32, 2)
    w4 = kd.PackedTensor4(codes, exps, 64)
    x = torch.randn((4, 64), device=dev)
    assert kd.hoist_packed(w4) is w4  # the codes stay packed on the card
    kd.packed_einsum("bd,dk->bk", x, w4)
    kd.packed_einsum("...d,vd->...v", torch.randn((4, 32), device=dev), w4)
    codes8, bias = kd.quantize(x)
    kd.qsigmoid(x)
    torch.cuda.synchronize()
    assert kd.STATS.count("floatsd4_matmul", "cuda") == 2
    assert kd.STATS.count("floatsd_quantize", "cuda") == kd.STATS.count("qsigmoid", "cuda") == 1
    assert kd.STATS.count(backend="ref") == 0
    assert bias.device.type == "cuda" and torch.equal(codes8, floatsd.encode(x)[0])


# (B, S, H, K, V): the reduced model's prefill, ragged S (a short last chunk),
# V not a multiple of the walk's 16-column slice, the largest K, one head
# per batch row (the JAX kernel's [BH, S, K] layout), the full-width prefill,
# K = V = 128 over 1024 positions, a ragged S at the full head count
WKV_SHAPES = [(3, 32, 4, 32, 32), (2, 50, 2, 64, 64), (1, 33, 2, 64, 40), (1, 20, 1, 128, 128),
              (4, 16, 1, 32, 32), (2, 1024, 40, 64, 64), (1, 1024, 2, 128, 128), (1, 1000, 40, 64, 64)]


def _wkv_inputs(dev, b, s, h, k, v, w0, seed=0):
    g = _gen(dev, seed + b * s * h + k + v)
    r, kk = (torch.randn((b, s, h, k), device=dev, generator=g) for _ in range(2))
    vv = torch.randn((b, s, h, v), device=dev, generator=g)
    w = torch.exp(-torch.exp(torch.randn((b, s, h, k), device=dev, generator=g) * 0.3 + w0))
    u = torch.randn((b, h, k), device=dev, generator=g) * 0.1
    return r, kk, vv, w, u


def _assert_wkv_close(y, s_fin, y_r, s_r, inputs):
    """rtol = atol = 2e-4, or, where a value cancels far below its terms,
    1e-5 of the sum of the terms' magnitudes (the recurrence on |r|, |k|,
    |v|, |u|: f32 rounding of the terms, summed in another order)."""
    r, kk, vv, w, u = inputs
    y_t, s_t = wkv_ref(r.abs(), kk.abs(), vv.abs(), w, u.abs())
    for got, want, terms in ((y, y_r, y_t), (s_fin, s_r, s_t)):
        err = (got - want).abs()
        assert bool(((err <= 2e-4 + 2e-4 * want.abs()) | (err <= 1e-5 * terms)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,k,v", WKV_SHAPES)
@pytest.mark.parametrize("w0", [-6.0, -2.0, 1.0])
def test_rwkv_wkv_kernel_matches_plain(dev, b, s, h, k, v, w0):
    r, kk, vv, w, u = _wkv_inputs(dev, b, s, h, k, v, w0)
    n0 = rwkv_wkv.launches
    y, s_fin = rwkv_wkv(r, kk, vv, w, u)
    y_r, s_r = wkv_ref(r, kk, vv, w, u)
    torch.cuda.synchronize()
    assert rwkv_wkv.launches == n0 + 1 and y.shape == (b, s, h, v) and s_fin.shape == (b, h, k, v)
    _assert_wkv_close(y, s_fin, y_r, s_r, (r, kk, vv, w, u))
    y2, s2 = rwkv_wkv(r, kk, vv, w, u)  # a second launch: the same bits
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s_fin, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("w0", [-6.0, -2.0, 1.0])
def test_rwkv_wkv_bound_rejects_the_recurrence_without_u(dev, w0):
    """The bound's negative control on the card: the kernel passes it, the
    recurrence with the bonus u dropped does not, at the full-width prefill
    shape."""
    r, kk, vv, w, u = _wkv_inputs(dev, 2, 1024, 40, 64, 64, w0)
    y_r, s_r = wkv_ref(r, kk, vv, w, u)
    _assert_wkv_close(*rwkv_wkv(r, kk, vv, w, u), y_r, s_r, (r, kk, vv, w, u))
    with pytest.raises(AssertionError):
        _assert_wkv_close(*wkv_ref(r, kk, vv, w, torch.zeros_like(u)), y_r, s_r, (r, kk, vv, w, u))


@pytest.mark.cuda
def test_rwkv_wkv_kernel_shares_u_across_the_batch_and_raises(dev):
    r, kk, vv, w, u = _wkv_inputs(dev, 2, 48, 3, 32, 32, -2.0)
    y, s_fin = rwkv_wkv(r, kk, vv, w, u[0])  # u [H, K], as the model passes it
    y_r, s_r = wkv_ref(r, kk, vv, w, u[0])
    _assert_wkv_close(y, s_fin, y_r, s_r, (r, kk, vv, w, u[0]))
    n0 = rwkv_wkv.launches
    big = torch.zeros((1, 16, 1, 129), device=dev)
    with pytest.raises(ValueError):
        rwkv_wkv(big, big, big, big, big[0, 0])  # K > 128
    with pytest.raises(ValueError):
        rwkv_wkv(r.half(), kk, vv, w, u)
    with pytest.raises(ValueError):
        rwkv_wkv(r, kk, vv, w, u[:, :2])
    assert rwkv_wkv.launches == n0


@pytest.mark.cuda
def test_reduced_rwkv_on_the_kernels_matches_its_plain_versions(dev):
    """The reduced RWKV-6 model served on the card: prefill (rwkv_wkv,
    floatsd_matmul, qsigmoid on their kernels) and decode steps against
    backend="ref" on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import CausalLM
    from repro_torch.serving import WeightStore

    cfg = get_config("rwkv6_3b").reduced()
    model = CausalLM(cfg)
    pol = get_policy("floatsd8_table6").replace(weight_quant="none")
    tree = WeightStore.pack(model.init(_gen(dev, 3))).tree
    toks = torch.randint(0, cfg.vocab, (2, 32), device=dev, generator=_gen(dev, 4))
    kd.STATS.reset()
    with torch.no_grad():
        got = model.prefill(tree, {"tokens": toks}, pol)
        counts = kd.STATS.snapshot()
        with kd.use_backend("ref"):
            want = model.prefill(tree, {"tokens": toks}, pol)
        cache = model.init_cache(2, pol, dev)
        for t in range(4):
            lg, cache = model.decode_step(tree, toks[:, t:t + 1], cache, pol)
            torch.testing.assert_close(lg[:, 0], got[:, t], rtol=0, atol=1e-4 * float(got.abs().max()))
    torch.cuda.synchronize()
    assert counts == {("rwkv_wkv", "cuda"): 2, ("qsigmoid", "cuda"): 4, ("floatsd_matmul", "cuda"): 17}
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


# (B, Sq, Skv, H, Kh, D, causal, window, dtype): MHA; GQA G = 4 at D 120 with
# the window biting and a ragged S; MQA at S 1000 (ragged, D 128); no causal
# mask; bf16; more queries than keys under a window (rows 109.. admit no
# key: every tile runs and the row averages v, as the oracle's)
FLASH_SHAPES = [
    (2, 256, 256, 4, 4, 64, True, None, torch.float32),
    (2, 200, 200, 8, 2, 120, True, 64, torch.float32),
    (1, 1000, 1000, 4, 1, 128, True, 300, torch.float32),
    (2, 130, 130, 4, 1, 120, False, None, torch.float32),
    (1, 300, 300, 8, 2, 120, True, 100, torch.bfloat16),
    (1, 150, 70, 2, 1, 32, True, 40, torch.float32),
    # head sizes the kernel pads to its 64 or 128 (zeros past D), and the
    # dense model's heads (32 over 8, D 120) at its prefill length
    (2, 100, 100, 2, 1, 16, True, None, torch.float32),
    (1, 190, 190, 4, 2, 72, True, 50, torch.bfloat16),
    (2, 150, 150, 2, 2, 100, False, None, torch.float32),
    (1, 1024, 1024, 32, 8, 120, True, 4096, torch.float32),
]


def _flash_inputs(dev, b, sq, skv, h, kh, d, dtype, seed=0):
    g = _gen(dev, seed + sq * h + d)
    q = torch.randn((b, sq, h, d), device=dev, generator=g) * 2  # peaked attention
    k, v = (torch.randn((b, skv, kh, d), device=dev, generator=g) for _ in range(2))
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _flash_oracle(q, k, v, causal, window):
    """The [BH, S, D] oracle on the model layout, K and V expanded."""
    b, sq, h, d = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    ex = lambda t: t.repeat_interleave(g, dim=2).permute(0, 2, 1, 3).reshape(b * h, skv, d)  # noqa: E731
    o = flash_attention_ref(q.permute(0, 2, 1, 3).reshape(b * h, sq, d), ex(k), ex(v), causal, window)
    return o.reshape(b, h, sq, d).permute(0, 2, 1, 3)


def _assert_flash_close(got, want):
    rtol, atol = (2e-2, 6e-3) if want.dtype == torch.float32 else (3e-2, 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kh,d,causal,window,dtype", FLASH_SHAPES)
def test_flash_attention_kernel_matches_both_plain_versions(dev, b, sq, skv, h, kh, d, causal, window, dtype):
    q, k, v = _flash_inputs(dev, b, sq, skv, h, kh, d, dtype)
    n0 = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1 and o.shape == q.shape and o.dtype == dtype and o.is_contiguous()
    _assert_flash_close(o, _flash_oracle(q, k, v, causal, window))
    _assert_flash_close(o, flash_attention_gqa(q, k, v, causal=causal, window=window))
    o2 = flash_attention(q, k, v, causal=causal, window=window)  # a second launch: the same bits
    torch.cuda.synchronize()
    assert torch.equal(o, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d", [(1, 1024, 32, 8, 120), (2, 300, 4, 2, 64), (1, 500, 8, 1, 128)])
def test_flash_attention_f32_scores_keep_f32_precision(dev, b, s, h, kh, d):
    """The f32 precision control. The chunked plain version rounds p and v
    to bf16 as the kernel does, so against it only the scores differ: the
    kernel's max error must be at most a quarter of that of the same plain
    version run on q and k rounded to bf16 (a one-piece emulation), which a
    single bf16 pass of the scores would not meet."""
    q, k, v = _flash_inputs(dev, b, s, s, h, kh, d, torch.float32, seed=1)
    plain = flash_attention_gqa(q, k, v)
    one_piece = flash_attention_gqa(q.bfloat16().float(), k.bfloat16().float(), v)
    err = float((flash_attention(q, k, v) - plain).abs().max())
    assert err <= 0.25 * float((one_piece - plain).abs().max()), err


@pytest.mark.cuda
def test_flash_attention_reads_strided_inputs_and_raises(dev):
    """q, k, v read in place from a fused [B, S, (H + 2 Kh) D] projection
    (strided heads); an unsupported dtype, D or head split raises and
    launches nothing."""
    b, s, h, kh, d = 2, 77, 4, 2, 64
    qkv = torch.randn((b, s, (h + 2 * kh) * d), device=dev, generator=_gen(dev, 9))
    q = qkv[..., :h * d].view(b, s, h, d)
    k = qkv[..., h * d:(h + kh) * d].view(b, s, kh, d)
    v = qkv[..., (h + kh) * d:].view(b, s, kh, d)
    assert not q.is_contiguous()
    o = flash_attention(q, k, v, window=30)
    _assert_flash_close(o, flash_attention_gqa(q.contiguous(), k.contiguous(), v.contiguous(), window=30))
    n0 = flash_attention.launches
    with pytest.raises(ValueError, match="f32 or all bf16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q, k[..., :32], v[..., :32])  # D disagrees
    big = torch.zeros((1, 8, 1, 129), device=dev)
    with pytest.raises(ValueError):
        flash_attention(big, big, big)  # D > 128
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :3], k, v)  # 2 KV heads do not divide 3
    assert flash_attention.launches == n0


@pytest.mark.cuda
def test_dispatch_routes_flash_attention_to_the_kernel(dev):
    q, k, v = _flash_inputs(dev, 1, 64, 64, 4, 2, 32, torch.float32)
    kd.STATS.reset()
    o = kd.flash_attention(q, k, v, window=16)
    o_ref = kd.flash_attention(q, k, v, window=16, backend="ref")
    torch.cuda.synchronize()
    assert kd.STATS.snapshot() == {("flash_attention", "cuda"): 1, ("flash_attention", "ref"): 1}
    _assert_flash_close(o, o_ref)


@pytest.mark.cuda
def test_reduced_dense_on_the_kernels_matches_its_plain_versions(dev):
    """The reduced h2o_danube3_4b served on the card: the prefill (the
    window of 64 biting at S 96) with flash_attention and floatsd_matmul on
    their kernels against backend="ref" on the card, and its decode steps
    against the prefill, with no activation quantizer."""
    from repro_torch.configs import get_config
    from repro_torch.models import CausalLM
    from repro_torch.serving import WeightStore

    cfg = get_config("h2o_danube3_4b").reduced()
    model = CausalLM(cfg)
    pol = get_policy("fp32")
    tree = model.hoist(WeightStore.pack(model.init(_gen(dev, 3))).tree)
    toks = torch.randint(0, cfg.vocab, (2, 96), device=dev, generator=_gen(dev, 4))
    kd.STATS.reset()
    with torch.no_grad():
        got = model.prefill(tree, {"tokens": toks}, pol)
        counts = kd.STATS.snapshot()
        with kd.use_backend("ref"):
            want = model.prefill(tree, {"tokens": toks}, pol)
        scale = max(1.0, float(want.abs().max()))
        assert counts == {("flash_attention", "cuda"): 2, ("floatsd_matmul", "cuda"): 15}
        torch.testing.assert_close(got, want, rtol=0, atol=2.0 ** -8 * scale)
        cache = model.init_cache(2, pol, dev, cache_len=128)
        for t in range(70):
            lg, cache = model.decode_step(tree, toks[:, t:t + 1], cache, pol)
            torch.testing.assert_close(lg[:, 0], got[:, t], rtol=0, atol=1e-2 * scale)


# The redesigned element-wise kernels: the gate function's O(1) LUT index at
# its edges, qsigmoid's vector path at every alignment and ragged length,
# and both cells at a ragged H, an odd B * H and misaligned views.

def _qsig_x_edges(dev) -> torch.Tensor:
    """Every f32 within 256 ulps of each of the 84 x where sigma(-|x|)
    crosses a LUT midpoint, and 0, +-inf, NaN."""
    from repro_torch.core.qsigmoid import sigmoid_lut_values

    grid = torch.as_tensor(sigmoid_lut_values(), dtype=torch.float64)
    mids = ((grid[1:] + grid[:-1]) / 2).float().double()
    xm = torch.log(1.0 / mids - 1.0).float()  # sigma(-xm) = mid
    steps = torch.arange(-256, 257, dtype=torch.int64)
    xs = (xm.view(torch.int32).long()[:, None] + steps).to(torch.int32).view(torch.float32).reshape(-1)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan")])
    assert mids.numel() == 42
    return torch.cat([xs, -xs, special]).to(dev)


@pytest.mark.cuda
def test_qsigmoid_kernel_bit_for_bit_around_every_midpoint_crossing(dev):
    x = _qsig_x_edges(dev)
    n0 = qsigmoid.launches
    got = qsigmoid(x)
    torch.cuda.synchronize()
    assert qsigmoid.launches == n0 + 1
    assert torch.equal(got, qsigmoid_raw(x))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 7, 4099, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_qsigmoid_kernel_at_any_start_offset_and_ragged_length(dev, offset, n, dtype):
    """A view that starts 1-3 elements past a 16-byte boundary: the head,
    the vectors and the ragged tail. f32 bit for bit with the plain version;
    fp16/bf16 equal to the f32 kernel on the widened input, rounded back."""
    base = (torch.randn(n + 8, device=dev, generator=_gen(dev, n + offset)) * 4).to(dtype)
    x = base[offset:offset + n]
    assert x.data_ptr() % 16 != 0
    got = qsigmoid(x)
    want = qsigmoid_raw(x) if dtype == torch.float32 else qsigmoid(x.float()).to(dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_qsigmoid_kernel_on_every_16_bit_pattern(dev, dtype):
    x = torch.arange(-2**15, 2**15, dtype=torch.int32, device=dev).to(torch.int16).view(dtype)
    got = qsigmoid(x)
    want = qsigmoid(x.float()).to(dtype)
    torch.cuda.synchronize()
    assert got.numel() == 65536 and torch.equal(got, want)


def _odd_view(t: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """t's values in a contiguous view that starts `offset` elements into a
    larger buffer (not 16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    v = buf[offset:].view(t.shape)
    v.copy_(t)
    return v


# a ragged H (no vector width divides it), B * H odd, and the train step's
# width with the cell state at an odd fp16 offset, as cs_prev[t] can be
CELL_EDGE_SHAPES = [(64, 1023), (3, 1023), (5, 333), (64, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", CELL_EDGE_SHAPES)
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("c_dtype", [torch.float16, torch.float32])
def test_lstm_cell_grad_kernel_at_ragged_h_and_a_misaligned_cell_state(dev, b, h, quantized, c_dtype):
    g = _gen(dev, b * h + 2)
    z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
    c = _odd_view(torch.randn((b, h), device=dev, generator=g).to(torch.float16).to(c_dtype))
    dh, dc = (torch.randn((b, h), device=dev, generator=g) for _ in range(2))
    n0 = lstm_cell_grad.launches
    dz_k, dcp_k = lstm_cell_grad(z, c, dh, dc, quantized=quantized, c_dtype=c_dtype)
    dz_2, dcp_2 = lstm_cell_grad(z, c, dh, dc, quantized=quantized, c_dtype=c_dtype)
    dz_r, dcp_r = lstm_cell_bwd_ref(z, c.float(), dh, dc, quantized, c_dtype=c_dtype)
    torch.cuda.synchronize()
    assert lstm_cell_grad.launches == n0 + 2
    assert torch.equal(dz_k, dz_r) and torch.equal(dcp_k, dcp_r)
    assert torch.equal(dz_k, dz_2) and torch.equal(dcp_k, dcp_2)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [True, False])
def test_lstm_cell_grad_kernel_with_every_input_misaligned(dev, quantized):
    """z, dh and dc one f32 past a 16-byte boundary: the scalar path."""
    b, h = 64, 1024
    g = _gen(dev, 11)
    z = _odd_view(torch.randn((b, 4 * h), device=dev, generator=g) * 2)
    c = _odd_view(torch.randn((b, h), device=dev, generator=g).to(torch.float16), 3)
    dh, dc = (_odd_view(torch.randn((b, h), device=dev, generator=g)) for _ in range(2))
    dz_k, dcp_k = lstm_cell_grad(z, c, dh, dc, quantized=quantized)
    dz_r, dcp_r = lstm_cell_bwd_ref(z, c.float(), dh, dc, quantized)
    torch.cuda.synchronize()
    assert torch.equal(dz_k, dz_r) and torch.equal(dcp_k, dcp_r)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", CELL_EDGE_SHAPES)
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("c_dtype", [torch.float16, torch.float32])
def test_lstm_cell_kernel_at_ragged_h_and_a_misaligned_cell_state(dev, b, h, quantized, c_dtype):
    g = _gen(dev, b * h + 3)
    z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
    c = _odd_view(torch.randn((b, h), device=dev, generator=g).to(c_dtype))
    n0 = lstm_cell.launches
    h_k, c_k = lstm_cell(z, c, quantized=quantized, c_dtype=c_dtype)
    h_r, c_r = lstm_cell_ref(z, c, quantized, c_dtype=c_dtype)
    torch.cuda.synchronize()
    assert lstm_cell.launches == n0 + 1
    assert torch.equal(h_k, h_r) and torch.equal(c_k, c_r)


# the cell's grid is (B rows, 128-column blocks): one row, fewer columns
# than a block, a ragged last block, and the decode and train widths
CELL_GRID_SHAPES = [(1, 1024), (1, 100), (7, 64), (1, 1023), (64, 1023), (64, 1024), (8, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h", CELL_GRID_SHAPES)
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("c_in", [torch.float16, torch.float32])
@pytest.mark.parametrize("c_out", [torch.float16, torch.float32])
def test_lstm_cell_kernel_on_its_grid_bit_for_bit(dev, b, h, quantized, c_in, c_out):
    """Every (cell-in, cell-out) dtype pair and both instantiations of the
    quantizer, with c_prev at 0, 1 and 3 elements past a 16-byte boundary;
    two launches bit-identical."""
    g = _gen(dev, b * h + 5)
    z = torch.randn((b, 4 * h), device=dev, generator=g) * 2
    z.view(-1)[:6] = torch.tensor([0.0, -0.0, 30.0, -30.0, 1e-30, -1e-30], device=dev)
    c0 = torch.randn((b, h), device=dev, generator=g).to(c_in)
    for offset in (0, 1, 3):
        c = _odd_view(c0, offset) if offset else c0
        n0 = lstm_cell.launches
        h_k, c_k = lstm_cell(z, c, quantized=quantized, c_dtype=c_out)
        h_2, c_2 = lstm_cell(z, c, quantized=quantized, c_dtype=c_out)
        h_r, c_r = lstm_cell_ref(z, c, quantized, c_dtype=c_out)
        torch.cuda.synchronize()
        assert lstm_cell.launches == n0 + 2 and c_k.dtype == c_out
        assert torch.equal(h_k, h_r) and torch.equal(c_k, c_r), offset
        assert torch.equal(h_k, h_2) and torch.equal(c_k, c_2)


QUANT_LENGTHS = [1, 2, 15, 16, 17, 31, 33, 255, 4099, 65_537, 1_000_003]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", range(1, 16))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_quantize_kernel_at_any_start_offset_and_ragged_length(dev, offset, dtype):
    """Views that start 1-15 elements past a 16-element boundary, of every
    length from one element (all head) to a million and three (head, groups
    and a ragged tail): byte for byte with encode, the codes placed at x's
    offset modulo 16, two launches bit-identical."""
    g = _gen(dev, 31 + offset)
    for n in QUANT_LENGTHS:
        base = (torch.randn(n + 16, device=dev, generator=g) * 0.05).to(dtype)
        x = base[offset:offset + n]
        bias = floatsd.fit_bias(x)
        n0 = floatsd_quantize.launches
        got, again = floatsd_quantize(x, bias), floatsd_quantize(x, bias)
        want = floatsd.encode(x, bias)[0]
        torch.cuda.synchronize()
        assert floatsd_quantize.launches == n0 + 2
        assert got.shape == x.shape and got.dtype == torch.uint8
        assert got.data_ptr() % 16 == x.data_ptr() // x.element_size() % 16
        assert torch.equal(got, want), n
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [-126, -7, 0, 120])
def test_quantize_kernel_on_every_finite_fp16_pattern(dev, bias):
    x = torch.arange(-2**15, 2**15, dtype=torch.int32, device=dev).to(torch.int16).view(torch.float16)
    x = x[torch.isfinite(x)]
    got = floatsd_quantize(x, bias)
    want = floatsd.encode(x, bias)[0]
    torch.cuda.synchronize()
    assert x.numel() == 65536 - 2048 and torch.equal(got, want)


@pytest.mark.cuda
def test_quantize_kernel_reads_the_bias_on_the_device(dev):
    """A device int32 bias (read by the kernel, clamped to [-126, 120] as
    encode clamps it) gives the codes of the same host int."""
    x = torch.randn((333, 77), device=dev, generator=_gen(dev, 41)) * 3
    for b in (-200, -126, -7, 0, 1, 120, 127, 300):
        dev_bias = torch.tensor(b, dtype=torch.int32, device=dev)
        got = floatsd_quantize(x * 2.0 ** max(-120, min(120, b)), dev_bias)
        host = floatsd_quantize(x * 2.0 ** max(-120, min(120, b)), b)
        want = floatsd.encode(x * 2.0 ** max(-120, min(120, b)), b)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(host, want), b


# ---------------------------------------------------------------------------
# the training runtime on the card: save-z, the training ops, telemetry, the
# matmul_dw flush hook, the pipeline and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "reverse", "masked", "fp16-cell"])
@pytest.mark.parametrize("b", [4, 128])
def test_save_z_gives_remat_gradients_bit_for_bit_on_the_kernels(dev, variant, b):
    from repro_torch.nn import lstm as lstm_mod

    pol = get_policy("floatsd8_table6" if variant == "fp16-cell" else "floatsd8_table2")
    pol = pol.replace(grad_quant="fp8_kernel")
    out, old = {}, lstm_mod.BPTT_REMAT
    try:
        for remat in (True, False):
            lstm_mod.BPTT_REMAT = remat
            g = _gen(dev, 51)
            layer = LSTMLayer(96, 80, reverse=variant == "reverse")
            p = {k: v.to(pol.mdt()).requires_grad_() for k, v in layer.init(g).items()}
            xs = torch.randn((b, 7, 96), device=dev, generator=g).requires_grad_()
            lens = torch.randint(1, 8, (b,), device=dev, generator=g) if variant == "masked" else None
            n0 = floatsd_matmul.launches
            h, fin = layer.apply(p, xs, pol, lengths=lens)
            (h.float().square().sum() + fin.c.float().square().sum()).backward()
            out[remat] = ([h, fin.h, fin.c, xs.grad, *(p[k].grad for k in ("wx", "wh", "b"))],
                          floatsd_matmul.launches - n0)
    finally:
        lstm_mod.BPTT_REMAT = old
    torch.cuda.synchronize()
    for a, c in zip(out[True][0], out[False][0]):
        assert torch.equal(a.detach(), c.detach())
    assert out[True][1] == 2 * 7 + 2 and out[False][1] == 2 * 7


@pytest.mark.cuda
def test_train_matmul_and_lstm_cell_train_match_their_plain_versions(dev):
    g = _gen(dev, 52)
    x = quantize_fp8(torch.randn((64, 1024), device=dev, generator=g))
    w = (torch.randn((1024, 4096), device=dev, generator=g) * 0.03).requires_grad_()
    res = {}
    for backend in (None, "ref"):
        xr = x.clone().requires_grad_()
        w.grad = None
        with kd.use_backend(backend):
            y = kd.train_matmul(xr, w, kd.hoist_train(w))
        (y * 1e-2).square().sum().backward()
        res[backend] = (y.detach(), xr.grad, w.grad.clone())
    torch.cuda.synchronize()
    assert torch.equal(res[None][0], res["ref"][0])  # route A on FP8 activations: exact products
    gy = 2e-4 * res["ref"][0]
    wd = kd.hoist_train(w.detach(), backend="ref").dense
    bound = 1e-5 * (gy.double().abs() @ wd.double().abs().t())
    assert bool(((res[None][1].double() - res["ref"][1].double()).abs() <= bound + 1e-30).all())
    off = res[None][2] != res["ref"][2]
    assert int(off.sum()) <= 1e-3 * off.numel()
    z = torch.randn((64, 4096), device=dev, generator=g) * 2
    c = torch.randn((64, 1024), device=dev, generator=g).to(torch.float16)
    a1, a2 = torch.randn((2, 64, 1024), device=dev, generator=g)
    cell = {}
    for backend in (None, "ref"):
        zr, cr = z.clone().requires_grad_(), c.clone().requires_grad_()
        h, c2 = kd.lstm_cell_train(zr, cr, backend=backend)
        ((h * a1).sum() + (c2.float() * a2).sum()).backward()
        cell[backend] = (h.detach(), c2.detach(), zr.grad, cr.grad)
    torch.cuda.synchronize()
    for a, b in zip(cell[None], cell["ref"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_train_step_telemetry_on_the_kernels_equals_the_plain_path(dev):
    from repro_torch.obs import telemetry

    model = WikiText2LM(vocab=512, emb=64, hidden=64, n_layers=2)
    pol, opt = get_policy("floatsd8_table6"), sgd(0.9)
    state = init_state(model.init(_gen(dev, 53)), opt, pol)
    batch = batch_to_device(next(synthetic.wikitext2(batch=8, seq=12, vocab=512).batches), dev)
    step = make_train_step(model.loss, opt, pol, lr=0.5, telemetry=True)
    n0 = floatsd_quantize.launches
    _, m = step(state, batch)
    quants = floatsd_quantize.launches - n0
    with kd.use_backend("ref"):
        _, m_ref = step(state, batch)
    torch.cuda.synchronize()
    assert quants == 2 * sum(p.ndim >= 2 for p in tree_leaves(state.params))
    for k in ("fp8_sat_frac", "fp8_underflow_frac", "fp8_zero_frac", "sd_carry_frac", "sd_clamp_frac"):
        assert float(m["tel"][k]) == float(m_ref["tel"][k]), k
    for k, v in m_ref["tel"]["grad_norm"].items():
        assert float(m["tel"]["grad_norm"][k]) == float(v), k
    assert 0 < float(m["tel"]["sd_carry_frac"]) < 1 and telemetry.KERNEL_STATS.snapshot() == {}


@pytest.mark.cuda
def test_matmul_dw_flush_hook_on_the_kernel(dev):
    from repro_torch.obs import telemetry

    g = _gen(dev, 54)
    x = quantize_fp8(torch.randn((3072, 256), device=dev, generator=g)) * 30
    gr = torch.randn((3072, 512), device=dev, generator=g) * 1e-2
    gr[:, :8] *= 1e4
    gr[:, 8:40] *= 1e-6
    telemetry.KERNEL_STATS.reset()
    telemetry.KERNEL_STATS.enable()
    try:
        dw = kd.matmul_dw(x, gr)
        snap = telemetry.KERNEL_STATS.snapshot()
    finally:
        telemetry.KERNEL_STATS.disable()
        telemetry.KERNEL_STATS.reset()
    d = snap["floatsd_matmul_dw"]
    assert d["calls"] == 1 and d["elems"] == dw.numel()
    assert d["saturated"] == int((dw.abs() >= 57344).sum()) > 0
    assert d["zeros"] == int((dw == 0).sum()) > 0


@pytest.mark.cuda
def test_pipeline_and_checkpoints_on_the_card(dev, tmp_path):
    from repro_torch.data.pipeline import ShardedPipeline
    from repro_torch.distributed import checkpointing

    src = [{"tokens": np.full((4, 5), i, np.int32)} for i in range(6)]
    got = list(ShardedPipeline(iter(src), dev))
    assert [int(b["tokens"][0, 0]) for b in got] == list(range(6))
    assert all(b["tokens"].device.type == "cuda" and b["tokens"].dtype == torch.int64 for b in got)
    model = WikiText2LM(vocab=128, emb=32, hidden=32, n_layers=2)
    state = init_state(model.init(_gen(dev, 55)), sgd(0.9), get_policy("floatsd8_table6"))
    mgr = checkpointing.CheckpointManager(str(tmp_path), keep=2)
    mgr.save(state, 4)
    restored, step = mgr.restore(state)
    assert step == 4
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
