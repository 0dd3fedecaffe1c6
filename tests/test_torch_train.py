"""The port's training slice against the JAX package, on the CPU.

The same seeded numpy inputs (or JAX's own init, carried over by
``repro_torch.bridge``) go through ``repro`` on its reference path (the
``auto`` backend resolves to the jnp oracles off a TPU; no Pallas kernel
runs here) and through the port's plain versions.

Tolerances:
  * ``act_quant`` (forward and gradient), ``quantize_ste``, ``grad_quant``,
    the loss-scaling functions and the synthetic batches: bit-identical;
  * ``lstm_cell_bwd_ref``: rtol 1e-5, atol 1e-6, with at most 0.5% of
    elements outside it (torch's and XLA's sigmoid/tanh differ by an ulp on
    some inputs, and an ulp across a LUT or e5m2 boundary is a real step);
  * ``matmul_dx_ref`` / ``matmul_dw_ref(quant=False)``: within 1e-5 of the
    sum of term magnitudes (f32 sums in another order); ``quant=True``:
    equal except at most 0.1% of elements, each one e5m2 step apart;
  * the fused layer (forward h and dWx / dWh / db): rtol 2e-3, atol 1e-5
    under floatsd8_table2 (the JAX package's own kernel-vs-reference
    bound), cosine > 0.999 under floatsd8_table6 (fp16 cell state);
  * the training forward equals the port's inference forward on the same
    packed weights bit for bit;
  * one scaled backward of the whole model: every master gradient within
    cosine 0.9999 and 0.1% relative L2 of JAX's;
  * a 20-step loss trajectory within 1e-3 relative of JAX's
    ``make_train_step`` at every step (the JAX package's ref-vs-kernel
    trajectory bound), and the trained masters within 0.1% (relative L2)
    of JAX's change to them, every leaf;
  * checkpoints both ways: arrays equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import floatsd as jfsd  # noqa: E402
from repro.core import fp8 as jfp8  # noqa: E402
from repro.core import loss_scaling as jls  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.distributed import checkpointing  # noqa: E402
from repro.kernels.floatsd_matmul.bwd import matmul_dw_ref as jdw_ref  # noqa: E402
from repro.kernels.floatsd_matmul.bwd import matmul_dx_ref as jdx_ref  # noqa: E402
from repro.kernels.lstm_cell.bwd import lstm_cell_bwd_ref as jcell_bwd  # noqa: E402
from repro.models.lstm_models import WikiText2LM as JLM  # noqa: E402
from repro.nn.lstm import LSTMLayer as JLayer  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim import train_state as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch._tree import tree_leaves  # noqa: E402
from repro_torch.core import floatsd as tfsd  # noqa: E402
from repro_torch.core import fp8 as tfp8  # noqa: E402
from repro_torch.core import loss_scaling as tls  # noqa: E402
from repro_torch.core.policy import get_policy as tget_policy  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.distributed import checkpointing as tckpt  # noqa: E402
from repro_torch.kernels import dispatch as tkd  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ops import matmul_dw, matmul_dx  # noqa: E402
from repro_torch.kernels.floatsd_matmul.ref import matmul_dw_ref, matmul_dx_ref  # noqa: E402
from repro_torch.kernels.lstm_cell.ops import lstm_cell_grad  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_bwd_ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import WikiText2LM as TLM  # noqa: E402
from repro_torch.models.lm import cross_entropy, mask_padded_vocab  # noqa: E402
from repro_torch.models.task_zoo import make_task  # noqa: E402
from repro_torch.nn.lstm import LSTMLayer as TLayer  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.optim import train_state as tts  # noqa: E402

JT2, JT6 = jget_policy("floatsd8_table2"), jget_policy("floatsd8_table6")
TT2, TT6 = tget_policy("floatsd8_table2"), tget_policy("floatsd8_table6")
DTYPES = {"e5m2": (jnp.float8_e5m2, torch.float8_e5m2), "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "fp16": (jnp.float16, torch.float16), None: (None, None)}


def _special(rng, shape, scale=1.0):
    """Gaussian values with overflow, ties, inf and NaN mixed in."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32).ravel()
    x[:6] = [np.inf, -np.inf, np.nan, 1e6, -7e4, 0.0]
    return x.reshape(shape)


def _fp16(x):
    with np.errstate(over="ignore"):  # finite overflow to inf is part of the input
        return x.astype(np.float16)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# core: quantization nodes and loss scaling, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fwd,bwd", [("e5m2", "e5m2"), ("fp16", "e5m2"), (None, "e5m2"),
                                     ("e4m3", None)])
def test_act_quant_forward_and_gradient_bit_identical(fwd, bwd):
    rng = np.random.default_rng(1)
    x, g = _special(rng, (7, 33), 300.0), _special(rng, (7, 33), 1e4)
    (jf, tf), (jb, tb) = DTYPES[fwd], DTYPES[bwd]
    y_j, vjp = jax.vjp(lambda v: jfp8.act_quant(v, jf, jb), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    y_t = tfp8.act_quant(xt, tf, tb)
    y_t.backward(torch.from_numpy(g))
    _equal(y_t.detach().numpy(), y_j)
    _equal(xt.grad.numpy(), gx_j)


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_quantize_ste_bit_identical_with_identity_gradient(dtype):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((40, 24)) * 0.07).astype(dtype)
    bias = jfsd.fit_bias(jnp.asarray(w))
    y_j, vjp = jax.vjp(lambda v: jfsd.quantize_ste(v, bias), jnp.asarray(w))
    g = rng.standard_normal(w.shape).astype(dtype)
    wt = torch.from_numpy(w).requires_grad_()
    y_t = tfsd.quantize_ste(wt, tfsd.fit_bias(wt.detach()))
    y_t.backward(torch.from_numpy(g))
    assert y_t.dtype == wt.dtype
    _equal(y_t.detach().numpy(), y_j)
    _equal(wt.grad.numpy(), vjp(jnp.asarray(g))[0])
    _equal(wt.grad.numpy(), g)


def test_grad_quant_bit_identical():
    rng = np.random.default_rng(3)
    tree = {"a": _fp16(_special(rng, (9, 5), 1e4)),
            "b": {"c": _special(rng, (13,), 3e4)}}
    want = jfp8.grad_quant(jax.tree_util.tree_map(jnp.asarray, tree))
    got = tfp8.grad_quant({"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}})
    assert got["a"].dtype == torch.float16
    _equal(got["a"].numpy(), want["a"])
    _equal(got["b"]["c"].numpy(), want["b"]["c"])


def _ls_equal(t: tls.LossScaleState, j: jls.LossScaleState):
    for name in tls.LossScaleState._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)


def test_loss_scaling_bit_identical():
    rng = np.random.default_rng(4)
    g = {"w": (rng.standard_normal((6, 7)) * 3e3).astype(np.float16),
         "b": (rng.standard_normal(7) * 1e3).astype(np.float32)}
    gt = {k: torch.from_numpy(v) for k, v in g.items()}
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    for tst, jst in [(tls.static_init(1024.0), jls.static_init(1024.0)),
                     (tls.dynamic_init(), jls.dynamic_init())]:
        _ls_equal(tst, jst)
        loss = np.float32(3.25)
        _equal(tls.scale_loss(torch.tensor(loss), tst).numpy(), jls.scale_loss(jnp.asarray(loss), jst))
        ut, ft = tls.unscale_and_check(gt, tst)
        uj, fj = jls.unscale_and_check(gj, jst)
        assert bool(ft) == bool(fj) is True
        for k in g:
            assert ut[k].dtype == gt[k].dtype
            _equal(ut[k].numpy(), uj[k])
        bad = dict(gt, b=torch.tensor([np.inf] * 7, dtype=torch.float32))
        assert not bool(tls.unscale_and_check(bad, tst)[1])
        # a run of finite/nonfinite steps through adjust, growth included
        for fin in [True, False, True, True, False, True]:
            tst = tls.adjust(tst, torch.tensor(fin), growth_interval=2)
            jst = jls.adjust(jst, jnp.asarray(fin), growth_interval=2)
            _ls_equal(tst, jst)


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
def test_sgd_updates_bit_identical(momentum, nesterov):
    """Three updates from fp16 gradients: f32 momentum and f32 updates,
    each op rounding on its own in both packages."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((6, 7)).astype(np.float16)}
    topt, jopt = tsgd(momentum, nesterov), jsgd(momentum, nesterov)
    tst = topt.init({k: torch.from_numpy(v) for k, v in params.items()})
    jst = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    for _ in range(3):
        g = {"w": (rng.standard_normal((6, 7)) * 0.1).astype(np.float16)}
        tu, tst = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, tst, None, 0.5)
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, None, 0.5)
        assert tu["w"].dtype == torch.float32
        _equal(tu["w"].numpy(), ju["w"])
        if momentum:
            _equal(tst["w"].numpy(), jst["w"])


def test_synthetic_wikitext2_batches_identical():
    for kw in [dict(batch=4, seq=9, vocab=128, seed=0), dict(batch=3, seq=5, vocab=33278)]:
        j, t = jsyn.wikitext2(**kw), tsyn.wikitext2(**kw)
        assert (t.name, t.vocab, t.n_labels) == (j.name, j.vocab, j.n_labels)
        for stream in ("batches", "eval_batches"):
            for _ in range(3):
                bj, bt = next(getattr(j, stream)), next(getattr(t, stream))
                assert bj.keys() == bt.keys()
                for k in bj:
                    assert bt[k].dtype == bj[k].dtype
                    np.testing.assert_array_equal(bt[k], bj[k])


def test_cross_entropy_and_vocab_mask_match_jax():
    from repro.models.lm import cross_entropy as jce
    from repro.models.lm import mask_padded_vocab as jmask

    rng = np.random.default_rng(5)
    lg = (rng.standard_normal((3, 4, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (3, 4)).astype(np.int32)
    mask = (rng.random((3, 4)) < 0.7).astype(np.int32)
    mt, mj = mask_padded_vocab(torch.from_numpy(lg), 37), jmask(jnp.asarray(lg), 37)
    _equal(mt.numpy(), mj)
    for mk in (None, mask):
        lt = torch.from_numpy(lg).requires_grad_()
        vt = cross_entropy(mask_padded_vocab(lt, 37), torch.from_numpy(labels),
                           None if mk is None else torch.from_numpy(mk))
        vt.backward()
        vj, gj = jax.value_and_grad(lambda v: jce(jmask(v, 37), jnp.asarray(labels), mk))(jnp.asarray(lg))
        np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-6)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-7)


def test_weight_site_dw_rounds_once_to_bf16_as_xla_does():
    """With gradient quantization on, a dense weight site emits dW through
    bf16. XLA on the CPU computes that dot (preferred_element_type=bf16)
    in f32 and rounds once to bf16 (its HLO is an f32 dot and a convert);
    the port does the same. The two f32 sums differ only in order, so the
    bf16 values agree except where that order moves a rounding tie: at most
    1% of elements, one bf16 step apart."""
    from repro.nn.linear import _make_einsum_gc

    from repro_torch.nn.linear import policy_einsum

    rng = np.random.default_rng(12)
    eq = "...d,vd->...v"
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    g = rng.standard_normal((3, 5, 40)).astype(np.float32)
    f = _make_einsum_gc(eq)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    f32 = jnp.einsum("...d,...v->vd", jnp.asarray(x), jnp.asarray(g), preferred_element_type=jnp.float32)
    _equal(dw_j, f32.astype(jnp.bfloat16).astype(jnp.float32))  # XLA: one rounding
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    policy_einsum(eq, xt, wt, TT6).backward(torch.from_numpy(g))
    t32 = torch.einsum("...d,...v->vd", torch.from_numpy(x), torch.from_numpy(g))
    _equal(wt.grad.numpy(), t32.to(torch.bfloat16).float().numpy())  # the port: one rounding
    dw_j = np.asarray(dw_j)
    off = wt.grad.numpy() != dw_j
    assert off.sum() <= 0.01 * off.size
    assert np.all(np.abs(wt.grad.numpy() - dw_j)[off] <= 2.0 ** (np.floor(np.log2(np.abs(dw_j[off]))) - 7))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# kernels: the plain backward versions against the JAX oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h", [(5, 200), (8, 128)])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("c_dtype", [np.float16, np.float32])
def test_lstm_cell_bwd_ref_matches_jax(b, h, quantized, c_dtype):
    rng = np.random.default_rng(b * h)
    z = (rng.standard_normal((b, 4 * h)) * 2).astype(np.float32)
    c = rng.standard_normal((b, h)).astype(np.float32)
    dh, dc = rng.standard_normal((b, h)).astype(np.float32), rng.standard_normal((b, h)).astype(np.float32)
    dz_j, dcp_j = jax.jit(jcell_bwd, static_argnums=(4, 5))(*map(jnp.asarray, (z, c, dh, dc)),
                                                            quantized, jnp.dtype(c_dtype))
    tdt = torch.float16 if c_dtype == np.float16 else torch.float32
    dz_t, dcp_t = lstm_cell_bwd_ref(*map(torch.from_numpy, (z, c, dh, dc)), quantized, c_dtype=tdt)
    assert dz_t.dtype == torch.float32 and dcp_t.dtype == torch.float32
    for got, want in [(dz_t.numpy(), np.asarray(dz_j)), (dcp_t.numpy(), np.asarray(dcp_j))]:
        off = np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)
        assert off.sum() <= 0.005 * want.size, (off.sum(), want.size)


def _bwd_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    codes, bias = jfsd.encode(jnp.asarray((rng.standard_normal((k, n)) * 0.05).astype(np.float32)))
    return x, g, np.array(codes), int(bias)


@pytest.mark.parametrize("m,k,n", [(6, 20, 28), (24, 64, 256)])
def test_matmul_dx_ref_matches_jax(m, k, n):
    _, g, codes, bias = _bwd_inputs(m, k, n, m + k)
    want = np.asarray(jax.jit(jdx_ref)(jnp.asarray(g), jnp.asarray(codes), bias))
    got = matmul_dx_ref(torch.from_numpy(g), torch.from_numpy(codes), bias).numpy()
    w = np.abs(np.asarray(jfsd.decode(jnp.asarray(codes), bias)).astype(np.float64))
    assert got.shape == (m, k)
    assert np.all(np.abs(got - want) <= 1e-5 * (np.abs(g).astype(np.float64) @ w.T) + 1e-30)


def _e5m2_step(v):
    """The spacing of the e5m2 grid at |v| (2 mantissa bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0**-14)))
    return 2.0 ** (e - 2)


@pytest.mark.parametrize("m,k,n", [(36, 12, 64), (72, 70, 280)])
def test_matmul_dw_ref_matches_jax(m, k, n):
    x, g, _, _ = _bwd_inputs(m, k, n, m * k)
    x[0, 0] = 1e6  # saturates a row of dw at +-57344
    bound = 1e-5 * (np.abs(x).T.astype(np.float64) @ np.abs(g)) + 1e-30
    raw = matmul_dw_ref(torch.from_numpy(x), torch.from_numpy(g), quant=False).numpy()
    assert np.all(np.abs(raw - np.asarray(jdw_ref(jnp.asarray(x), jnp.asarray(g), quant=False))) <= bound)
    got = matmul_dw_ref(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    want = np.asarray(jdw_ref(jnp.asarray(x), jnp.asarray(g)))
    assert np.abs(got).max() == 57344.0
    off = got != want
    assert off.sum() <= 0.001 * got.size
    assert np.all(np.abs(got - want)[off] <= _e5m2_step(np.maximum(np.abs(got), np.abs(want)))[off])


def test_backward_wrappers_take_plain_versions_on_cpu():
    x, g, codes, bias = _bwd_inputs(8, 16, 64, 9)
    z = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    c16 = torch.zeros((8, 16), dtype=torch.float16)
    n0 = (matmul_dx.launches, matmul_dw.launches, lstm_cell_grad.launches)
    gt, ct, xt = torch.from_numpy(g), torch.from_numpy(codes), torch.from_numpy(x)
    assert torch.equal(matmul_dx(gt, ct, bias), matmul_dx_ref(gt, ct, bias))
    assert torch.equal(matmul_dw(xt, gt[:, :16]), matmul_dw_ref(xt, gt[:, :16]))
    dz, dcp = lstm_cell_grad(torch.from_numpy(z), c16, gt[:, :16], gt[:, 16:32])
    rz, rc = lstm_cell_bwd_ref(torch.from_numpy(z), c16.float(), gt[:, :16], gt[:, 16:32])
    assert torch.equal(dz, rz) and torch.equal(dcp, rc) and dcp.dtype == torch.float32
    assert (matmul_dx.launches, matmul_dw.launches, lstm_cell_grad.launches) == n0


def test_dispatch_training_ops_record_and_hoist():
    x, g, codes, bias = _bwd_inputs(8, 16, 64, 10)
    tkd.STATS.reset()
    w = torch.from_numpy(np.array(jfsd.decode(jnp.asarray(codes), bias)))
    hw = tkd.hoist_train(w)
    assert torch.equal(hw.codes, torch.from_numpy(codes)) and hw.bias == bias
    assert torch.equal(hw.dense, w)  # decode(encode(w)) == w for grid values
    gt = torch.from_numpy(g)
    assert torch.equal(tkd.matmul_dx(gt, hw.codes, hw.bias, dense=hw.dense),
                       tkd.matmul_dx(gt, hw.codes, hw.bias))
    tkd.matmul_dw(torch.from_numpy(x), gt)
    tkd.lstm_cell_grad(gt, torch.zeros(8, 16), torch.zeros(8, 16), torch.zeros(8, 16))
    assert tkd.STATS.count("floatsd_matmul_dx", "ref") == 2
    assert tkd.STATS.count("floatsd_matmul_dw", "ref") == 1
    assert tkd.STATS.count("lstm_cell_grad", "ref") == 1
    assert tkd.STATS.count(backend="cuda") == 0
    with pytest.raises(ValueError):
        tkd.matmul_dw(torch.from_numpy(x), gt[:4])


# ---------------------------------------------------------------------------
# the fused layer
# ---------------------------------------------------------------------------


def _layer_case(hidden, seed=0):
    layer = JLayer(12, hidden)
    pj = layer.init(jax.random.PRNGKey(seed))
    xs = np.random.default_rng(seed + 1).standard_normal((4, 9, 12)).astype(np.float32)
    return layer, pj, xs


def _jax_layer(layer, pj, xs, pol):
    def loss(p):
        h, fin = layer.apply(p, jnp.asarray(xs), pol.replace(grad_quant="fp8_kernel"))
        return jnp.sum(h.astype(jnp.float32) ** 2) + jnp.sum(fin.c.astype(jnp.float32) ** 2), h

    (_, h), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(pj)
    return np.asarray(h), {k: np.asarray(v, np.float32) for k, v in g.items()}


def _port_layer(hidden, pj, xs, pol):
    p = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in pj.items()}
    h, fin = TLayer(12, hidden).apply(p, torch.from_numpy(xs), pol.replace(grad_quant="fp8_kernel"))
    (h.float().square().sum() + fin.c.float().square().sum()).backward()
    return h.detach().numpy(), {k: v.grad.float().numpy() for k, v in p.items()}


@pytest.mark.parametrize("hidden", [16, 70])
def test_fused_layer_matches_jax_table2(hidden):
    layer, pj, xs = _layer_case(hidden)
    h_j, g_j = _jax_layer(layer, pj, xs, JT2)
    tkd.STATS.reset()
    h_t, g_t = _port_layer(hidden, pj, xs, TT2)
    np.testing.assert_allclose(h_t, h_j, rtol=2e-3, atol=1e-5)
    for k in ("wx", "wh", "b"):
        np.testing.assert_allclose(g_t[k], g_j[k], rtol=2e-3, atol=1e-5, err_msg=k)
    # the engine's calls: S steps x 2 matmuls + the remat pair, S cells and
    # cell backwards, S + 1 dx (recurrence + batched dXs), 2 dw
    s = xs.shape[1]
    assert tkd.STATS.snapshot() == {
        ("floatsd_matmul", "ref"): 2 * s + 2, ("lstm_cell", "ref"): s,
        ("lstm_cell_grad", "ref"): s, ("floatsd_matmul_dx", "ref"): s + 1,
        ("floatsd_matmul_dw", "ref"): 2,
    }


def test_fused_layer_matches_jax_table6_fp16_cell():
    layer, pj, xs = _layer_case(16)
    h_j, g_j = _jax_layer(layer, {k: v.astype(jnp.float16) for k, v in pj.items()}, xs, JT6)
    h_t, g_t = _port_layer(16, {k: np.asarray(v, np.float16) for k, v in pj.items()}, xs, TT6)
    np.testing.assert_allclose(h_t, h_j, rtol=2e-3, atol=1e-5)
    for k in ("wx", "wh", "b"):
        a, c = g_j[k].ravel(), g_t[k].ravel()
        cos = np.dot(a, c) / max(np.linalg.norm(a) * np.linalg.norm(c), 1e-12)
        assert cos > 0.999, (k, cos)


def test_training_forward_equals_inference_forward_bitwise():
    layer, pj, xs = _layer_case(16, seed=3)
    p = {k: torch.from_numpy(np.asarray(v, np.float16)).requires_grad_() for k, v in pj.items()}
    h_train, st_train = TLayer(12, 16).apply(p, torch.from_numpy(xs), TT6.replace(grad_quant="fp8_kernel"))
    packed = {"wx": tkd.pack_train(p["wx"]), "wh": tkd.pack_train(p["wh"]), "b": p["b"].detach()}
    with torch.no_grad():
        h_inf, st_inf = TLayer(12, 16).apply(packed, torch.from_numpy(xs), TT6)
    assert torch.equal(h_train.detach(), h_inf)
    assert torch.equal(st_train.h.detach(), st_inf.h) and torch.equal(st_train.c.detach(), st_inf.c)


def test_untrainable_paths_raise():
    """Packed weights serve only: a gradient that reaches a layer's outputs
    computed from them raises (the reference's ``inference_only``). A
    reverse layer refuses lengths, fused or not."""
    p = {k: torch.zeros(s, requires_grad=True) for k, s in [("wx", (4, 32)), ("wh", (8, 32)), ("b", (32,))]}
    xs = torch.zeros((2, 3, 4), requires_grad=True)
    packed = {"wx": tkd.pack_train(p["wx"]), "wh": tkd.pack_train(p["wh"]), "b": p["b"].detach()}
    h, st = TLayer(4, 8).apply(packed, xs, TT6)
    with pytest.raises(TypeError, match="inference-only"):
        (h.sum() + st.c.float().sum()).backward()
    for pol in (TT6, TT6.replace(grad_quant="fp8_kernel")):
        with pytest.raises(ValueError):
            TLayer(4, 8, reverse=True).apply(p, xs, pol, lengths=torch.ones(2))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

V, W, B, S = 128, 16, 8, 16  # the JAX package's trajectory shape


def _jax_run(steps, seed=0, keep_at=None):
    """JAX's fused train step on its reference path from its own init;
    returns (losses, init params, final state, the state after ``keep_at``
    steps)."""
    model = JLM(vocab=V, emb=W, hidden=W, n_layers=2)
    data = jsyn.wikitext2(batch=B, seq=S, vocab=V, seed=seed)
    opt = jsgd(0.9)
    params = model.init(jax.random.PRNGKey(seed))
    state = jts.init_state(params, opt, JT6)
    step = jax.jit(jts.make_train_step(model.loss, opt, JT6, lr=0.5, fused=True))
    losses, kept = [], None
    for i in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in next(data.batches).items()})
        losses.append(float(m["loss"]))
        if i + 1 == keep_at:
            kept = state
    return losses, params, state, kept


def _port_run(params_np, steps, seed=0, state=None):
    model = TLM(vocab=V, emb=W, hidden=W, n_layers=2)
    data = tsyn.wikitext2(batch=B, seq=S, vocab=V, seed=seed)
    opt = tsgd(0.9)
    if state is None:
        state = tts.init_state(bridge.from_jax_params(params_np, "cpu"), opt, TT6)
    step = tts.make_train_step(model.loss, opt, TT6, lr=0.5)
    losses, finite = [], []
    for _ in range(steps):
        state, m = step(state, tts.batch_to_device(next(data.batches), "cpu"))
        losses.append(float(m["loss"]))
        finite.append(bool(m["grads_finite"]))
    return losses, finite, state


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run(20, keep_at=3)


def test_loss_trajectory_matches_jax(jax_run):
    losses_j, params_j, state_j, _ = jax_run
    tkd.STATS.reset()
    losses_t, finite, state_t = _port_run(jax.tree_util.tree_map(np.asarray, params_j), 20)
    assert all(finite)
    rel = np.abs(np.array(losses_t) - losses_j) / np.abs(losses_j)
    assert rel.max() <= 1e-3, rel
    # the loss barely moves in 20 steps at this width, so the masters are
    # held too: every leaf within 0.1% of JAX's change to it (relative L2)
    flat_t = tckpt.flatten(state_t)
    flat_j = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(state_j.params)[0]}
    for key, want in flat_j.items():
        got = flat_t[".params/" + key]
        assert got.dtype == want.dtype == np.float16
        init = np.asarray(jax.tree_util.tree_map(np.asarray, params_j)[key.split("/")[0]]
                          [key.split("/")[1]], np.float16).astype(np.float32)
        moved = np.linalg.norm(want.astype(np.float32) - init)
        assert moved > 0, key
        assert np.linalg.norm(got.astype(np.float32) - want.astype(np.float32)) <= 1e-3 * moved, key
    # per step, per layer: 2S + 2 matmuls, S cells and backwards, S + 1 dx, 2 dw
    want = {"floatsd_matmul": 2 * (2 * S + 2), "lstm_cell": 2 * S, "lstm_cell_grad": 2 * S,
            "floatsd_matmul_dx": 2 * (S + 1), "floatsd_matmul_dw": 4}
    assert tkd.STATS.snapshot() == {(op, "ref"): 20 * n for op, n in want.items()}


def test_model_gradients_match_jax(jax_run):
    """One scaled backward of the whole model (embedding gather, two fused
    layers, tied bf16-dW head) from JAX's init: every fp16 master gradient
    within cosine 0.9999 and 0.1% relative L2 of JAX's (FP8 dW snapping and
    f32 sums in another order flip a few elements by one FP8 step)."""
    _, params_j, _, _ = jax_run
    jm = JLM(vocab=V, emb=W, hidden=W, n_layers=2)
    batch = next(jsyn.wikitext2(batch=B, seq=S, vocab=V, seed=0).batches)
    pol_j = JT6.replace(grad_quant="fp8_kernel")
    master = jax.tree_util.tree_map(lambda a: a.astype(jnp.float16), params_j)
    g_j = jax.jit(jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, pol_j)
                           * 1024.0))(master)
    tm = TLM(vocab=V, emb=W, hidden=W, n_layers=2)
    p = {k: {n: torch.from_numpy(np.array(a)).requires_grad_() for n, a in d.items()}
         for k, d in master.items()}
    (tm.loss(p, tts.batch_to_device(batch, "cpu"), TT6.replace(grad_quant="fp8_kernel")) * 1024.0).backward()
    for k, d in p.items():
        for n, t in d.items():
            a, c = np.asarray(g_j[k][n], np.float32).ravel(), t.grad.float().numpy().ravel()
            assert t.grad.dtype == torch.float16, (k, n)
            assert np.dot(a, c) / (np.linalg.norm(a) * np.linalg.norm(c)) > 0.9999, (k, n)
            assert np.linalg.norm(a - c) <= 1e-3 * np.linalg.norm(a), (k, n)


def test_train_step_skips_nonfinite_and_backs_off():
    model = TLM(vocab=V, emb=W, hidden=W, n_layers=2)
    opt = tsgd(0.9)
    params = model.init(torch.Generator().manual_seed(0))
    state = tts.init_state(params, opt, TT6, dynamic_scale=True)
    state = state._replace(scale=state.scale._replace(scale=torch.tensor(3e38)))  # overflows
    step = tts.make_train_step(model.loss, opt, TT6, lr=0.5)
    batch = tts.batch_to_device(next(tsyn.wikitext2(batch=2, seq=4, vocab=V).batches), "cpu")
    new, m = step(state, batch)
    assert not bool(m["grads_finite"]) and float(m["loss_scale"]) == np.float32(3e38) / 2
    for a, b in zip(tree_leaves((new.params, new.opt_state)), tree_leaves((state.params, state.opt_state))):
        assert torch.equal(a, b)
    assert int(new.step) == 1
    new, m = step(new._replace(scale=tls.dynamic_init()), batch)
    assert bool(m["grads_finite"])
    assert not torch.equal(new.params["lstm0"]["wh"], state.params["lstm0"]["wh"])


def test_port_checkpoint_restores_in_jax(tmp_path, jax_run):
    _, params_j, _, _ = jax_run
    _, _, state_t = _port_run(jax.tree_util.tree_map(np.asarray, params_j), 2)
    path = tckpt.save(str(tmp_path), state_t, 2)
    assert path.endswith("step_00000002")
    target = jts.init_state(params_j, jsgd(0.9), JT6)
    restored, step = checkpointing.restore(str(tmp_path), target)
    assert step == 2
    flat_t = tckpt.flatten(state_t)
    flat_r = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(restored)[0]}
    assert flat_r.keys() == flat_t.keys()
    for k, v in flat_t.items():
        assert flat_r[k].dtype == v.dtype, k
        np.testing.assert_array_equal(flat_r[k], v, err_msg=k)


def test_jax_checkpoint_continues_in_port(tmp_path, jax_run):
    losses_j, _, _, state3 = jax_run
    # JAX's state after 3 steps, saved by JAX; the port continues for 2 more
    checkpointing.save(str(tmp_path), state3, 3)
    model, opt = TLM(vocab=V, emb=W, hidden=W, n_layers=2), tsgd(0.9)
    template = tts.init_state(model.init(torch.Generator().manual_seed(1)), opt, TT6)
    state_t, step = tckpt.restore(str(tmp_path), template)
    assert step == 3
    assert state_t.params["embed"]["table"].dtype == torch.float16
    assert state_t.opt_state["lstm1"]["wx"].dtype == torch.float32
    assert int(state_t.step) == 3 and float(state_t.scale.scale) == 1024.0
    assert not bool(state_t.scale.dynamic)
    data = tsyn.wikitext2(batch=B, seq=S, vocab=V, seed=0)
    for _ in range(3):
        next(data.batches)
    step = tts.make_train_step(model.loss, opt, TT6, lr=0.5)
    for i in range(3, 5):
        state_t, m = step(state_t, tts.batch_to_device(next(data.batches), "cpu"))
        assert abs(float(m["loss"]) - losses_j[i]) <= 1e-3 * abs(losses_j[i])
    assert int(state_t.step) == 5


def test_task_and_cli_on_cpu(tmp_path, capsys, monkeypatch):
    model, data, opt, lr, metric = make_task("wikitext2", full=True)
    assert (model.vocab, model._vp(), model.hidden, model.n_layers, lr) == (33278, 33280, 1024, 2, 0.5)
    assert next(data.batches)["tokens"].shape == (64, 48) and metric == "perplexity"
    with pytest.raises(ValueError):
        make_task("nope")
    # a small task through the CLI: one step, a checkpoint, the closing lines
    monkeypatch.setattr(ttrain, "make_task", lambda name, full: (
        TLM(vocab=V, emb=W, hidden=W, n_layers=2), tsyn.wikitext2(batch=B, seq=S, vocab=V),
        tsgd(0.9), 0.5, "perplexity"))
    out = ttrain.main(["--device", "cpu", "--steps", "2", "--log-every", "1",
                       "--ckpt-dir", str(tmp_path), "--save-every", "1"])
    text = capsys.readouterr().out
    assert "step     2  loss" in text and "trained 2 steps in" in text and "tok/s" in text
    assert len(out["losses"]) == 2 and all(out["finite"]) and out["tokens_per_step"] == B * S
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001", "step_00000002"]
    restored, step = tckpt.restore(str(tmp_path), out["state"])
    assert step == int(restored.step) == 2
