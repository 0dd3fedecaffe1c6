"""The port's core codecs against ``repro.core``, bit for bit.

Same seeded numpy inputs through both packages: FloatSD8 tables,
``exp2i``, ``fit_bias``, ``encode``/``decode``/``quantize``, the FP8/FP16
fake-quant and storage casts (overflow, inf and NaN included), the
two-region sigmoid quantizer, and the policy table. Tolerance: none —
every comparison is exact equality (NaN matching NaN).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse: one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.core import floatsd as jfsd  # noqa: E402
from repro.core import fp8 as jfp8  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import qsigmoid as jqs  # noqa: E402
from repro_torch.core import floatsd as tfsd  # noqa: E402
from repro_torch.core import fp8 as tfp8  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import qsigmoid as tqs  # noqa: E402


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    both_nan = np.isnan(a) & np.isnan(b) if a.dtype.kind == "f" else np.zeros(a.shape, bool)
    bad = ~((a == b) | both_nan)
    assert not bad.any(), f"{bad.sum()} of {a.size} differ, e.g. {a[bad][:5]} vs {b[bad][:5]}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(seed, scale, n=4096):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    x[:4] = [0.0, -0.0, scale, -scale]
    return x


SCALES = [1e-30, 3e-7, 0.02, 1.0, 7.5, 4.5e3, 1e25]


def test_tables_match_reference():
    _same(tfsd.MANTISSA_VALUES, jfsd.MANTISSA_VALUES)
    for name in ("_GRID_POS", "_GRID_MID", "_GRID_E", "_GRID_MIDX"):
        _same(getattr(tfsd, name).astype(np.float64), getattr(jfsd, name).astype(np.float64))
    for name in ("_OCT_VALS", "_OCT_MIDS", "_BOT_VALS", "_BOT_MIDS"):
        _same(getattr(tqs, name), getattr(jqs, name))
    _same(tqs.sigmoid_lut_values(), jqs.sigmoid_lut_values())
    assert tqs.sigmoid_lut_values().size == 43  # the paper's 42 entries + 0


def test_exp2i_bit_identical():
    k = np.arange(-160, 160, dtype=np.int32)
    _same(tfsd.exp2i(_t(k)).numpy(), np.asarray(jfsd.exp2i(jnp.asarray(k))))


@pytest.mark.parametrize("scale", SCALES)
def test_fit_bias_bit_identical(scale):
    for seed in range(8):
        x = _weights(seed, scale)
        assert int(tfsd.fit_bias(_t(x))) == int(jfsd.fit_bias(jnp.asarray(x)))


def test_fit_bias_degenerate_inputs_match():
    for x in (np.zeros(8, np.float32), np.array([np.inf, 1.0], np.float32),
              np.array([np.nan, 2.0], np.float32)):
        assert int(tfsd.fit_bias(_t(x))) == int(jfsd.fit_bias(jnp.asarray(x)))


def test_fit_bias_exact_at_powers_of_two():
    """max|x| = 4.5 * 2^k: the bias is exactly k - 7 (the reference's float
    log2 is an ulp off at some powers of two, so only the port is held to
    the exact value here)."""
    for k in range(-100, 100):
        x = torch.tensor([4.5 * 2.0**k], dtype=torch.float32)
        assert int(tfsd.fit_bias(x)) == max(-126, min(120, k - 7)), k


@pytest.mark.parametrize("scale", SCALES)
def test_encode_decode_quantize_bit_identical(scale):
    x = _weights(int(scale * 1000) % 97, scale)
    # exact grid points and grid midpoints (round-half ties) at the fitted bias
    bias = int(jfsd.fit_bias(jnp.asarray(x)))
    s = np.float32(2.0 ** max(-126, min(120, bias)))
    x[4:4 + jfsd._GRID_MID.size] = (jfsd._GRID_MID * s).astype(np.float32)
    x[100:100 + jfsd._GRID_POS.size] = -(jfsd._GRID_POS * s).astype(np.float32)
    codes_t, bias_t = tfsd.encode(_t(x))
    codes_j, bias_j = jfsd.encode(jnp.asarray(x))
    _same(codes_t.numpy(), np.asarray(codes_j))
    assert int(bias_t) == int(bias_j)
    _same(tfsd.decode(codes_t, bias_t).numpy(), np.asarray(jfsd.decode(codes_j, bias_j)))
    q_t, _ = tfsd.quantize(_t(x))
    _same(q_t.numpy(), np.asarray(jfsd.quantize(jnp.asarray(x)).values))
    # the serving invariant: decode(encode(w)) == quantize(w)
    _same(tfsd.decode(codes_t, bias_t).numpy(), q_t.numpy())


@pytest.mark.parametrize("bias", [-300, -126, -20, 0, 13, 120, 400])
def test_decode_every_code_bit_identical(bias):
    """Every code at every bias. At the lowest bias a mantissa below 1 at
    e = 0 decodes to an f32 subnormal: the port (like the card) keeps it,
    while the reference on the CPU flushes it to a signed zero. Those
    codes are checked for exactly that, the rest for equality."""
    codes = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = tfsd.decode(_t(codes), bias).numpy()
    want = np.asarray(jfsd.decode(jnp.asarray(codes), bias))
    sub = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    assert np.all(want[sub] == 0) and np.all(np.signbit(want[sub]) == np.signbit(got[sub]))
    assert sub.sum() == (8 if bias <= -126 else 0)
    _same(np.where(sub, want, got), want)


def _fp8_inputs():
    rng = np.random.default_rng(3)
    y = (rng.standard_normal(200_000) * np.exp(rng.uniform(-20, 14, 200_000))).astype(np.float32)
    y[:8] = [np.inf, -np.inf, np.nan, 70000.0, -1e6, 448.5, 57344.0, 65520.0]
    return y


@pytest.mark.parametrize("name", ["FP8_E5M2", "FP8_E4M3", "FP16"])
def test_fp8_quantize_and_cast_bit_identical(name):
    y = _fp8_inputs()
    tdt, jdt = getattr(tfp8, name), getattr(jfp8, name)
    _same(tfp8.quantize_fp8(_t(y), tdt).numpy(), np.asarray(jfp8.quantize_fp8(jnp.asarray(y), jdt)))
    got = tfp8.cast_fp8(_t(y), tdt).to(torch.float32).numpy()
    want = np.asarray(jfp8.cast_fp8(jnp.asarray(y), jdt).astype(jnp.float32))
    _same(got, want)
    # saturation on finite overflow, nonfinite preserved
    q = tfp8.quantize_fp8(_t(y[:5]), tdt).numpy()
    assert np.all(np.isfinite(q[3:])) and not np.any(np.isfinite(q[:3]))


def test_quantize_fp8_none_passes_through():
    x = torch.randn(5)
    assert tfp8.quantize_fp8(x, None) is x


def test_qsigmoid_raw_bit_identical():
    rng = np.random.default_rng(4)
    x = np.concatenate([
        np.linspace(-20, 20, 400_001, dtype=np.float32),
        (rng.standard_normal(200_000) * 3).astype(np.float32),
        np.array([0.0, -0.0, 1e-30, -1e-30, 88.0, -88.0, 200.0, -200.0], np.float32),
    ])
    _same(tqs.qsigmoid_raw(_t(x)).numpy(), np.asarray(jqs.qsigmoid_raw(jnp.asarray(x))))


def test_q_bit_identical_on_grid_points_and_midpoints():
    """The quantizer alone, on sigma values that sit exactly on LUT entries,
    on their midpoints (ties), and a dense sweep of (0, 0.5]."""
    g = jqs.sigmoid_lut_values().astype(np.float32)
    mids = ((g[1:] + g[:-1]) / 2).astype(np.float32)
    v = np.concatenate([g, mids, np.linspace(0, 0.5, 200_001, dtype=np.float32)])
    _same(tqs._Q(_t(v)).numpy(), np.asarray(jqs._Q(jnp.asarray(v))))


@pytest.mark.parametrize("name", sorted(jpolicy._REGISTRY))
def test_policy_table_matches(name):
    tp, jp = tpolicy.get_policy(name), jpolicy.get_policy(name)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for site in ("first", "hidden", "last"):
        names = [None if d is None else jnp.dtype(d).name for d in jp.act_dtypes(site)]
        got = [None if d is None else str(d).replace("torch.", "") for d in tp.act_dtypes(site)]
        assert got == names, (site, got, names)
    assert tp.cell_dtype() == (torch.float16 if jp.master_dtype == "fp16" else torch.float32)
